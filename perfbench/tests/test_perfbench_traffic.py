"""The traffic is a function of the seed: the same seed gives the same
samples, another seed other content with the same sizes."""

import numpy as np

from perfbench import traffic

BIG = 2 ** 33 + 12345


def test_recordings_repeat_for_a_seed():
    a = traffic.recording(BIG, 0, 32000, 2.5)
    b = traffic.recording(BIG, 0, 32000, 2.5)
    c = traffic.recording(BIG + 1, 0, 32000, 2.5)
    assert a.dtype == np.int16 and np.array_equal(a, b)
    assert not np.array_equal(a, c) and len(a) == len(c) == 80000


def test_labelled_files_repeat(tmp_path):
    mix = {"files": 2, "file_s": 3.0, "sr": 32000, "spec_time_step": 0.0025,
           "min_frequency": 0}
    a = traffic.write_labelled_files(str(tmp_path / "a"), mix, BIG)
    b = traffic.write_labelled_files(str(tmp_path / "b"), mix, BIG)
    for x, y in zip(a, b):
        for ext in (".wav", ".json"):
            assert open(x + ext, "rb").read() == open(y + ext, "rb").read()
