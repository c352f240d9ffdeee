"""The port's training data path against the JAX package's: targets, frame
targets, random crops, batches and the whole load-split-slice pipeline are
identical for the same seed; collated features are within the frontend's
tolerance (2e-5, tests/test_torch_frontend.py); WAV files round-trip."""

import ctypes.util
import json
import os

import numpy as np
import pytest
import torch

from test_training import make_tone_dataset
from whisperseg_tpu import codec as jcodec
from whisperseg_tpu import data as jdata
from whisperseg_tpu.audio import io as jio
from whisperseg_torch import codec, data
from whisperseg_torch.audio import io
from whisperseg_torch.synthetic import (audio_bytes, crafted_mp3, tone_bursts,
                                        write_tone_dataset)


def _segments(seed, n=6, dur=2.5):
    rng = np.random.RandomState(seed)
    on = np.sort(rng.uniform(0, dur - 0.2, n))
    off = on + rng.uniform(0.01, 0.3, n)
    return on, off, rng.randint(0, 13, n)


@pytest.mark.parametrize("seed", range(4))
def test_targets_match_jax(seed):
    on, off, cid = _segments(seed)
    for max_length in (8, 40):
        want = jcodec.build_target_ids("unknown", on, off, cid, 0.0025, 1000)
        got = codec.build_target_ids("unknown", on, off, cid, 0.0025, 1000)
        assert got == want
        assert codec.shift_for_training(got, max_length) == \
            jcodec.shift_for_training(want, max_length)
    extra = {"12": 1024, "3": 1025}
    assert codec.build_target_ids("zebra_finch", on, off, cid, 0.005, 500,
                                  extra_token_ids=extra) == \
        jcodec.build_target_ids("zebra_finch", on, off, cid, 0.005, 500,
                                extra_token_ids=extra)
    assert codec.time_to_col(0.0125, 0.0025, 1000) == jcodec.time_to_col(
        0.0125, 0.0025, 1000)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
def test_frame_targets_match_jax(sigma):
    on, off, cid = _segments(7)
    on[0], off[-1] = 0.0, 2.6  # events on both edges of the grid
    got = data.build_frame_targets(on, off, cid, 0.0025, 1000, sigma)
    want = jdata.build_frame_targets(on, off, cid, 0.0025, 1000, sigma)
    for k in data.FRAME_KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tone dataset through both packages' load, split and slice steps
    (each from the same global seed)."""
    folder = make_tone_dataset(str(tmp_path_factory.mktemp("d") / "data"),
                               n_files=4)
    out = {}
    for name, mod in (("port", data), ("jax", jdata)):
        np.random.seed(3)
        paths = mod.get_audio_and_label_paths(folder)
        config = mod.resolve_default_config(*paths, 200)
        codebook = mod.get_cluster_codebook(paths[1], {})
        audio, labels = mod.load_data(*paths, codebook, default_config=config)
        (audio, labels), val = mod.train_val_split(audio, labels, 0.2)
        audio, labels = mod.slice_audios_and_labels(audio, labels, 200)
        out[name] = dict(paths=paths, config=config, codebook=codebook,
                         audio=audio, labels=labels, val=val)
    return out


def test_load_split_and_slice_match_jax(corpus):
    port, jax_ = corpus["port"], corpus["jax"]
    assert port["paths"] == jax_["paths"] and port["config"] == jax_["config"]
    assert port["codebook"] == jax_["codebook"]
    assert len(port["audio"]) == len(jax_["audio"]) >= 8
    for a, b in zip(port["audio"], jax_["audio"]):
        assert np.array_equal(a, b)
    for la, lb in zip(port["labels"] + port["val"][1],
                      jax_["labels"] + jax_["val"][1]):
        assert la.keys() == lb.keys()
        for k in la:
            assert np.array_equal(np.asarray(la[k]), np.asarray(lb[k])), k


def _datasets(corpus, frame_targets=True):
    port = data.VocalSegDataset(corpus["port"]["audio"], corpus["port"]["labels"],
                                24, 200, frame_targets=frame_targets, device="cpu")
    jax_ = jdata.VocalSegDataset(corpus["jax"]["audio"], corpus["jax"]["labels"],
                                 24, 200, frame_targets=frame_targets)
    return port, jax_


def test_items_match_jax_for_the_same_seed(corpus):
    port, jax_ = _datasets(corpus)
    for i in range(len(port)):
        got = port.__getitem__(i, rng=np.random.RandomState(i))
        want = jax_.__getitem__(i, rng=np.random.RandomState(i))
        assert got["frontend_key"] == want["frontend_key"]
        for k in ("audio_clip", "decoder_input_ids", "labels"):
            assert np.array_equal(got[k], want[k]), k
        for k in data.FRAME_KEYS:
            assert np.array_equal(got["frame_targets"][k], want["frame_targets"][k])


def test_loader_batches_and_collated_features_match_jax(corpus):
    port, jax_ = _datasets(corpus)
    batches = {}
    for name, mod, ds in (("port", data, port), ("jax", jdata, jax_)):
        np.random.seed(11)
        loader = mod.DataLoader(ds, 2, num_workers=3)
        batches[name] = list(loader)
    assert len(batches["port"]) == len(batches["jax"]) >= 4
    for got, want in zip(batches["port"], batches["jax"]):
        assert isinstance(got["input_features"], torch.Tensor)
        # 16 kHz, hop 160: one element in 32000 lies 2.6e-5 from JAX's (two
        # libraries' float32 FFTs), so 1e-4 relative is allowed beside 2e-5
        np.testing.assert_allclose(got["input_features"].numpy(),
                                   np.asarray(want["input_features"]),
                                   atol=2e-5, rtol=1e-4)
        for k in ("decoder_input_ids", "labels"):
            assert np.array_equal(got[k], want[k]), k
        for k in data.FRAME_KEYS:
            assert np.array_equal(got["frame_targets"][k], want["frame_targets"][k])


def test_wav_round_trip_and_the_jax_reader(tmp_path):
    y = tone_bursts(3, sr=16000, duration=1.0)
    path = str(tmp_path / "a.wav")
    io.save_wav(path, y, 16000)
    got, sr = io.read_wav(path)
    want, jsr = jio.read_wav(path)
    assert sr == jsr == 16000 and np.array_equal(got, want)
    assert np.abs(got[:, 0] - y).max() <= 2 / 32767  # 16-bit steps
    assert io.get_sampling_rate(path) == 16000
    assert io.get_audio_duration(path) == jio.get_audio_duration(path) == 1.0
    stereo = np.stack([y, -y], axis=1)
    io.save_wav(path, stereo, 8000)
    for kwargs in ({}, {"sr": 16000}, {"mono": False}, {"channel_id": 1}):
        got, sr = io.load_audio(path, **kwargs)
        want, jsr = jio.load_audio(path, **kwargs)
        assert sr == jsr
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_float_wav_and_compressed_formats(tmp_path):
    y = np.linspace(-0.5, 0.5, 800, dtype=np.float32)
    body = y.tobytes()
    fmt = (3).to_bytes(2, "little") + (1).to_bytes(2, "little") + \
        (8000).to_bytes(4, "little") + (32000).to_bytes(4, "little") + \
        (4).to_bytes(2, "little") + (32).to_bytes(2, "little")
    riff = b"WAVE" + b"fmt " + len(fmt).to_bytes(4, "little") + fmt + \
        b"data" + len(body).to_bytes(4, "little") + body
    raw = b"RIFF" + len(riff).to_bytes(4, "little") + riff
    got, sr = io.read_wav(raw)
    assert sr == 8000 and np.array_equal(got[:, 0], y)
    path = tmp_path / "b.wav"
    path.write_bytes(raw)
    assert io.get_audio_duration(str(path)) == 0.1
    # compressed containers load as in the JAX package, bit for bit, and a
    # header that is not a stream is refused by both
    y = tone_bursts(5, sr=16000, duration=1.0)
    streams = {"flac": audio_bytes(y, 16000, "flac"),
               "mp3": crafted_mp3(6, duration=1.0, sr=32000)}
    if all(ctypes.util.find_library(n) for n in ("vorbis", "vorbisenc", "ogg")):
        from test_vorbis import encode_ogg

        streams["ogg"] = encode_ogg(y[:, None], 16000)
    for fmt, blob in streams.items():
        path = tmp_path / f"c.{fmt}"
        path.write_bytes(blob)
        for kwargs in ({}, {"sr": 8000}):
            got, sr = io.load_audio(blob, **kwargs)
            want, jsr = jio.load_audio(blob, **kwargs)
            assert sr == jsr and got.size > 0
            np.testing.assert_array_equal(got, want)
        assert io.get_sampling_rate(str(path)) == jio.get_sampling_rate(str(path))
        assert io.get_audio_duration(str(path)) == \
            jio.get_audio_duration(str(path))
    for magic in (b"fLaC" + b"\0" * 12, b"OggS" + b"\0" * 12, b"ID3" + b"\0" * 13):
        with pytest.raises(Exception) as e:
            io.load_audio(magic)
        with pytest.raises(e.type):
            jio.load_audio(magic)


def test_csv_labels_read_like_pandas(tmp_path):
    path = tmp_path / "a.csv"
    path.write_text("onset,offset,cluster\n0.5,0.75,3\n1.25,1.5,12\n")
    got = data.read_label(str(path))
    want = jdata.read_label(str(path))
    assert got == want and got["cluster"] == ["3", "12"]


def test_synthetic_tone_dataset_trains_both_packages_alike(tmp_path):
    folder = write_tone_dataset(str(tmp_path / "tones"), 2, seed=4,
                                duration=3.0)
    paths = data.get_audio_and_label_paths(folder)
    assert paths == jdata.get_audio_and_label_paths(folder) and len(paths[0]) == 2
    with open(os.path.join(folder, "tones_0.json")) as f:
        label = json.load(f)
    y, onsets, offsets = tone_bursts(4, duration=3.0, with_segments=True)
    assert np.array_equal(y, tone_bursts(4, duration=3.0))
    assert label["onset"] == [round(t, 4) for t in onsets]
    assert data.resolve_default_config(*paths, 1000) == \
        jdata.resolve_default_config(*paths, 1000)
    got, sr = data.load_audio(os.path.join(folder, "tones_0.wav"))
    assert sr == 32000 and np.abs(got - y).max() <= 2 / 32767
