"""The frame-VAD mode of the port (``Segmenter.frame_probs``,
``segment_from_frames``, ``refine.segments_from_tracks`` and
``evaluate(frame_mode=True)``) against the JAX package's, on the shipped
tiny checkpoint at float32: frame tracks within 1e-4, identical tables and
identical scores."""

import warnings

import numpy as np
import pytest
import torch

import whisperseg_tpu.evaluate as jevaluate
from whisperseg_tpu import refine as jrefine
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter
from whisperseg_torch import evaluate, refine
from whisperseg_torch.checkpoint import load_checkpoint
from whisperseg_torch.ops import attention, logmel
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts, write_tone_dataset

TINY = "pretrained/whisperseg-tiny-animal-vad"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs: the test suite
    runs several processes at once, and torch's thread pool in each of them
    would otherwise contend for the same cores (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def segmenters():
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    return (JaxSegmenter(jparams, jcfg, inference_dtype="float32"),
            Segmenter(params, cfg, inference_dtype="float32", device="cpu"))


@pytest.mark.parametrize("duration,batch_size", [(6.3, 2), (2.5, 8)])
def test_frame_probs_within_1e4_of_jax(segmenters, duration, batch_size):
    jseg, seg = segmenters
    audio = tone_bursts(21, duration=duration)
    want = jseg.frame_probs(audio, 32000, batch_size=batch_size)
    got = seg.frame_probs(audio, 32000, batch_size=batch_size)
    assert got["quantum"] == want["quantum"]
    assert len(got["vocal"]) == int(np.ceil(duration / want["quantum"]))
    for key in ("vocal", "onset", "offset"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_array_equal(got["cluster"], want["cluster"])
    assert want["vocal"].max() > 0.9 and want["vocal"].min() < 0.1


def _random_tracks(seed, n=600, clusters=3):
    """Smooth random tracks on a 10 ms grid: runs of vocal activity with
    event peaks at their edges and inside them."""
    rng = np.random.RandomState(seed)
    smooth = lambda x: np.convolve(x, np.ones(9) / 9, mode="same")  # noqa: E731
    vocal = 1 / (1 + np.exp(-6 * smooth(rng.randn(n)) * 3))
    onset = np.clip(smooth(rng.rand(n) ** 8) * 6, 0, 1)
    offset = np.clip(smooth(rng.rand(n) ** 8) * 6, 0, 1)
    cluster = rng.randint(-1, clusters, n).astype(np.int32)
    return {"vocal": vocal.astype(np.float32), "onset": onset.astype(np.float32),
            "offset": offset.astype(np.float32), "cluster": cluster,
            "quantum": 0.01}


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(vocal_threshold=0.4, cut_threshold=0.3, boundary_snap=4)),
    (2, dict(cut_threshold=0.2, gap_cut=5, min_segment_length=0.03)),
    (3, dict(vocal_threshold=0.6, boundary_snap=0, precision_bits=2)),
])
def test_segments_from_tracks_identical_to_jax(seed, kw):
    tracks = _random_tracks(seed)
    inverse = {0: "a", 1: "b"}  # cluster 2 has no name: "Vocal"
    want = jrefine.segments_from_tracks(tracks, 5.9, 0.004, inverse, **kw)
    got = refine.segments_from_tracks(tracks, 5.9, 0.004, inverse, **kw)
    assert len(want["onset"]) >= 10, want
    assert got == want


@pytest.mark.parametrize("kw", [{}, dict(vocal_threshold=0.3, gap_cut=3,
                                         boundary_snap=4)])
def test_segment_from_frames_identical_to_jax(segmenters, kw):
    jseg, seg = segmenters
    audio = tone_bursts(22, duration=7.0)
    want = jseg.segment_from_frames(audio, 32000, batch_size=2, **kw)
    logmel.launches = attention.launches = 0
    got = seg.segment_from_frames(audio, 32000, batch_size=2, **kw)
    assert len(want["onset"]) >= 10, want
    assert got == want
    assert logmel.launches == attention.launches == 0  # CPU: plain versions


def test_frame_mode_needs_a_frame_head(segmenters):
    seg = segmenters[1]
    bare = Segmenter({k: v for k, v in seg.params.items() if k != "frame_head"},
                     seg.config, inference_dtype=None, device="cpu")
    with pytest.raises(ValueError, match="frame head"):
        bare.segment_from_frames(np.zeros(8000, np.float32), 32000)


@pytest.fixture(scope="module")
def tone_dataset(tmp_path_factory):
    return write_tone_dataset(str(tmp_path_factory.mktemp("tones")), 2, seed=30,
                              duration=4.0)


def test_evaluate_frame_mode_identical_to_jax(segmenters, tone_dataset):
    jseg, seg = segmenters
    kw = dict(num_trials=1, max_length=None, num_beams=1, batch_size=4,
              frame_mode=True, frame_vocal_threshold=0.5, frame_gap_cut=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jevaluate.evaluate_dataset(tone_dataset, TINY, segmenter=jseg,
                                          **kw)
    got = evaluate.evaluate_dataset(tone_dataset, TINY, segmenter=seg,
                                    verbose=False, **kw)
    assert got == want
    assert want["segment_wise_scores"]["N-positive-in-prediction"] >= 10
    assert want["frame_wise_scores"]["F1"] > 0.5
