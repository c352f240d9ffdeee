"""The beam step's CUDA graph. On the CPU, its bookkeeping with the capture
replaced by running its body: the search through the static buffers gives
the eager loop's tokens and reuses one graph a shape, beam widths of equal
rows keep a graph each, each device keeps the graphs that fit its share
of memory (a graph's bytes are those its buffers hold), and the buffers
hold the cross K/V at a row a window. On the card (marked ``card``: each
skips without one), on the tiny checkpoint's widths: graphed and eager
beam search give the same tokens, on the caller's thread and on a worker
thread (as the mesh path decodes), and for two beam widths of equal rows;
two calls of one shape capture once and the second replays; each
``decode.step`` span of a replayed search says ``graphed=1`` and holds one
host launch call. This file
imports no JAX, so that it runs on the chip without the suite's conftest:
``python3 -m pytest --noconftest tests/test_torch_beam_graph.py -q``."""

import dataclasses
import os
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from whisperseg_torch import decode, profiling
from whisperseg_torch.audio.frontend import Frontend
from whisperseg_torch.checkpoint import cast_params, load_checkpoint
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.synthetic import tone_bursts

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pretrained", "whisperseg-tiny-animal-vad")


@pytest.fixture(scope="module")
def tiny():
    """The tiny checkpoint at float32 compute and the features of three
    2.5 s windows, on the CPU."""
    params, cfg = load_checkpoint(TINY)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    clips = tone_bursts(3, duration=7.5).reshape(3, -1)
    feats = Frontend(32000, 0.0025).features_for_clips(clips, 1000,
                                                      device="cpu")
    return params, cfg, feats


def _as(tiny, dtype):
    """The tiny checkpoint run at ``dtype`` (weights cast too)."""
    params, cfg = tiny[0], tiny[1]
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    if dtype == "bfloat16":
        params = cast_params(params, torch.bfloat16)
    return params, cfg


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model(card):
    """The float32 tiny checkpoint and the encoder output of four 2.5 s
    windows, computed on the CPU."""
    params, cfg = load_checkpoint(TINY)
    clips = tone_bursts(5, duration=10.0).reshape(4, -1)
    feats = Frontend(32000, 0.0025).features_for_clips(clips, 1000,
                                                      device="cpu")
    enc = tw.encoder_forward(
        params, dataclasses.replace(cfg, compute_dtype="float32"), feats)
    return params, cfg, enc


@pytest.fixture
def fresh(monkeypatch):
    """An empty graph cache for the test."""
    monkeypatch.setattr(decode, "_GRAPHS", OrderedDict())


def on_card(model, card, dtype):
    params, cfg, enc = model
    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (cast_params(params, torch_dtype, card),
            dataclasses.replace(cfg, compute_dtype=dtype), enc.to(card))


def _eager(params, cfg, kw, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(decode, "graph_engages", lambda *args: False)
        return decode.generate(params, cfg, **kw)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_and_eager_beam_search_give_the_same_tokens(
        model, card, dtype, fresh, monkeypatch):
    params, cfg, enc = on_card(model, card, dtype)
    assert decode.graph_engages(params, cfg, card, False)
    kw = dict(max_length=100, num_beams=4, enc_out=enc)
    graphed = [decode.generate(params, cfg, **kw) for _ in range(2)]
    eager = _eager(params, cfg, kw, monkeypatch)
    assert all((row >= 23).sum() >= 2 for row in eager.cpu())
    for got in graphed:
        assert torch.equal(got, eager)


@pytest.mark.card
def test_equal_rows_of_other_beam_widths_replay_graphs_of_their_own(
        model, card, fresh, monkeypatch):
    params, cfg, enc = on_card(model, card, "bfloat16")
    runs = [dict(max_length=60, num_beams=4, enc_out=enc),
            dict(max_length=60, num_beams=2, enc_out=torch.cat([enc, enc]))]
    want = [_eager(params, cfg, kw, monkeypatch) for kw in runs]
    for i in (0, 1, 0, 1):
        assert torch.equal(decode.generate(params, cfg, **runs[i]), want[i])
    assert len(decode._GRAPHS) == 2


@pytest.mark.card
def test_a_worker_thread_captures_and_replays_its_own(model, card, fresh,
                                                      monkeypatch):
    params, cfg, enc = on_card(model, card, "bfloat16")
    kw = dict(max_length=60, num_beams=2, enc_out=enc)
    with ThreadPoolExecutor(1) as pool:
        got = [pool.submit(decode.generate, params, cfg, **kw).result(
            timeout=300) for _ in range(2)]
    eager = _eager(params, cfg, kw, monkeypatch)
    assert torch.equal(got[0], eager) and torch.equal(got[1], eager)


@pytest.mark.card
def test_one_capture_a_shape_and_graphed_spans(model, card, fresh,
                                               monkeypatch):
    params, cfg, enc = on_card(model, card, "bfloat16")
    captures = []
    inner = decode._capture

    def counted(body, device):
        captures.append(device)
        return inner(body, device)
    monkeypatch.setattr(decode, "_capture", counted)
    kw = dict(max_length=60, num_beams=4, enc_out=enc)
    decode.generate(params, cfg, **kw)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.time_ns()
    decode.generate(params, cfg, **kw)
    torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.stop()
    assert len(captures) == 1 and len(decode._GRAPHS) == 1
    steps = [r for r in profiling.recorded(t0, t1) if r.name == "decode.step"]
    assert steps and all(r.counts == {"graphed": 1} for r in steps)
    launches = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if "LaunchKernel" in e.name() or "GraphLaunch" in e.name()]
    inside = sum(any(r.start_ns <= t < r.end_ns for r in steps)
                 for t in launches)
    assert inside <= 5 * len(steps), (inside, len(steps))


# ------------------------------------------------------------ on the CPU


@pytest.fixture
def one_thread():
    """The CPU tests' searches on one intra-op thread: in a parallel test
    run the pool's threads of each process only wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_graphs(records):
    return [r.counts["graphed"] for r in records if r.name == "decode.step"]


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, its decode.step spans'
    ``graphed`` counts)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns()
    try:
        out = fn()
    finally:
        t1 = time.time_ns()
        prof.stop()
    return out, _step_graphs(profiling.recorded(t0, t1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_search_through_the_static_buffers_gives_the_eager_tokens(
        tiny, monkeypatch, one_thread, dtype):
    """The graph path's bookkeeping with the capture replaced by running its
    body: the seed state copied into static buffers, every step written back
    into them in place (what a replay does), the capture's warm-up as the
    first step, and one graph reused by a second call of the shape. The
    tokens are the eager loop's, which at float32 are JAX's
    (test_torch_decode.py::test_token_ids_identical_to_jax)."""
    params, cfg = _as(tiny, dtype)
    enc = tw.encoder_forward(params, cfg, tiny[2])
    kw = dict(max_length=40, num_beams=4, enc_out=enc)
    want, eager = _profiled(lambda: decode.generate(params, cfg, **kw))
    assert all((row >= 23).sum() >= 2 for row in want)
    assert eager and set(eager) == {0}

    captures = []

    def capture(body, device):
        captures.append(device)
        body()
        return body
    _graphs_on_the_cpu(monkeypatch, capture)
    first, graphed1 = _profiled(lambda: decode.generate(params, cfg, **kw))
    second, graphed2 = _profiled(lambda: decode.generate(params, cfg, **kw))
    assert torch.equal(first, want) and torch.equal(second, want)
    assert len(captures) == 1 and len(decode._GRAPHS) == 1
    # the same steps; the first call's first step ran the capture
    assert graphed1 == [0] + [1] * (len(eager) - 1)
    assert graphed2 == [1] * len(eager)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,k", [(3, 4), (2, 1)])
def test_static_buffers_hold_the_cross_kv_at_a_row_a_window(
        tiny, dtype, batch, k):
    """The graph's buffers hold the cross K/V head-major at one row a window
    and the self-attention cache at a row a beam; the graph counts exactly
    the bytes they hold, as does the same graph on the ``meta`` device
    (the measure the cache's budget takes before it allocates)."""
    cfg = dataclasses.replace(tiny[1], compute_dtype=dtype)
    graph = decode._BeamGraph(cfg, torch.device("cpu"), batch, k, 40, 50)
    (xk, xv), cache = graph.buffers
    assert xk.shape == xv.shape == (cfg.decoder_layers, batch, cfg.kv_heads,
                                    50, cfg.head_dim)
    assert cache["ck"].shape == cache["cv"].shape == (
        cfg.decoder_layers, batch * k, 40, cfg.kv_heads, cfg.head_dim)
    held = sum(t.nbytes for t in (xk, xv, *cache.values()))
    assert graph.nbytes == held
    assert decode._BeamGraph(cfg, torch.device("meta"), batch, k, 40,
                             50).nbytes == held


def _graphs_on_the_cpu(monkeypatch, capture, memory=1 << 40):
    """The graph path on the CPU: every search asks for a graph, whose
    capture is ``capture``, in an empty cache, on devices of ``memory``
    bytes."""
    monkeypatch.setattr(decode, "graph_engages", lambda *args: True)
    monkeypatch.setattr(decode, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(decode, "_capture", capture)
    monkeypatch.setattr(decode, "_device_memory", lambda device: memory)


def _run_body(body, device):
    body()
    return body


def test_equal_rows_of_other_beam_widths_take_graphs_of_their_own(
        tiny, monkeypatch, one_thread):
    """One window at four beams and two at two are four rows each: the two
    searches keep a graph each, and each gives its eager tokens, in either
    order and again."""
    params, cfg = tiny[0], tiny[1]
    enc = tw.encoder_forward(params, cfg, tiny[2][:2])
    runs = {4: dict(enc_out=enc[:1], num_beams=4),
            2: dict(enc_out=enc, num_beams=2)}
    want = {k: decode.generate(params, cfg, max_length=30, **kw)
            for k, kw in runs.items()}
    _graphs_on_the_cpu(monkeypatch, _run_body)
    for k in (4, 2, 4, 2):
        got = decode.generate(params, cfg, max_length=30, **runs[k])
        assert torch.equal(got, want[k])
    assert sorted(key[-4] for key in decode._GRAPHS) == [2, 4]


def test_each_device_keeps_the_graphs_that_fit_its_share(tiny, monkeypatch):
    """A device keeps its most recently used graphs while their cross K/V
    and caches fit in a quarter of its memory, dropping the least recently
    used first; another device's graphs are not counted against it; a shape
    that alone does not fit gets no graph."""
    params, cfg = tiny[0], tiny[1]
    # a batch of 1 at 4 beams, as its graph holds it
    size = decode._BeamGraph(cfg, torch.device("meta"), 1, 4, 10, 50).nbytes
    _graphs_on_the_cpu(monkeypatch, _run_body, memory=4 * 3 * size)

    def graph(device, batch, max_length=10):
        return decode._beam_graph(params, cfg, torch.device(device), batch, 4,
                                  max_length, 50, 1.0)

    def held(device):
        return [(key[-5], key[-3]) for key in decode._GRAPHS
                if key[0] == torch.device(device)]
    a, b = graph("cpu", 1), graph("cpu", 2)            # 1 + 2 of 3 shares
    assert held("cpu") == [(1, 10), (2, 10)] and graph("cpu", 1) is a
    c = graph("meta", 3)                               # fits the other device
    assert held("cpu") == [(2, 10), (1, 10)] and held("meta") == [(3, 10)]
    graph("cpu", 1, max_length=9)                      # drops the batch of 2
    assert held("cpu") == [(1, 10), (1, 9)] and graph("meta", 3) is c
    assert graph("cpu", 2) is not b                    # made anew
    assert held("cpu") == [(1, 9), (2, 10)]
    assert graph("cpu", 4) is None and held("cpu") == [(1, 9), (2, 10)]
