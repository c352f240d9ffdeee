"""The span recorder (``whisperseg_torch/profiling.py``): nothing recorded
and no profiler range entered while no profiler runs; under a profiler,
nested spans with their parent and request ids (across threads too), a
bounded buffer, the profiler's own clock; and the trees that
``segment()``, ``segment_from_frames()``, the mesh path and the training
step record, with the tables unchanged."""

import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from whisperseg_torch import decode, profiling
from whisperseg_torch.checkpoint import load_checkpoint
from whisperseg_torch.parallel import make_mesh
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
SR = 32000


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Profiled:
    """A CPU ``torch.profiler`` over the block; ``records`` are the spans
    recorded inside it, ``events`` the profiler's own."""

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self.prof.stop()
        self.records = profiling.recorded(self.t0, self.t1)
        return False

    def events(self):
        return list(self.prof.profiler.kineto_results.events())


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_nothing_recorded_and_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    t0 = time.time_ns()
    outer = profiling.span("a", windows=3)
    with outer as a:
        with profiling.span("b") as b:
            b.drop()
    assert a is b is outer      # one shared context, nothing made
    assert profiling.current() is None
    assert profiling.recorded(t0, time.time_ns()) == []


def test_spans_nest_and_carry_parent_and_request_ids():
    with Profiled() as p:
        with profiling.span("root", windows=2):
            with profiling.span("child"):
                with profiling.span("grandchild"):
                    pass
            with profiling.span("dropped") as d:
                d.drop()
        with profiling.span("second root"):
            pass
    got = by_name(p.records)
    assert set(got) == {"root", "child", "grandchild", "second root"}
    root, child = got["root"][0], got["child"][0]
    grandchild, second = got["grandchild"][0], got["second root"][0]
    assert root.parent_id is None and root.request_id == root.span_id
    assert root.counts == {"windows": 2} and child.counts == {}
    assert child.parent_id == root.span_id and child.request_id == root.span_id
    assert grandchild.parent_id == child.span_id
    assert grandchild.request_id == root.span_id
    assert second.parent_id is None and second.request_id != root.request_id
    assert root.start_ns <= child.start_ns <= grandchild.start_ns
    assert grandchild.end_ns <= child.end_ns <= root.end_ns
    assert {r.thread_id for r in p.records} == {threading.get_ident()}


def test_spans_on_two_threads_and_a_request_carried_across():
    barrier = threading.Barrier(2, timeout=30)
    seen = {}

    def worker(name, parent):
        with profiling.inherit(parent):
            barrier.wait()
            with profiling.span(name):
                barrier.wait()
        seen[name] = threading.get_ident()

    with Profiled() as p:
        with profiling.span("caller"):
            parent = profiling.current()
            carried = threading.Thread(target=worker, args=("carried", parent))
            alone = threading.Thread(target=worker, args=("alone", None))
            carried.start()
            alone.start()
            carried.join(30)
            alone.join(30)
    assert not carried.is_alive() and not alone.is_alive()
    got = {r.name: r for r in p.records}
    caller = got["caller"]
    assert parent == (caller.span_id, caller.request_id)
    assert got["carried"].parent_id == caller.span_id
    assert got["carried"].request_id == caller.request_id
    assert got["carried"].thread_id == seen["carried"] != caller.thread_id
    assert got["alone"].parent_id is None
    assert got["alone"].request_id not in (caller.request_id, None)


def test_the_buffer_stays_within_its_bound():
    with Profiled() as p:
        for i in range(profiling.LIMIT + 50):
            with profiling.span("filler", i=i):
                pass
    kept = profiling.recorded(0, 2 ** 63)
    assert len(kept) == profiling.LIMIT
    # the oldest went first
    assert [r.counts["i"] for r in p.records] == list(
        range(50, profiling.LIMIT + 50))


def test_spans_share_the_profilers_clock():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with Profiled() as p:
        with profiling.span("product"):
            torch.mm(a, b)
    (rec,) = [r for r in p.records if r.name == "product"]
    mm = [e for e in p.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert rec.start_ns <= start <= end <= rec.end_ns
    ranges = [e for e in p.events() if e.name() == "product"]
    assert len(ranges) == 1     # the operator's trace names the stage


# ------------------------------------------------------------- the segmenter


@pytest.fixture(scope="module")
def seg():
    return Segmenter.from_pretrained(TINY, device="cpu")


@pytest.fixture(scope="module")
def spec_seg():
    s = Segmenter.from_pretrained(TINY, device="cpu")
    s.set_draft_model(TINY, spec_k=2)
    return s


def counted_steps(monkeypatch):
    calls = []
    inner = decode.decoder_step

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)
    monkeypatch.setattr(decode, "decoder_step", counting)
    return calls


@pytest.mark.parametrize("mode", ["greedy", "beam", "speculative"])
def test_segment_records_one_tree_and_returns_the_same_table(
        seg, spec_seg, mode, monkeypatch):
    audio = tone_bursts(1, sr=SR, duration=5.0)
    s = spec_seg if mode == "speculative" else seg
    kw = dict(num_trials=1, batch_size=1, max_length=24,
              num_beams=2 if mode == "beam" else 1)
    want = s.segment(audio, SR, **kw)
    calls = counted_steps(monkeypatch)
    with Profiled() as p:
        got = s.segment(audio, SR, **kw)
    assert got == want
    names = Counter(r.name for r in p.records)
    batches = 2                 # 5 s: two windows of 2.5 s, one a batch
    # each loop iteration: one target step, or spec_k + 1 draft steps and
    # one verify forward; one prefill a batch (two with a draft)
    per, prefill = (4, 2) if mode == "speculative" else (1, 1)
    iterations = (len(calls) - prefill * batches) // per
    assert iterations > batches
    # the checkpoint's frame post-processing takes its tracks from the
    # decode's encoder pass, or after a speculative decode from a second
    passes = 2 if mode == "speculative" else 1
    assert names == {"segment": 1, "segment.frontend": batches * passes,
                     "segment.encoder": batches * passes,
                     "segment.decode": batches, "decode.step": iterations,
                     "segment.frame_head": batches, "segment.tail": 1}
    got = by_name(p.records)
    (root,) = got["segment"]
    assert root.parent_id is None
    for r in p.records:
        assert r.request_id == root.span_id
    for name in ("segment.frontend", "segment.encoder", "segment.decode",
                 "segment.frame_head", "segment.tail"):
        assert all(r.parent_id == root.span_id for r in got[name])
    assert [r.counts for r in got["segment.frontend"]] == [
        {"windows": 1}] * batches * passes
    decodes = {r.span_id: r for r in got["segment.decode"]}
    for step in got["decode.step"]:
        d = decodes[step.parent_id]
        assert d.start_ns <= step.start_ns <= step.end_ns <= d.end_ns
    (tail,) = got["segment.tail"]
    assert tail.start_ns >= max(r.end_ns for r in got["segment.frame_head"])
    assert tail.end_ns <= root.end_ns


def test_segment_from_frames_records_its_tree(seg):
    audio = tone_bursts(2, sr=SR, duration=7.5)     # 3 windows
    want = seg.segment_from_frames(audio, SR, batch_size=2)
    with Profiled() as p:
        got = seg.segment_from_frames(audio, SR, batch_size=2)
    assert got == want
    names = Counter(r.name for r in p.records)
    assert names == {"segment": 1, "segment.frontend": 2,
                     "segment.encoder": 2, "segment.frame_head": 2,
                     "segment.tail": 1}
    tree = by_name(p.records)
    (root,) = tree["segment"]
    # the second batch is padded to 2 rows; one of them is real
    assert [r.counts for r in tree["segment.frontend"]] == [
        {"windows": 2}, {"windows": 1}]
    assert all(r.parent_id == root.span_id for r in p.records if r is not root)


def test_the_mesh_parts_carry_the_callers_request():
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    cpu = torch.device("cpu")
    meshed = Segmenter(params, cfg, inference_dtype="float32",
                       mesh=make_mesh(devices=[cpu, cpu]))
    audio = tone_bursts(3, sr=SR, duration=5.0)
    with Profiled() as p:
        meshed.segment(audio, SR, num_trials=1, batch_size=4, num_beams=1,
                       max_length=16)
    tree = by_name(p.records)
    (root,) = tree["segment"]
    parts = tree["segment.decode"]
    assert len(parts) == 2      # one a data device, each on its own thread
    assert len({r.thread_id for r in parts}) == 2
    assert root.thread_id not in {r.thread_id for r in parts}
    for r in tree["segment.frontend"] + tree["segment.encoder"] + parts:
        assert r.parent_id == root.span_id and r.request_id == root.span_id
    # 2 real windows in a batch of 4: both in the first part
    assert sorted(r.counts["windows"] for r in tree["segment.frontend"]) == [
        0, 2]


# ------------------------------------------------------------------ training


def test_training_steps_fed_by_the_loader_record_their_trees(tmp_path):
    from whisperseg_torch import data as wd
    from whisperseg_torch.models.config import WhisperConfig
    from whisperseg_torch.models.whisper import init_params
    from whisperseg_torch.synthetic import write_tone_dataset
    from whisperseg_torch.training import trainer as tt

    cols = 200
    cfg = WhisperConfig(d_model=128, encoder_layers=1, decoder_layers=1,
                        num_heads=2, d_ff=256, max_source_positions=100,
                        max_target_positions=64, total_spec_columns=cols,
                        compute_dtype="float32")
    write_tone_dataset(str(tmp_path), 2, duration=2.0)
    audio_paths, label_paths = wd.get_audio_and_label_paths(str(tmp_path))
    default = wd.resolve_default_config(audio_paths, label_paths, cols)
    codebook = wd.get_cluster_codebook(label_paths, {})
    audio_list, label_list = wd.load_data(audio_paths, label_paths, codebook,
                                          n_threads=1, default_config=default)
    audio_list, label_list = wd.slice_audios_and_labels(audio_list,
                                                        label_list, cols)
    dataset = wd.VocalSegDataset(audio_list, label_list, 24, cols,
                                 device="cpu")
    loader = wd.DataLoader(dataset, 2, num_workers=1)
    params = tt.training_params(init_params(torch.Generator().manual_seed(0),
                                            cfg), "cpu")
    optimizer, scheduler, _ = tt.make_optimizer(params, 1e-4, 0.01, 0, 10,
                                                "linear", False)
    step = tt.build_train_step(cfg, optimizer, scheduler)
    gen = torch.Generator().manual_seed(0)
    np.random.seed(0)
    steps = 3
    feed = iter(loader)
    with Profiled() as p:
        for _ in range(steps):
            loss = step(params, tt.batch_to_device(next(feed), "cpu"), gen)
    feed.close()
    assert torch.isfinite(loss)
    names = Counter(r.name for r in p.records)
    assert names == {"train.data_wait": steps, "train.to_device": steps,
                     "train.step": steps, "train.forward": steps,
                     "train.backward": steps, "train.optimizer": steps}
    tree = by_name(p.records)
    for name in ("train.data_wait", "train.to_device", "train.step"):
        assert all(r.parent_id is None for r in tree[name])
    roots = {r.span_id: r for r in tree["train.step"]}
    for name in ("train.forward", "train.backward", "train.optimizer"):
        for r in tree[name]:
            assert r.parent_id in roots and r.request_id == r.parent_id
    for s in tree["train.step"]:
        kids = sorted((r for r in p.records if r.parent_id == s.span_id),
                      key=lambda r: r.start_ns)
        assert [k.name for k in kids] == ["train.forward", "train.backward",
                                          "train.optimizer"]
