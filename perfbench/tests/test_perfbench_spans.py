"""The span readers (``source`` ``program_span``) on hand-built views: the
program's records and the trace's host events give the hand-computed
value, and no spans give None (as a program without the recorder does)."""

from types import SimpleNamespace

import pytest

from perfbench import run, spans, trace
from whisperseg_torch.profiling import Record

MS = 1_000_000      # ns


def rec(name, a_ms, b_ms, span_id, parent=None, request=None, **counts):
    return Record(name, int(a_ms * MS), int(b_ms * MS), span_id, parent,
                  span_id if request is None else request, 1, counts)


def view(records, host=(), kernels=(), t0=0, t1=10_000 * MS):
    t = trace.DeviceTrace()
    t.t0, t.t1 = t0, t1
    t.kernels, t.host = list(kernels), sorted(host)
    return SimpleNamespace(trace=t, work={}, model={}, mix={},
                           records=records)


@pytest.fixture
def program(monkeypatch):
    """The recorder's ``recorded(lo, hi)`` over a view's records."""
    def use(v):
        monkeypatch.setattr(
            spans, "_recorded",
            lambda lo, hi: None if v.records is None else
            [r for r in v.records if lo <= r.start_ns and r.end_ns <= hi])
        return v
    return use


def read(name, v):
    return run.read_metric(name, v)


SEGMENT = [
    # request 1: two batches, a 4 ms tail
    rec("segment", 0, 100, 1),
    rec("segment.frontend", 1, 3, 2, 1, 1, windows=16),
    rec("segment.decode", 10, 50, 3, 1, 1),
    rec("decode.step", 10, 15, 4, 3, 1),
    rec("decode.step", 30, 35, 5, 3, 1),
    rec("decode.step", 40, 45, 6, 3, 1),
    rec("segment.frontend", 51, 52, 7, 1, 1, windows=6),
    rec("segment.decode", 55, 90, 8, 1, 1),
    rec("decode.step", 55, 60, 9, 8, 1),
    rec("decode.step", 65, 70, 10, 8, 1),
    rec("segment.tail", 96, 100, 11, 1, 1),
    # request 2: a 9 ms tail; request 3: 2 ms
    rec("segment", 200, 300, 12),
    rec("segment.tail", 291, 300, 13, 12, 12),
    rec("segment", 400, 500, 14),
    rec("segment.tail", 498, 500, 15, 14, 14),
]
# decode 3: steps at 10, 30, 40, its end 50 -> periods 20, 10, 10;
# decode 8: steps at 55, 65, its end 90 -> periods 10, 25


def test_tail_ms_is_the_median_request(program):
    assert read("tail_ms.segment", program(view(SEGMENT))) == 4.0


def test_frontend_ms_per_window(program):
    assert read("frontend_ms_per_window.segment",
                program(view(SEGMENT))) == pytest.approx(3.0 / 22)


def test_decode_ms_per_step_is_the_median_period(program):
    assert read("decode_ms_per_step.segment",
                program(view(SEGMENT))) == pytest.approx(10.0)


def test_launch_calls_per_decode_step(program):
    host = [(int(t * MS), int(t * MS) + 10, n) for t, n in [
        (11, "cudaLaunchKernel"), (12, "cudaLaunchKernelExC"),
        (13, "cuLaunchKernel"), (14, "cudaMemcpyAsync"),
        (31, "cudaGraphLaunch"), (36, "cudaLaunchKernel"),    # between steps
        (41, "cudaLaunchKernel"), (56, "aten::mm"),
        (66, "cudaLaunchKernel"), (5, "cudaLaunchKernel")]]   # before
    # inside the 5 steps: 3 + 1 + 1 + 0 + 1
    assert read("launch_calls_per_decode_step.segment",
                program(view(SEGMENT, host))) == pytest.approx(6 / 5)


TRAIN = [
    rec("train.data_wait", 0, 3, 1), rec("train.to_device", 3, 4, 2),
    rec("train.step", 4, 40, 3), rec("train.forward", 4, 10, 4, 3, 3),
    rec("train.backward", 10, 30, 5, 3, 3),
    rec("train.optimizer", 30, 40, 6, 3, 3),
    rec("train.data_wait", 40, 45, 7), rec("train.to_device", 45, 47, 8),
    rec("train.step", 47, 80, 9),
]


def test_launch_calls_per_train_step(program):
    host = [(int(t * MS), int(t * MS) + 5, "cudaLaunchKernel")
            for t in (2, 5, 6, 39, 41, 50, 79, 80)]
    # inside [4, 40) and [47, 80): 5, 6, 39, 50, 79
    assert read("launch_calls_per_step.train",
                program(view(TRAIN, host))) == pytest.approx(5 / 2)


def test_data_wait_ms_per_step(program):
    # the loader's waits only, not the copies (train.to_device)
    assert read("data_wait_ms_per_step.train",
                program(view(TRAIN))) == pytest.approx((3 + 5) / 2)


NAMES = ["tail_ms.segment", "frontend_ms_per_window.segment",
         "decode_ms_per_step.segment", "launch_calls_per_decode_step.segment",
         "launch_calls_per_step.train", "data_wait_ms_per_step.train"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("records", [None, [], "outside"])
def test_none_without_spans(program, name, records):
    if records == "outside":    # spans, but none inside the traced window
        v = view(SEGMENT + TRAIN, t0=20_000 * MS, t1=30_000 * MS)
    else:
        v = view(records)
    assert read(name, program(v)) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_the_program_with_nothing_recorded(name):
    """The program's own recorder, with no profiler run in the window."""
    assert read(name, view(None, t0=1, t1=2)) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_a_program_without_the_recorder(name, monkeypatch):
    """A checkout whose program keeps no spans (the recorder absent)."""
    from whisperseg_torch import profiling

    monkeypatch.delattr(profiling, "recorded")
    assert read(name, view(None)) is None
