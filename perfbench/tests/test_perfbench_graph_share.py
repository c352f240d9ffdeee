"""The ``graph_step_share.segment`` reader on hand-built span records: the
share of ``decode.step`` spans with ``graphed`` 1, and None where there are
no spans or none that carries the count (a program that graphs nothing)."""

from types import SimpleNamespace

import pytest

from perfbench import run, spans, trace
from whisperseg_torch.profiling import Record

MS = 1_000_000      # ns
NAME = "graph_step_share.segment"


def steps(*graphed):
    """One ``segment.decode`` and a 5 ms ``decode.step`` a value of
    ``graphed`` (None: no count)."""
    out = [Record("segment.decode", 0, 1000 * MS, 1, None, 1, 1, {})]
    for i, g in enumerate(graphed):
        counts = {} if g is None else {"graphed": g}
        out.append(Record("decode.step", (10 * i + 1) * MS, (10 * i + 6) * MS,
                          i + 2, 1, 1, 1, counts))
    return out


def read(records, monkeypatch):
    monkeypatch.setattr(
        spans, "_recorded",
        lambda lo, hi: [r for r in records if lo <= r.start_ns and r.end_ns <= hi])
    t = trace.DeviceTrace()
    t.t0, t.t1 = 0, 10_000 * MS
    t.kernels, t.host = [], []
    return run.read_metric(NAME, SimpleNamespace(trace=t, work={}, model={},
                                                 mix={}))


@pytest.mark.parametrize("graphed,want", [
    ((1, 1, 1, 1), 100.0),
    ((0, 0, 0), 0.0),
    ((0, 1, 1, 1), 75.0),
    ((1, 0, None, 1), 50.0),    # a step without the count is not graphed
])
def test_share_of_graphed_steps(graphed, want, monkeypatch):
    assert read(steps(*graphed), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("records", [[], steps(), steps(None, None)])
def test_none_without_graphed_counts(records, monkeypatch):
    assert read(records, monkeypatch) is None
