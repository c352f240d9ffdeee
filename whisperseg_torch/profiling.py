"""Profiling, stage spans and step timing (the port of
``whisperseg_tpu/profiling.py``, plus the span recorder).

:func:`trace` records a ``torch.profiler`` trace (host and, on the card,
CUDA activity) and writes it into a directory as a Chrome trace.

:func:`span` marks a stage of the program (``segment``, ``segment.decode``,
``decode.step``, ``train.step``, ...). Spans record only while a
``torch.profiler`` is recording, whoever started it (:func:`trace`, the
train CLI's ``--profile_dir``, a benchmark's device trace); otherwise
``span()`` returns one shared context that does nothing. A recorded span
enters ``torch.profiler.record_function(name)``, so the profiler's Chrome
trace names the stage, and keeps a :class:`Record` in a bounded buffer in
memory, timed by ``time.time_ns()``, the clock of the profiler's own
events. :func:`recorded` returns the records of a window. Spans nest on
each thread: a span opened inside another is its child and shares its
request id; a span opened with none open on its thread is a root and starts
a request. :func:`current` and :func:`inherit` carry a request into a
worker thread.

:class:`StepTimer` keeps the host wall clock between ticks over a rolling
window. The training loop does not synchronize the device each step, so on
the card a tick measures the host's dispatch until the device's queue
fills, and the device's rate after.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

# the most records kept; the oldest go first
LIMIT = 1 << 14


class Record(NamedTuple):
    """One closed span: times in ``time.time_ns()`` nanoseconds, the id of
    the span that was open around it on its thread (None for a root), the
    request it belongs to (a root's own id), and its counts."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    request_id: int
    thread_id: int
    counts: Dict[str, int]


_records: "deque[Record]" = deque(maxlen=LIMIT)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span being recorded; see :func:`span`."""

    __slots__ = ("name", "counts", "span_id", "parent_id", "request_id",
                 "start_ns", "dropped", "_range")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts, self.dropped = name, counts, False

    def drop(self) -> None:
        """Keep no record of this span (its profiler range stays)."""
        self.dropped = True

    def count(self, **counts: int) -> None:
        """Add counts known only inside the span."""
        self.counts.update(counts)

    def settle(self, device) -> None:
        """Wait for the work queued on a CUDA ``device``, so that the span
        ends with its device work (a cost paid only while recording)."""
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.span_id = next(_ids)
        if stack:
            self.parent_id = stack[-1].span_id
            self.request_id = stack[-1].request_id
        else:
            self.parent_id, self.request_id = None, self.span_id
        stack.append(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        if not self.dropped:
            _records.append(Record(self.name, self.start_ns, end_ns,
                                   self.span_id, self.parent_id,
                                   self.request_id, threading.get_ident(),
                                   self.counts))
        return False


class _Off:
    """The span when nothing records: enters and drops nothing."""

    def drop(self) -> None:
        pass

    def count(self, **counts: int) -> None:
        pass

    def settle(self, device) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **counts: int):
    """A context manager marking the stage ``name``, with small integer
    ``counts`` (windows, rows, ...). Recorded while a ``torch.profiler``
    records (the profiler's own flag, read once, here; it holds for the
    whole process, while the profiler's ranges reach only the threads it
    traces); else the shared context that does nothing. ``as`` gives an
    object with ``drop()``, ``count(**counts)`` and ``settle(device)``."""
    if not recording():
        return _OFF
    return _Span(name, counts)


def recording() -> bool:
    """Whether spans record now (a ``torch.profiler`` is recording)."""
    return bool(_profiler._is_profiler_enabled)


class _Carried(NamedTuple):
    span_id: int
    request_id: int


def current() -> Optional[Tuple[int, int]]:
    """(span id, request id) of this thread's innermost open span, or None:
    what a worker thread :func:`inherit`\\ s."""
    stack = getattr(_local, "stack", None)
    return (stack[-1].span_id, stack[-1].request_id) if stack else None


@contextlib.contextmanager
def inherit(parent: Optional[Tuple[int, int]]):
    """On a worker thread: spans opened in the block are children of
    ``parent`` (from :func:`current` on the caller's thread) and belong to
    its request. Nothing with None."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(_Carried(*parent))
    try:
        yield
    finally:
        stack.pop()


def recorded(lo_ns: int, hi_ns: int) -> List[Record]:
    """The kept records of spans that started at or after ``lo_ns`` and
    ended at or before ``hi_ns`` (``time.time_ns()``), in the order they
    closed."""
    return [r for r in list(_records)
            if lo_ns <= r.start_ns and r.end_ns <= hi_ns]


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, written as
    ``log_dir/trace-<pid>-<time>.json`` (Chrome trace format) when it ends;
    nothing without a directory. CUDA activity is recorded when CUDA is
    available. Spans record while it runs."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{int(time.time())}.json"))


class StepTimer:
    """Rolling wall-clock step statistics."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def steps_per_second(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def mean_step_ms(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.times) / len(self.times) * 1000.0

    def summary(self) -> dict:
        return {"steps_per_second": round(self.steps_per_second, 3),
                "mean_step_ms": round(self.mean_step_ms, 2)}
