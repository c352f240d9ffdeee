"""Profiling and step timing (the port of ``whisperseg_tpu/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace (host and, on the card,
CUDA activity) and writes it into a directory as a Chrome trace.
:class:`StepTimer` keeps the host wall clock between ticks over a rolling
window. The training loop does not synchronize the device each step, so on
the card a tick measures the host's dispatch until the device's queue
fills, and the device's rate after.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, written as
    ``log_dir/trace-<pid>-<time>.json`` (Chrome trace format) when it ends;
    nothing without a directory. CUDA activity is recorded when CUDA is
    available."""
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
