"""Step timing (the ``StepTimer`` of ``whisperseg_tpu/profiling.py``).

Host wall clock between ticks, over a rolling window. The training loop does
not synchronize the device each step, so on the card a tick measures the
host's dispatch until the device's queue fills, and the device's rate after.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


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
