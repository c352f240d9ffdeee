"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a part
of the window, reduced to kernel intervals, the device's busy time and a
breakdown.

The busy time is the union of the kernel intervals with user annotations
left out, as ``chip_smoke.py::report_profile`` computes it (a frozen copy of
its loop). Timestamps are host epoch nanoseconds, the clock of the
harness's own spans (``time.time_ns``)."""

from __future__ import annotations

import time
from bisect import bisect_left
from typing import List, Optional, Tuple

import numpy as np

Interval = Tuple[int, int]


def busy_ns(intervals: List[Interval]) -> int:
    """Length of the union of [start, end) intervals."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def idle_gaps(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [g for g in gaps if g[1] > g[0]]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class DeviceTrace:
    """Start with :meth:`start`, end with :meth:`stop` (which synchronizes
    the card first and stops the profiler); the events are read once the
    window has closed, at the first use of ``kernels`` (start_ns, end_ns,
    name of every device operation) or ``host`` (the host's operations).
    ``window_ns`` is the traced stretch."""

    def __init__(self):
        self.prof = None
        self._kernels: Optional[List[Tuple[int, int, str]]] = None
        self._host: List[Tuple[int, int, str]] = []
        self.t0 = self.t1 = 0

    def start(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()
        return self

    def stop(self) -> "DeviceTrace":
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()
        return self

    def _read(self) -> None:
        from torch.autograd import DeviceType

        kernels = []
        for e in self.prof.profiler.kineto_results.events():
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (kernels if e.device_type() == DeviceType.CUDA
             else self._host).append(item)
        self.prof = None
        self._kernels = sorted(kernels)
        self._host.sort()

    @property
    def kernels(self) -> List[Tuple[int, int, str]]:
        if self._kernels is None:
            self._read()
        return self._kernels

    @kernels.setter
    def kernels(self, value):
        self._kernels = value

    @property
    def host(self) -> List[Tuple[int, int, str]]:
        if self._kernels is None:
            self._read()
        return self._host

    @host.setter
    def host(self, value):
        self._host = value

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    def busy_ns(self) -> int:
        return busy_ns([(max(a, self.t0), min(b, self.t1))
                        for a, b, _ in self.kernels if b > self.t0 and a < self.t1])

    def launches(self, lo: Optional[int] = None, hi: Optional[int] = None) -> int:
        """Device kernels (copies and fills left out) that start in [lo, hi)."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        return sum(1 for a, _, n in self.kernels if lo <= a < hi and not _is_copy(n))

    def matching(self, key: str) -> List[Tuple[int, int, str]]:
        return [k for k in self.kernels if key in k[2]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        stretches summed by what the host was running when each began (the
        longest host operation under way then)."""
        by_name: dict = {}
        for a, b, n in self.kernels:
            by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(a, b) for a, b, _ in self.kernels], self.t0, self.t1)
        starts = [h[0] for h in self.host]
        named: dict = {}
        for lo, hi in gaps:
            i = bisect_left(starts, lo)
            best, best_len = "host idle", 0
            for a, b, n in self.host[max(0, i - 64):i + 64]:
                cover = min(b, hi) - max(a, lo)
                if cover > best_len:
                    best, best_len = n, cover
            named[best] = named.get(best, 0) + (hi - lo)
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], t / 1e9] for n, t in ops],
                "idle_gaps": [[n[:120], t / 1e9] for n, t in idle]}


def median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None
