"""What the span readers (``perfbench/metrics/*``, ``source``
``program_span``) share: the program's own stage spans
(``whisperseg_torch.profiling``), which it records while a
``torch.profiler`` runs, so in a traced run's window. Their times are
``time.time_ns()``, the clock of the device trace's events. A program
without the recorder, or a window without spans, gives None, and the
reader then returns None."""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional

import numpy as np


def _recorded(lo_ns: int, hi_ns: int):
    try:
        from whisperseg_torch import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded(lo_ns, hi_ns)


def records(view, *names: str) -> Optional[List]:
    """The program's spans named ``names`` inside the traced window, by
    start; None where there are none."""
    t = view.trace
    if t is None:
        return None
    found = _recorded(t.t0, t.t1)
    found = sorted((r for r in found or () if r.name in names),
                   key=lambda r: r.start_ns)
    return found or None


def ms(record) -> float:
    return (record.end_ns - record.start_ns) / 1e6


def median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None


def launch_calls_inside(view, spans) -> int:
    """Host calls that launch device work (a name with ``LaunchKernel``, or
    ``GraphLaunch``: a CUDA graph counts once) that start inside one of
    ``spans``."""
    starts = sorted(a for a, _b, n in view.trace.host
                    if "LaunchKernel" in n or "GraphLaunch" in n)
    return sum(bisect_left(starts, r.end_ns) - bisect_left(starts, r.start_ns)
               for r in spans)


def children(spans, parents) -> Dict[int, List]:
    """Each parent's id -> its children among ``spans``, by start."""
    ids = {p.span_id for p in parents}
    out: Dict[int, List] = {i: [] for i in ids}
    for r in spans:
        if r.parent_id in ids:
            out[r.parent_id].append(r)
    return out
