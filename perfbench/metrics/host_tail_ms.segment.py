"""host_tail_ms.segment: the median over the traced recordings of the time
from the recording's last device operation to the return of its call
(the host's parse, consolidation, frame tracks and refinement), in ms."""

from perfbench.trace import median


def read(view):
    t = view.trace
    if t is None or not t.kernels:
        return None
    tails = []
    for start, end in (view.work or {}).get("requests", []):
        last = max((b for a, b, _ in t.kernels if start <= a and b <= end),
                   default=None)
        if last is not None:
            tails.append((end - last) / 1e6)
    return median(tails)
