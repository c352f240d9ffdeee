"""frontend_ms_per_window.segment: the program's ``segment.frontend`` spans
in the traced window (a batch's clip copy to the device and its log-mel
features) summed, over the real windows they count, in ms."""

from perfbench.spans import ms, records


def read(view):
    spans = records(view, "segment.frontend")
    if spans is None:
        return None
    windows = sum(r.counts.get("windows", 0) for r in spans)
    return sum(ms(r) for r in spans) / windows if windows else None
