"""prefill_ms_per_window.segment: the program's ``segment.prefill`` spans in
the traced window (an audio LM's prefill of a batch's prefixes, the
projected encoder states and the prompt through every layer, ended by a
synchronize while spans record) summed, over the windows they count (the
batch's rows, padding rows included), in ms. A program without the span
gives None."""

from perfbench.spans import ms, records


def read(view):
    spans = records(view, "segment.prefill")
    if spans is None:
        return None
    windows = sum(r.counts.get("windows", 0) for r in spans)
    return sum(ms(r) for r in spans) / windows if windows else None
