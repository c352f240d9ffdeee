"""decode_ms_per_step.segment: the median period of the program's decoder
steps in the traced window: from a ``decode.step`` span's start to the next
one's start in the same ``segment.decode`` (the last to that span's end), in
ms. Each step opens with the loop's continue-check, a read on the host, so
the period holds the device's work of a step."""

from perfbench.spans import children, median, records


def read(view):
    steps = records(view, "decode.step")
    decodes = records(view, "segment.decode")
    if steps is None or decodes is None:
        return None
    periods = []
    by_decode = children(steps, decodes)
    for d in decodes:
        mine = by_decode[d.span_id]
        ends = [s.start_ns for s in mine[1:]] + [d.end_ns]
        periods += [(b - s.start_ns) / 1e6 for s, b in zip(mine, ends)]
    return median(periods)
