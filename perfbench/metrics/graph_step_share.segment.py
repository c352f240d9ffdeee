"""graph_step_share.segment: the share of the program's decoder steps in
the traced window that replayed a CUDA graph, in per cent: the
``decode.step`` spans whose ``graphed`` count is 1, over all of them. A
program whose steps carry no ``graphed`` count gives None."""

from perfbench.spans import records


def read(view):
    steps = records(view, "decode.step")
    if steps is None or not any("graphed" in s.counts for s in steps):
        return None
    return 100.0 * sum(s.counts.get("graphed") == 1 for s in steps) / len(steps)
