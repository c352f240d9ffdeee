"""moe_roofline.segment: the least time of the routed experts' products in
the traced window, from the expert load that the program's
``segment.decode`` spans count (``routed_*``, ``experts_*`` of the prefill
and decode phases) by ``roofline_moe.moe_bound_ms``, over the device time of
the kernels that compute them (the program's ops/moe.py: PyTorch's grouped
GEMM, whose kernels hold ``GroupProblemShape`` in their names, and the
kernel that lays out its groups, ``prepare_grouped_gemm_data``), in per
cent. None where either is missing."""

from perfbench import roofline_moe
from perfbench.readers import device_ms
from perfbench.spans import records

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(view):
    if view.trace is None:
        return None
    ks = [k for key in KERNELS for k in view.trace.matching(key)]
    decodes = records(view, "segment.decode")
    if not ks or decodes is None:
        return None
    counts = {}
    for r in decodes:
        for k, v in r.counts.items():
            counts[k] = counts.get(k, 0) + v
    bound_ms = roofline_moe.moe_bound_ms(view.model, counts)
    return 100.0 * bound_ms / device_ms(ks) if bound_ms else None
