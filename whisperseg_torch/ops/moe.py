"""The routed experts' product of a mixture-of-experts layer: each token's
rows through the SwiGLU experts its router chose, ``down_e(silu(x gate_e)
* (x up_e))``, one output row per (token, choice).

No TPU kernel of the JAX package computes this: it was added with the
``audio_lm`` decoder family (models/audio_lm.py), whose expert layers hold
64 experts of width 1408. On the card the (token, choice) pairs are sorted
by expert and their rows gathered, and three grouped products
(``torch._grouped_mm``: one GEMM a group of rows, the groups' ends in a
device tensor) take them through the gate, the up and the down matrices of
each row's expert; ``silu(gate) * up`` is formed between them. The groups'
ends are the running sum of :func:`expert_counts`, on the device: nothing
reads the device from the host and no shape depends on the routing, so a
CUDA graph can capture the layer. At a decode step (64 rows, 384 pairs over
64 experts) each product reads the weights of the experts that got a row
once and is bound by memory; at a prefill (~48,000 pairs, ~750 an expert)
it is bound by the tensor cores.

``expert_mlp`` runs the plain version, a loop over the experts, for tensors
on the CPU, and the grouped products for tensors on the card; ``launches``
counts the grouped products.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .dot import dot_f32

# Grouped-product launches (gate, up and down each count one), read and
# reset by callers that check which path ran.
launches = 0
_count_lock = threading.Lock()


def expert_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The (token, choice) pairs each expert takes: idx [T, k] -> [E] int64,
    by ``scatter_add_`` into a fixed buffer (no data-dependent shape)."""
    flat = idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.long,
                       device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def expert_mlp(x: torch.Tensor, idx: torch.Tensor, gate_w: torch.Tensor,
               up_w: torch.Tensor, down_w: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """x [T, D] in the weights' type; idx [T, k] the chosen experts; gate_w,
    up_w [E, D, F], down_w [E, F, D]; counts [E] from :func:`expert_counts`.
    Returns [T, k, D] float32: row (t, j) is expert ``idx[t, j]`` applied to
    x[t]. Products take their operands in the weights' type; the plain
    version keeps float32 sums, the card's grouped products round the gate,
    up and down rows to bfloat16. ``silu(gate) * up`` is formed in float32
    and rounded to the weights' type before the down product."""
    if x.device.type == "cpu":
        return expert_mlp_plain(x, idx, gate_w, up_w, down_w)
    if x.device.type != "cuda":
        raise ValueError(f"expert_mlp: unsupported device {x.device}")
    return _expert_mlp_grouped(x, idx, gate_w, up_w, down_w, counts)


def expert_mlp_plain(x, idx, gate_w, up_w, down_w) -> torch.Tensor:
    """The plain version: for each expert, its rows through its SwiGLU."""
    t, k = idx.shape
    cdt = gate_w.dtype
    out = torch.zeros(t, k, down_w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for e in range(gate_w.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = x[tok]
        act = (F.silu(dot_f32(rows, gate_w[e], cdt))
               * dot_f32(rows, up_w[e], cdt)).to(cdt)
        out[tok, slot] = dot_f32(act, down_w[e], cdt)
    return out


def _expert_mlp_grouped(x, idx, gate_w, up_w, down_w, counts):
    global launches
    t, k = idx.shape
    e, d, f = gate_w.shape
    # the grouped GEMM takes bfloat16 on the card; its float32 form reads
    # the groups' ends on the host, which no CUDA graph can hold
    if gate_w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError("expert_mlp: on the card x and the weights must be "
                         "bfloat16 (the grouped products' type)")
    for w, shape in ((gate_w, (e, d, f)), (up_w, (e, d, f)),
                     (down_w, (e, f, d))):
        if tuple(w.shape) != shape:
            raise ValueError("expert_mlp: weights must be [E, D, F] / "
                             "[E, F, D]")
    order = torch.sort(idx.reshape(-1), stable=True).indices
    rows = x[order // k]                       # [T k, D], grouped by expert
    ends = torch.cumsum(counts, 0).to(torch.int32)
    gate = torch._grouped_mm(rows, gate_w, offs=ends)
    up = torch._grouped_mm(rows, up_w, offs=ends)
    act = (F.silu(gate.float()) * up.float()).to(torch.bfloat16)
    y = torch._grouped_mm(act, down_w, offs=ends)
    with _count_lock:
        launches += 3
    out = torch.empty(t * k, d, dtype=torch.float32, device=x.device)
    out[order] = y.float()
    return out.view(t, k, d)
