"""The plain matrix product with a float32 result."""

from __future__ import annotations

import torch


def dot_f32(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x [..., in] @ w [in, out] with both operands cast to ``cdt`` and a
    float32 result (JAX's ``preferred_element_type=float32``). A bf16 product
    would otherwise come back rounded to bf16: on the card the bf16 GEMM
    writes float32 directly, on the CPU the operands are widened (bf16
    products are exact in float32)."""
    x, w = x.to(cdt), w.to(cdt)
    if cdt == torch.float32:
        return x @ w
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()
