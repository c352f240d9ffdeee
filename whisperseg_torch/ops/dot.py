"""The plain matrix product with a float32 result."""

from __future__ import annotations

import torch


class _Bf16DotF32(torch.autograd.Function):
    """x [M, K] @ w [K, N] with bf16 operands and a float32 result on the
    card (``torch.mm(..., out_dtype=float32)``), and a backward of the same
    kind: the float32 output gradient is rounded to bf16 and both input
    gradients come back in float32 from bf16 GEMMs. The operands are cast
    inside, so a float32 master weight gets a float32 gradient."""

    @staticmethod
    def forward(ctx, x, w):
        xc, wc = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xc, wc)
        return torch.mm(xc, wc, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        xc, wc = ctx.saved_tensors
        dyc = dy.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(dyc, wc.t(), out_dtype=torch.float32)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(xc.t(), dyc, out_dtype=torch.float32)
        return dx, dw


def dot_f32(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x [..., in] @ w [in, out] with both operands cast to ``cdt`` and a
    float32 result (JAX's ``preferred_element_type=float32``). A bf16 product
    would otherwise come back rounded to bf16: on the card the bf16 GEMM
    writes float32 directly, on the CPU the operands are widened (bf16
    products are exact in float32). Under autograd the card's bf16 product
    goes through ``_Bf16DotF32``, whose backward is bf16 GEMMs with float32
    results."""
    if cdt == torch.float32:
        return x.float() @ w.float()
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _Bf16DotF32.apply(x2, w)
        else:
            y = torch.mm(x2.to(cdt), w.to(cdt), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(cdt).float() @ w.to(cdt).float()
