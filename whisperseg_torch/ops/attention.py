"""Head-major non-causal encoder attention, forward and backward (kernels
``csrc/attention.cu`` and ``csrc/attention_bwd.cu``).

The forward is the port of ``whisperseg_tpu/ops/attention.py::
fused_attention_head_major``: softmax(q k^T / sqrt(hd)) v per head, keys at
or beyond ``valid_len`` masked, K/V shared by groups of query heads (GQA).
Under training it also writes each row's log-sum-exp, the residual JAX's
stock flash-attention forward saves. The backward is the port of that flash
kernel's two backward kernels (dK/dV and dQ), which the JAX package runs when
the encoder is trained: ``EncoderAttention`` is the ``autograd.Function``
that joins the two, the counterpart of ``fused_attention_hm`` and of the
flash kernel's custom VJP.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
PyTorch versions run only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

# Kernel launches made by the wrappers below (read and reset by callers that
# check which path ran): the forward, those of its launches that also write
# the row log-sum-exp (training's, the port of the flash forward), the dK/dV
# and the dQ kernel.
launches = 0
launches_lse = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0

MAX_GROUP = 8  # query heads per K/V head, the JAX kernel's limit


def _reference_scores(valid_len: int, q4: torch.Tensor, kt4: torch.Tensor):
    """float32 scores [B, Hkv, g, Sp, Sp] scaled after q k^T, keys >=
    valid_len set to -1e30."""
    b, h, sp, hd = q4.shape
    hkv = kt4.shape[1]
    q5 = q4.float().reshape(b, hkv, h // hkv, sp, hd)
    s = torch.einsum("bkgsf,bkft->bkgst", q5, kt4.float()) * (hd ** -0.5)
    keep = torch.arange(sp, device=q4.device) < valid_len
    return torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float32,
                                             device=q4.device))


def attention_hm_reference(valid_len: int, q4: torch.Tensor, kt4: torch.Tensor,
                           v4: torch.Tensor, with_lse: bool = False):
    """Plain version of the Pallas kernel body: float32 scores, p = exp(s -
    max) rounded to q's type, l summed from the rounded p, o = (p v) / l in
    q's type. ``with_lse`` also returns the rows' float32 log-sum-exp
    max + log(l) as [B, H, Sp]."""
    b, h, sp, hd = q4.shape
    s = _reference_scores(valid_len, q4, kt4)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(q4.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,bktf->bkgsf", p, v4.float()) / l
    o = o.reshape(b, h, sp, hd).to(q4.dtype)
    if not with_lse:
        return o
    return o, (m + torch.log(l)).reshape(b, h, sp)


def attention_hm_tiled_reference(valid_len: int, q4: torch.Tensor,
                                 kt4: torch.Tensor, v4: torch.Tensor,
                                 with_lse: bool = False):
    """Plain model of the kernels' own walk (csrc/attention.cu), for tests
    and the chip smoke run; the main path never calls it. The float32
    scores of :func:`attention_hm_reference`, taken in 64-key tiles below
    valid_len (all Sp when valid_len <= 0) with an online softmax: the
    running max m, p = exp(s - m) rounded to q's type against that running
    max, l summed from the rounded p, and l and the output sum rescaled by
    exp(m_old - m_new); o = (sum p v) / l in q's type, lse = m + log(l)."""
    b, h, sp, hd = q4.shape
    s = _reference_scores(valid_len, q4, kt4)
    v = v4.float()
    live = min(valid_len, sp) if valid_len > 0 else sp
    m = torch.full(s.shape[:-1] + (1,), float("-inf"), device=q4.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (hd,), device=q4.device)
    for k0 in range(0, live, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new).to(q4.dtype).float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,bktf->bkgsf", p,
                                         v[:, :, k0:k0 + 64])
        m = m_new
    o = (acc / l).reshape(b, h, sp, hd).to(q4.dtype)
    if not with_lse:
        return o
    return o, (m + torch.log(l)).reshape(b, h, sp)


def _check(valid_len: int, q4: torch.Tensor, kt4: torch.Tensor,
           v4: torch.Tensor) -> None:
    if q4.dim() != 4 or kt4.dim() != 4 or v4.dim() != 4:
        raise ValueError("attention: q4, kt4 and v4 must be 4-D")
    b, h, sp, hd = q4.shape
    hkv = v4.shape[1]
    if tuple(v4.shape) != (b, hkv, sp, hd) or tuple(kt4.shape) != (b, hkv, hd, sp):
        raise ValueError(f"attention: shapes q {tuple(q4.shape)}, kt "
                         f"{tuple(kt4.shape)}, v {tuple(v4.shape)} disagree")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"attention: GQA group size {h}/{hkv} must be a whole "
                         f"number <= {MAX_GROUP}")
    if hd not in (64, 128) or sp % 64:
        raise ValueError(f"attention: needs hd in (64, 128) and Sp % 64 == 0, "
                         f"got hd {hd}, Sp {sp}")
    if q4.dtype not in (torch.float32, torch.bfloat16) \
            or kt4.dtype != q4.dtype or v4.dtype != q4.dtype:
        raise TypeError("attention: q4, kt4, v4 must share float32 or bfloat16")
    if not (q4.is_contiguous() and kt4.is_contiguous() and v4.is_contiguous()):
        raise ValueError("attention: inputs must be contiguous")
    if not (q4.device == kt4.device == v4.device):
        raise ValueError("attention: inputs must be on one device")
    if q4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q4.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("attention").ws_attention_hm
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, i32, ptr]
    fn.restype = i32
    return fn


def fused_attention_head_major(valid_len: int, q4: torch.Tensor,
                               kt4: torch.Tensor, v4: torch.Tensor,
                               with_lse: bool = False):
    """q4 [B, H, Sp, hd], kt4 [B, Hkv, hd, Sp] (K pre-transposed), v4
    [B, Hkv, Sp, hd]; one type (float32 or bfloat16), contiguous; Sp a
    multiple of 64, hd 64 or 128, H / Hkv <= 8. Returns [B, H, Sp, hd] in q's
    type; rows at or beyond valid_len are computed but meaningless. With
    ``with_lse`` returns (o, lse), lse the float32 [B, H, Sp] row
    log-sum-exp; the same single launch writes both."""
    global launches, launches_lse
    _check(valid_len, q4, kt4, v4)
    if q4.device.type == "cpu":
        return attention_hm_reference(valid_len, q4, kt4, v4, with_lse)
    b, h, sp, hd = q4.shape
    o = torch.empty_like(q4)
    lse = (torch.empty((b, h, sp), dtype=torch.float32, device=q4.device)
           if with_lse else None)
    err = _kernel()(q4.data_ptr(), kt4.data_ptr(), v4.data_ptr(), o.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, h, v4.shape[1],
                    sp, hd, int(valid_len), hd ** -0.5,
                    int(q4.dtype == torch.bfloat16),
                    torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    with _build.count_lock:
        launches += 1
        launches_lse += with_lse
    return (o, lse) if with_lse else o


# ------------------------------------------------------------------ backward


def _backward_plain(valid_len: int, q4, kt4, v4, do, lse, delta):
    """The backward's math from the residuals -> (dq, dkt, dv) in q's type
    (see csrc/attention_bwd.cu). Sums in float32; like the stock flash
    kernel, P is rounded to q's type before dV = P^T dO, and dS is scaled,
    then rounded, before dQ = dS k and dK = dS^T q (no-ops in float32)."""
    b, h, sp, hd = q4.shape
    hkv = v4.shape[1]
    g = h // hkv
    dt = q4.dtype
    q5 = q4.float().reshape(b, hkv, g, sp, hd)
    do5 = do.float().reshape(b, hkv, g, sp, hd)
    # masked keys score -1e30, so their P is exactly 0
    p = torch.exp(_reference_scores(valid_len, q4, kt4)
                  - lse.reshape(b, hkv, g, sp, 1))
    dv = torch.einsum("bkgst,bkgsf->bktf", p.to(dt).float(), do5)
    dp = torch.einsum("bkgsf,bktf->bkgst", do5, v4.float())
    ds = (p * (dp - delta.reshape(b, hkv, g, sp, 1)) * hd ** -0.5).to(dt).float()
    dq = torch.einsum("bkgst,bkft->bkgsf", ds, kt4.float())
    dkt = torch.einsum("bkgst,bkgsf->bkft", ds, q5)
    return dq.reshape(b, h, sp, hd).to(dt), dkt.to(dt), dv.to(dt)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(o * dO) in float32 [B, H, Sp], computed outside the
    kernels as in the flash kernel's VJP."""
    return (o.float() * do.float()).sum(dim=-1)


def attention_hm_backward_reference(valid_len: int, q4, kt4, v4, o, do, lse):
    """Plain version of the backward: from the forward's inputs, its output
    ``o``, the output gradient ``do`` and the row log-sum-exp ``lse`` ->
    (dq [B, H, Sp, hd], dkt [B, Hkv, hd, Sp], dv [B, Hkv, Sp, hd]) in q's
    type, sums in float32: S = q k^T scale, P = exp(S - lse) (0 at masked
    keys), dV = sum_g P^T dO, dP = dO v^T, dS = P (dP - D) scale with
    D = rowsum(o dO), dQ = dS k, dK = sum_g dS^T q; P and dS rounded to q's
    type before their products."""
    return _backward_plain(valid_len, q4, kt4, v4, do, lse, _delta(o, do))


@functools.lru_cache(maxsize=None)
def _bwd_kernel(name: str):
    fn = getattr(_build.library("attention_bwd"), name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    outs = [ptr, ptr] if name == "ws_attention_bwd_dkv" else [ptr]
    fn.argtypes = ([ptr] * 6 + outs + [i32] * 6
                   + [ctypes.c_float, i32, ptr])
    fn.restype = i32
    return fn


def _check_bwd(valid_len: int, q4, kt4, v4, do, lse, delta) -> None:
    _check(valid_len, q4, kt4, v4)
    b, h, sp, _ = q4.shape
    if do.shape != q4.shape or do.dtype != q4.dtype or not do.is_contiguous():
        raise ValueError("attention backward: dO must be a contiguous tensor "
                         "of q's shape and type")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sp) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"attention backward: {name} must be contiguous "
                             f"float32 [B, H, Sp]")
    if not (do.device == lse.device == delta.device == q4.device):
        raise ValueError("attention backward: inputs must be on one device")
    if valid_len < 1:
        raise ValueError("attention backward: valid_len must be >= 1")


def _launch_bwd(name: str, valid_len: int, q4, kt4, v4, do, lse, delta,
                outs) -> None:
    b, h, sp, hd = q4.shape
    err = _bwd_kernel(name)(
        q4.data_ptr(), kt4.data_ptr(), v4.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *[t.data_ptr() for t in outs],
        b, h, v4.shape[1], sp, hd, int(valid_len), hd ** -0.5,
        int(q4.dtype == torch.bfloat16),
        torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def attention_hm_bwd_dkv(valid_len: int, q4, kt4, v4, do, lse, delta
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: (dkt [B, Hkv, hd, Sp], dv [B, Hkv, Sp, hd]) in q's
    type from q4, kt4, v4, dO (q's type) and the float32 [B, H, Sp] row
    log-sum-exp and D = rowsum(o dO)."""
    global launches_bwd_dkv
    _check_bwd(valid_len, q4, kt4, v4, do, lse, delta)
    if q4.device.type == "cpu":
        return _backward_plain(valid_len, q4, kt4, v4, do, lse, delta)[1:]
    dkt, dv = torch.empty_like(kt4), torch.empty_like(v4)
    _launch_bwd("ws_attention_bwd_dkv", valid_len, q4, kt4, v4, do, lse,
                delta, (dkt, dv))
    with _build.count_lock:
        launches_bwd_dkv += 1
    return dkt, dv


def attention_hm_bwd_dq(valid_len: int, q4, kt4, v4, do, lse, delta
                        ) -> torch.Tensor:
    """The dQ kernel: dq [B, H, Sp, hd] in q's type from the same inputs."""
    global launches_bwd_dq
    _check_bwd(valid_len, q4, kt4, v4, do, lse, delta)
    if q4.device.type == "cpu":
        return _backward_plain(valid_len, q4, kt4, v4, do, lse, delta)[0]
    dq = torch.empty_like(q4)
    _launch_bwd("ws_attention_bwd_dq", valid_len, q4, kt4, v4, do, lse, delta,
                (dq,))
    with _build.count_lock:
        launches_bwd_dq += 1
    return dq


def attention_hm_backward(valid_len: int, q4, kt4, v4, o, do, lse):
    """(dq, dkt, dv) of the head-major attention: D = rowsum(o dO) in float32,
    then the dK/dV kernel and the dQ kernel (on the CPU, the plain version
    once)."""
    do = do.contiguous()
    delta = _delta(o, do)
    if q4.device.type == "cpu":  # the plain version once, not once a kernel
        _check_bwd(valid_len, q4, kt4, v4, do, lse, delta)
        return _backward_plain(valid_len, q4, kt4, v4, do, lse, delta)
    dkt, dv = attention_hm_bwd_dkv(valid_len, q4, kt4, v4, do, lse, delta)
    dq = attention_hm_bwd_dq(valid_len, q4, kt4, v4, do, lse, delta)
    return dq, dkt, dv


class EncoderAttention(torch.autograd.Function):
    """Differentiable head-major encoder attention: the forward kernel with
    its row log-sum-exp, the two backward kernels for the gradient."""

    @staticmethod
    def forward(ctx, valid_len: int, q4, kt4, v4):
        o, lse = fused_attention_head_major(valid_len, q4, kt4, v4,
                                            with_lse=True)
        ctx.valid_len = valid_len
        ctx.save_for_backward(q4, kt4, v4, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q4, kt4, v4, o, lse = ctx.saved_tensors
        dq, dkt, dv = attention_hm_backward(ctx.valid_len, q4, kt4, v4, o,
                                            do.to(q4.dtype), lse)
        return None, dq, dkt, dv


def encoder_attention(valid_len: int, q4: torch.Tensor, kt4: torch.Tensor,
                      v4: torch.Tensor) -> torch.Tensor:
    """The encoder's attention: through ``EncoderAttention`` when a gradient
    is wanted, else exactly one forward launch that writes no log-sum-exp."""
    if torch.is_grad_enabled() and (q4.requires_grad or kt4.requires_grad
                                    or v4.requires_grad):
        return EncoderAttention.apply(valid_len, q4, kt4, v4)
    return fused_attention_head_major(valid_len, q4, kt4, v4)

