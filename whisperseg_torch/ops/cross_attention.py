"""Single-query cross-attention on int8 K/V (kernel
``csrc/cross_attention_int8.cu``).

The port of ``whisperseg_tpu/ops/cross_attention.py``: the decode step's
cross-attention reads the encoder's K/V, its largest stream, so they are
stored as int8 with one scale per (position, kv head), and dequantized on
chip. The scales are kept in bf16, after quantizing with the float32 scale:
that rounding is part of the function.

The TPU kernel's layout devices do not carry over: the port stores the
scales as [.., S, Hkv] (no 128-lane padding, no head-sum matrix) and needs no
padded S. ``seq_len`` stays in the interface, and positions at or beyond it
are never read. On a CUDA tensor the wrapper launches the kernel or raises;
the plain PyTorch version runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

# Kernel launches made by the wrapper below (read and reset by callers that
# check which path ran).
launches = 0

MAX_HEAD_DIM = 256   # one thread per output element of a head
MAX_SEQ_LEN = 8192   # the block keeps one float per position in shared memory


def quantize_kv_for_kernel(k: torch.Tensor, v: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor, int]:
    """[L, B, S, H, hd] float K/V -> (k_int8 [L, B, S, H*hd], k_scale
    [L, B, S, H] bf16, v_int8, v_scale, S): symmetric int8 per (position,
    head), scale amax / 127 (1 where the row is all zero)."""
    l, b, s, h, hd = k.shape

    def quant(x):
        x = x.float()
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        vals = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return (vals.reshape(l, b, s, h * hd),
                scale.reshape(l, b, s, h).to(torch.bfloat16))

    kq, ks = quant(k)
    vq, vs = quant(v)
    return kq, ks, vq, vs, s


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor, num_kv_heads: int,
                  seq_len: int) -> torch.Tensor:
    """One layer's int8 [B, Sp, Dkv] and scales [B, Sp, Hkv] -> float32
    [B, seq_len, Hkv, hd] (the prefill's path)."""
    b, sp, d = values.shape
    x4 = values.reshape(b, sp, num_kv_heads, d // num_kv_heads)
    return (x4.float() * scale[..., None].float())[:, :seq_len]


def cross_attention_int8_reference(q, k_int8, k_scale, v_int8, v_scale,
                                   num_kv_heads: int, seq_len: int,
                                   num_q_heads: int = 0) -> torch.Tensor:
    """Plain version of the kernel, with the TPU kernel body's roundings:
    each product bf16(q) * bf16(K) rounded to bf16 and summed over the head in
    float32; scores times k_scale, then 1/sqrt(hd); softmax over the first
    ``seq_len`` positions in float32; probabilities times v_scale rounded to
    bf16; the sum over positions with V in float32."""
    num_q_heads = num_q_heads or num_kv_heads
    g = num_q_heads // num_kv_heads
    b, _, d = k_int8.shape
    hd = d // num_kv_heads
    bf16, f32 = torch.bfloat16, torch.float32
    kb = k_int8[:, :seq_len].reshape(b, seq_len, num_kv_heads, 1, hd).to(bf16)
    vb = v_int8[:, :seq_len].reshape(b, seq_len, num_kv_heads, 1, hd).to(f32)
    ks = k_scale[:, :seq_len, :, None].to(f32)                 # [B, S, Hkv, 1]
    vs = v_scale[:, :seq_len, :, None].to(f32)
    qb = q.reshape(b, 1, num_kv_heads, g, hd).to(bf16)
    scores = (qb * kb).to(f32).sum(dim=-1)                     # [B, S, Hkv, G]
    scores = scores * ks * torch.tensor(hd ** -0.5, dtype=f32)
    ex = torch.exp(scores - scores.amax(dim=1, keepdim=True))
    probs = ex / ex.sum(dim=1, keepdim=True)
    pw = (probs * vs).to(bf16).to(f32)
    out = (pw[..., None] * vb).sum(dim=1)                      # [B, Hkv, G, hd]
    return out.reshape(b, num_q_heads * hd)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("cross_attention_int8").ws_cross_attention_int8
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def cross_attention_int8(q: torch.Tensor, k_int8: torch.Tensor,
                         k_scale: torch.Tensor, v_int8: torch.Tensor,
                         v_scale: torch.Tensor, num_kv_heads: int,
                         seq_len: int, num_q_heads: int = 0) -> torch.Tensor:
    """Single-query int8 cross-attention, MHA and grouped-query.

    q [B, Dq] float (projected, bias added, not pre-scaled; Dq = num_q_heads
    * hd, head-major, the query heads of one kv head adjacent); k_int8 and
    v_int8 [B, Sp, Dkv] int8; k_scale and v_scale [B, Sp, num_kv_heads] bf16;
    ``seq_len`` <= Sp valid positions, the tail is ignored. Returns [B, Dq]
    float32."""
    global launches
    num_q_heads = num_q_heads or num_kv_heads
    if q.dim() != 2 or k_int8.dim() != 3 or k_int8.shape != v_int8.shape:
        raise ValueError("cross_attention_int8: q must be [B, Dq], K and V "
                         "[B, Sp, Dkv] of one shape")
    b, sp, d = k_int8.shape
    if num_kv_heads < 1 or d % num_kv_heads or num_q_heads % num_kv_heads:
        raise ValueError(f"cross_attention_int8: {num_q_heads} query heads, "
                         f"{num_kv_heads} kv heads and Dkv {d} disagree")
    hd = d // num_kv_heads
    if tuple(q.shape) != (b, num_q_heads * hd):
        raise ValueError(f"cross_attention_int8: q {tuple(q.shape)} is not "
                         f"[{b}, {num_q_heads * hd}]")
    if tuple(k_scale.shape) != (b, sp, num_kv_heads) \
            or k_scale.shape != v_scale.shape:
        raise ValueError(f"cross_attention_int8: scales must be "
                         f"[{b}, {sp}, {num_kv_heads}]")
    if not 1 <= seq_len <= sp:
        raise ValueError(f"cross_attention_int8: seq_len {seq_len} outside "
                         f"[1, {sp}]")
    if k_int8.dtype != torch.int8 or v_int8.dtype != torch.int8 \
            or k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
        raise TypeError("cross_attention_int8: K/V must be int8 with bf16 scales")
    tensors = (q, k_int8, k_scale, v_int8, v_scale)
    if any(t.device != q.device for t in tensors):
        raise ValueError("cross_attention_int8: inputs must be on one device")
    if q.device.type == "cpu":
        return cross_attention_int8_reference(
            q, k_int8, k_scale, v_int8, v_scale, num_kv_heads, seq_len,
            num_q_heads)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int8: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("cross_attention_int8: K/V and scales must be "
                         "contiguous")
    if hd > MAX_HEAD_DIM or seq_len > MAX_SEQ_LEN:
        raise ValueError(f"cross_attention_int8 kernel: head_dim {hd} > "
                         f"{MAX_HEAD_DIM} or seq_len {seq_len} > {MAX_SEQ_LEN}")
    q = q.float().contiguous()
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k_int8.data_ptr(), k_scale.data_ptr(),
                    v_int8.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                    b, sp, int(seq_len), num_kv_heads,
                    num_q_heads // num_kv_heads, hd, hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_attention_int8 kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out
