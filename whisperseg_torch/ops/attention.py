"""Head-major non-causal encoder attention (kernel ``csrc/attention.cu``).

The port of ``whisperseg_tpu/ops/attention.py::fused_attention_head_major``:
softmax(q k^T / sqrt(hd)) v per head, keys at or beyond ``valid_len`` masked,
K/V shared by groups of query heads (GQA). On a CUDA tensor the wrapper
launches the kernel or raises; the plain PyTorch version runs only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Kernel launches made by the wrapper below (read and reset by callers that
# check which path ran).
launches = 0

MAX_GROUP = 8  # query heads per K/V head, the JAX kernel's limit


def attention_hm_reference(valid_len: int, q4: torch.Tensor, kt4: torch.Tensor,
                           v4: torch.Tensor) -> torch.Tensor:
    """Plain version of the Pallas kernel body: float32 scores scaled after
    q k^T, keys >= valid_len set to -1e30, p = exp(s - max) rounded to q's
    type, l summed from the rounded p, o = (p v) / l in q's type."""
    b, h, sp, hd = q4.shape
    hkv = v4.shape[1]
    q5 = q4.float().reshape(b, hkv, h // hkv, sp, hd)
    s = torch.einsum("bkgsf,bkft->bkgst", q5, kt4.float()) * (hd ** -0.5)
    keep = torch.arange(sp, device=q4.device) < valid_len
    s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float32,
                                          device=q4.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(q4.dtype).float()
    o = torch.einsum("bkgst,bktf->bkgsf", p, v4.float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.reshape(b, h, sp, hd).to(q4.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("attention").ws_attention_hm
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, i32, ptr]
    fn.restype = i32
    return fn


def fused_attention_head_major(valid_len: int, q4: torch.Tensor,
                               kt4: torch.Tensor, v4: torch.Tensor
                               ) -> torch.Tensor:
    """q4 [B, H, Sp, hd], kt4 [B, Hkv, hd, Sp] (K pre-transposed), v4
    [B, Hkv, Sp, hd]; one type (float32 or bfloat16), contiguous; Sp a
    multiple of 64, hd 64 or 128, H / Hkv <= 8. Returns [B, H, Sp, hd] in q's
    type; rows at or beyond valid_len are computed but meaningless."""
    global launches
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
    if q4.device.type == "cpu":
        return attention_hm_reference(valid_len, q4, kt4, v4)
    if q4.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q4.device}")
    o = torch.empty_like(q4)
    err = _kernel()(q4.data_ptr(), kt4.data_ptr(), v4.data_ptr(), o.data_ptr(),
                    b, h, hkv, sp, hd, int(valid_len), hd ** -0.5,
                    int(q4.dtype == torch.bfloat16),
                    torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o
