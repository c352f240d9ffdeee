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
are never read. The kernel splits the positions of each (row, kv head)
across the blocks of a thread-block cluster (:func:`cross_attention_plan`);
:func:`cross_attention_int8_walk` is the plain model of that walk. On a CUDA
tensor the wrapper launches the kernel or raises; the plain PyTorch version
runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

# Kernel launches made by the wrapper below (read and reset by callers that
# check which path ran).
launches = 0

MAX_HEAD_DIM = 256   # 16 threads a position at most, one 16-byte piece each
MAX_SEQ_LEN = 8192   # a block keeps one float a (position, query head)
MAX_CLUSTER = 8      # the portable thread-block cluster size
MAX_SMEM_BYTES = 232448  # dynamic shared memory a block may use on an H100
TARGET_BLOCKS = 512  # the smallest cluster giving this many blocks is taken
THREADS = 128        # the layout of csrc/cross_attention_int8.cu


class CrossAttentionPlan(NamedTuple):
    """Launch geometry of the kernel: ``cluster`` blocks a (row, kv head),
    each taking ``per_block`` consecutive positions (the last ones fewer, or
    none)."""
    cluster: int
    per_block: int
    smem_bytes: int
    blocks: int

    # the fields the C entry point takes, in its order
    LAUNCH_FIELDS = ("cluster", "per_block")

    def launch_args(self) -> tuple:
        return tuple(getattr(self, f) for f in self.LAUNCH_FIELDS)


def _smem_bytes(groups: int, hd: int, per_block: int, cluster: int) -> int:
    """Dynamic shared memory of a block (the layout of
    csrc/cross_attention_int8.cu): four mbarriers, scores [groups,
    per_block], k_scale [per_block], bf16-rounded q in pairs and the warps'
    partial P V on whole 16-column pieces, the cluster's maxima and sums,
    the cluster's partial outputs [cluster, groups * hd], and room for the
    first pass's V rows as int8 (4 positions a thread, 16-byte aligned)."""
    lanes = 1
    while 16 * lanes < hd:
        lanes *= 2
    cols = 16 * lanes
    first_pass = min(per_block, THREADS // lanes * 4)
    return 4 * (8 + (groups + 1) * per_block + groups * cols // 2
                + (THREADS // 32) * cols + 2 * cluster * groups
                + cluster * groups * hd + 3 + -(-first_pass * hd // 4))


@functools.lru_cache(maxsize=None)
def cross_attention_plan(batch: int, seq_len: int, num_kv_heads: int,
                         groups: int, hd: int) -> CrossAttentionPlan:
    """One cluster per (row, kv head); the smallest cluster (at most 8)
    that gives ``TARGET_BLOCKS`` blocks, larger where a block's scores would
    not fit in shared memory; the positions cut into equal runs."""
    if min(batch, seq_len, num_kv_heads, groups, hd) <= 0:
        raise ValueError("cross_attention_plan: empty attention "
                         f"{(batch, seq_len, num_kv_heads, groups, hd)}")
    clusters = batch * num_kv_heads
    cluster = next((c for c in range(1, MAX_CLUSTER)
                    if clusters * c >= TARGET_BLOCKS), MAX_CLUSTER)
    while True:
        per_block = -(-seq_len // cluster)
        smem = _smem_bytes(groups, hd, per_block, cluster)
        if smem <= MAX_SMEM_BYTES:
            return CrossAttentionPlan(cluster, per_block, smem,
                                      clusters * cluster)
        if cluster == MAX_CLUSTER:
            raise ValueError(f"cross_attention_plan: {seq_len} positions x "
                             f"{groups} query heads a kv head do not fit a "
                             f"cluster's shared memory")
        cluster += 1


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
    return cross_attention_int8_walk(q, k_int8, k_scale, v_int8, v_scale,
                                     num_kv_heads, seq_len, num_q_heads,
                                     cluster=1, per_block=seq_len)


def cross_attention_int8_walk(q, k_int8, k_scale, v_int8, v_scale,
                              num_kv_heads: int, seq_len: int,
                              num_q_heads: int = 0, *, cluster: int,
                              per_block: int) -> torch.Tensor:
    """Plain model of the kernel's walk: the positions cut among ``cluster``
    blocks of ``per_block`` each (the last ones fewer, or none); each
    block's scores and local max; the global max; each block's sum of
    exponentials, added in rank order; weights rounded to bf16 from the
    probability under the global max and sum; each block's partial P V,
    added in rank order. With one block it is the plain version."""
    num_q_heads = num_q_heads or num_kv_heads
    g = num_q_heads // num_kv_heads
    b, _, d = k_int8.shape
    hd = d // num_kv_heads
    bf16, f32 = torch.bfloat16, torch.float32
    qb = q.reshape(b, 1, num_kv_heads, g, hd).to(bf16)
    inv_sqrt = torch.tensor(hd ** -0.5, dtype=f32)
    blocks = []  # (scores [B, n, Hkv, G], V [B, n, Hkv, 1, hd], v_scale)
    for r in range(cluster):
        lo, hi = min(r * per_block, seq_len), min((r + 1) * per_block, seq_len)
        kb = k_int8[:, lo:hi].reshape(b, hi - lo, num_kv_heads, 1, hd).to(bf16)
        scores = (qb * kb).to(f32).sum(dim=-1)
        scores = scores * k_scale[:, lo:hi, :, None].to(f32) * inv_sqrt
        blocks.append((scores,
                       v_int8[:, lo:hi].reshape(b, hi - lo, num_kv_heads, 1,
                                                hd).to(f32),
                       v_scale[:, lo:hi, :, None].to(f32)))
    m = torch.full((b, 1, num_kv_heads, g), float("-inf"), dtype=f32,
                   device=q.device)
    for scores, _, _ in blocks:
        if scores.shape[1]:
            m = torch.maximum(m, scores.amax(dim=1, keepdim=True))
    ex = [torch.exp(scores - m) for scores, _, _ in blocks]
    total = torch.zeros_like(m)
    for e in ex:
        total = total + e.sum(dim=1, keepdim=True)
    out = None
    for e, (_, vb, vs) in zip(ex, blocks):
        pw = (e / total * vs).to(bf16).to(f32)
        part = (pw[..., None] * vb).sum(dim=1)                 # [B, Hkv, G, hd]
        out = part if out is None else out + part
    return out.reshape(b, num_q_heads * hd)


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# q, K, k_scale, V, v_scale, out, batch, sp, seq_len, hkv, groups, hd,
# inv_sqrt, the plan, stream
ARGTYPES = [_PTR] * 6 + [_I32] * 6 + [ctypes.c_float] + \
    [_I32] * len(CrossAttentionPlan.LAUNCH_FIELDS) + [_PTR]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("cross_attention_int8").ws_cross_attention_int8
    fn.argtypes = ARGTYPES
    fn.restype = _I32
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
    groups = num_q_heads // num_kv_heads
    plan = cross_attention_plan(b, int(seq_len), num_kv_heads, groups, hd)
    q = q.float().contiguous()
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k_int8.data_ptr(), k_scale.data_ptr(),
                    v_int8.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
                    b, sp, int(seq_len), num_kv_heads, groups, hd, hd ** -0.5,
                    *plan.launch_args(),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_attention_int8 kernel launch failed: "
                           f"CUDA error {err}")
    with _build.count_lock:
        launches += 1
    return out
