"""Int8 and packed-int4 weight quantization for inference (kernels
``csrc/qdot.cu``) and for quantization-aware training.

The port of ``whisperseg_tpu/ops/quant.py``: ``QuantTensor`` /
``Quant4Tensor``, ``quantize`` / ``quantize4`` / ``unpack4``,
``quantize_params``, the products ``qdot`` / ``qdot4``, and the
quantization-aware training of ``ste_quant8`` / ``ste_quant4`` /
``fake_quantize_params``. The quantization
grids are the JAX package's bit for bit (float32 division, round half to
even), so a tree quantized by either package gives the same model.

The products have one set of numerics, those of the JAX package's fused TPU
kernels (``_qdot_pallas_w8a16``, ``_qdot_pallas_w4a16``): x rounded to bf16,
each weight ``bf16(q) * bf16(scale)`` rounded to bf16, products summed in
float32. Routing of ``qdot`` / ``qdot4``:

  * a tensor on the CPU: the plain version;
  * a CUDA tensor with at most ``MAX_KERNEL_ROWS`` rows (the decode step and
    the prefill): the CUDA kernel, launched with the geometry of
    :func:`qdot_plan`, or an error;
  * a CUDA tensor with more rows (encoder layers, cross K/V of a whole
    batch): the weight is dequantized to bf16 with the same rounding and the
    product is one large plain matmul, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from . import _build
from .dot import dot_f32

# Kernel launches made by the wrappers below (read and reset by callers that
# check which path ran).
launches_w8a16 = 0
launches_w4a16 = 0

MAX_KERNEL_ROWS = 512  # the fused kernels serve small-M products
GROUP_SIZE = 128       # int4 scale group along the contraction dim


class QuantTensor:
    """Per-output-channel symmetric int8 weight: ``values`` int8
    [..., in, out] and ``scale`` float32 [..., 1, out]."""

    def __init__(self, values: torch.Tensor, scale: torch.Tensor):
        self.values = values
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def device(self):
        return self.values.device

    def is_floating_point(self) -> bool:  # storage types are fixed
        return False

    def to(self, device=None, dtype=None) -> "QuantTensor":
        """Move to ``device``; a ``dtype`` is ignored (storage is fixed)."""
        return QuantTensor(self.values.to(device=device),
                           self.scale.to(device=device))

    def __getitem__(self, i) -> "QuantTensor":
        return QuantTensor(self.values[i], self.scale[i])


class Quant4Tensor:
    """Group-wise symmetric int4 weight, two nibbles per int8 byte:
    ``packed`` int8 [..., in/2, out], where byte row i holds original row i in
    its low nibble and row i + in/2 in its high nibble, and ``scale`` float32
    [..., in/group_size, out] (groups run along the contraction dim)."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor):
        self.packed = packed
        self.scale = scale

    @property
    def shape(self):  # logical (unpacked) shape
        s = list(self.packed.shape)
        s[-2] *= 2
        return tuple(s)

    @property
    def device(self):
        return self.packed.device

    def is_floating_point(self) -> bool:
        return False

    def to(self, device=None, dtype=None) -> "Quant4Tensor":
        return Quant4Tensor(self.packed.to(device=device),
                            self.scale.to(device=device))

    def __getitem__(self, i) -> "Quant4Tensor":
        return Quant4Tensor(self.packed[i], self.scale[i])


# ------------------------------------------------------------ quantization


def quantize(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel int8: amax over the ``in`` dim (axis -2),
    one scale per output column."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    values = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return QuantTensor(values, scale)


def quantize4(w: torch.Tensor, group_size: int = GROUP_SIZE) -> Quant4Tensor:
    """Symmetric group-wise int4 along the contraction dim, range [-7, 7]
    (-8 unused, so dequantization is a pure scale). One group when the dim
    does not divide by ``group_size`` (small test models)."""
    w = w.float()
    k, out = w.shape[-2:]
    if k % 2:
        raise ValueError("int4 packing needs an even contraction dim")
    gs = group_size if k % group_size == 0 else k
    groups = k // gs
    batch = w.shape[:-2]
    wg = w.reshape(*batch, groups, gs, out)
    scale = wg.abs().amax(dim=-2, keepdim=True) / 7.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wg / safe), -7, 7).to(torch.int8)
    q = q.reshape(*batch, k, out)
    lo, hi = q[..., :k // 2, :], q[..., k // 2:, :]
    packed = (hi * 16 + (lo & 15)).to(torch.int8)
    return Quant4Tensor(packed, scale.reshape(*batch, groups, out))


def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., in/2, out] -> int8 [..., in, out] in [-8, 7]."""
    hi = packed >> 4                      # arithmetic shift: floor(p / 16)
    lo_u = packed & 15
    lo = lo_u - 16 * (lo_u > 7).to(torch.int8)
    return torch.cat([lo, hi], dim=-2)


def unpack4(qt: Quant4Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize to a dense [..., in, out] tensor of ``dtype``; the product
    of nibble and scale is taken, and so rounded, in ``dtype``."""
    q = _nibbles(qt.packed)
    k, out = q.shape[-2:]
    groups = qt.scale.shape[-2]
    batch = q.shape[:-2]
    w = q.to(dtype).reshape(*batch, groups, k // groups, out)
    w = w * qt.scale.reshape(*batch, groups, 1, out).to(dtype)
    return w.reshape(*batch, k, out)


def dequantize(w, dtype: torch.dtype) -> torch.Tensor:
    """A quantized or plain weight as a dense tensor of ``dtype`` (the
    nibble- or int8-times-scale product rounded in ``dtype``)."""
    if isinstance(w, QuantTensor):
        return w.values.to(dtype) * w.scale.to(dtype)
    if isinstance(w, Quant4Tensor):
        return unpack4(w, dtype)
    return w.to(dtype)


QUANT_LEAF_NAMES = frozenset({
    "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
    "xq_w", "xk_w", "xv_w", "xo_w",
})


def _map_leaves(params: dict, leaf_fn: Callable) -> dict:
    return {k: _map_leaves(v, leaf_fn) if isinstance(v, dict) else leaf_fn(k, v)
            for k, v in params.items()}


def quantize_params(params: dict, bits: int = 8) -> dict:
    """Quantize the ten projection weights of every layer (per-channel int8
    or group-wise packed int4). Embeddings, convolutions, positions, norms,
    biases and the frame head keep their floating type."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    fn = quantize if bits == 8 else quantize4
    return _map_leaves(
        params, lambda k, v: fn(v) if k in QUANT_LEAF_NAMES else v)


# ----------------------------------------------- quantization-aware training
#
# Fake quantization with a straight-through estimator: the forward sees the
# dequantized grid the quantized inference path uses (the same ``quantize`` /
# ``quantize4``), the backward passes the gradient through unchanged. The
# master weights stay float32 for the optimizer.


def fake_grid(w: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``w`` on its per-channel int8 (``bits`` 8) or group-wise
    int4 (4) grid: the values the quantized inference path computes with."""
    if bits == 8:
        qt = quantize(w)
        return qt.values.float() * qt.scale
    return unpack4(quantize4(w), torch.float32)


class _SteTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, target):
        return target.view_as(target)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_to(w: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``target``'s values with ``w``'s gradient passed straight through."""
    return _SteTo.apply(w, target)


def ste_quant8(w: torch.Tensor) -> torch.Tensor:
    """float32 ``w`` on its per-channel int8 grid; identity gradient."""
    return ste_to(w, fake_grid(w.detach(), 8))


def ste_quant4(w: torch.Tensor) -> torch.Tensor:
    """float32 ``w`` on its group-wise int4 grid; identity gradient."""
    return ste_to(w, fake_grid(w.detach(), 4))


def fake_quantize_params(params: dict, bits: int) -> dict:
    """The tree with every leaf that :func:`quantize_params` quantizes put
    on its ``bits`` grid by the straight-through estimator; the other
    leaves are the same tensors."""
    ste = {8: ste_quant8, 4: ste_quant4}[bits]
    return _map_leaves(
        params, lambda k, v: ste(v) if k in QUANT_LEAF_NAMES else v)


def cast_float_leaves(params: dict, dtype: torch.dtype) -> dict:
    """Cast plain floating leaves to ``dtype``; quantized leaves (int8 +
    float32 scales) stay as they are."""
    return _map_leaves(
        params, lambda _, v: v.to(dtype=dtype) if v.is_floating_point() else v)


# ---------------------------------------------------------------- products


def qdot_w8a16_reference(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Plain version of the w8a16 kernel: x [..., in] and a 2-D QuantTensor
    -> float32 [..., out]. Products of two bf16 values are exact in float32,
    so widening both operands and multiplying in float32 is the kernel's
    arithmetic up to the order of the sum."""
    w = dequantize(qt, torch.bfloat16)
    return x.to(torch.bfloat16).float() @ w.float()


def qdot_w4a16_reference(x: torch.Tensor, qt: Quant4Tensor) -> torch.Tensor:
    """Plain version of the w4a16 kernel (see :func:`qdot_w8a16_reference`)."""
    w = unpack4(qt, torch.bfloat16)
    return x.to(torch.bfloat16).float() @ w.float()


# Launch geometry of the kernels (csrc/qdot.cu checks a plan against the same
# limits and refuses one outside them).
TILE_N = 64               # output columns of a block
MAX_CLUSTER = 8           # blocks of a thread-block cluster: the portable size
MAX_PIECE_ROWS = 640      # contraction rows of one block's piece of K
MAX_CHUNK_ROWS = 64       # rows of x a block multiplies at a time
MAX_SMEM_BYTES = 232448   # shared memory a block may have on the H100
# Above MAX_CHUNK_ROWS rows: pieces of LARGE_M_PIECE_ROWS contraction rows,
# and the smallest cluster that launches at least LARGE_M_BLOCKS blocks
# (about 3 a streaming multiprocessor of the H100's 132): the fastest plans
# of a sweep at M 512 (chip_qdot_times.py --sweep, PERF.md).
LARGE_M_PIECE_ROWS = 64
LARGE_M_BLOCKS = 384


class QdotPlan(NamedTuple):
    """Geometry of one w8a16 / w4a16 launch. The grid is ``n_tiles`` x
    ``cluster`` x ``chunks`` blocks: a cluster per tile of ``TILE_N`` output
    columns and chunk of ``m_chunk`` rows of x. The blocks of a cluster split
    the contraction: piece ``p`` is weight storage rows
    ``[p * k_slice, (p + 1) * k_slice)`` (w4a16: byte rows, each holding
    contraction rows ``i`` and ``i + K/2``), block ``r`` of a cluster takes
    pieces ``r, r + cluster, ...`` and adds its partial tile to its
    cluster's in rank order. ``smem_bytes`` is the dynamic shared memory a
    block takes."""
    k_slice: int
    cluster: int
    m_chunk: int
    smem_bytes: int
    n_tiles: int
    pieces: int
    chunks: int

    # the fields the C entry points take, in their order
    LAUNCH_FIELDS = ("k_slice", "cluster", "m_chunk")

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.cluster * self.chunks

    def launch_args(self) -> tuple:
        return tuple(getattr(self, f) for f in self.LAUNCH_FIELDS)


def _smem_bytes(rows: int, k_slice: int, m_chunk: int, buffers: int) -> int:
    """Dynamic shared memory of a block (the layout of csrc/qdot.cu): the
    bf16 piece; ``buffers`` bf16 x chunks with rows padded by 16 bytes and
    as many pieces as stored (2 where a block has more than one piece); the
    float32 partial tile; ``rows`` contraction rows a piece."""
    ld = TILE_N + 8
    return (2 * rows * ld + buffers * (2 * m_chunk * (rows + 8) + k_slice * TILE_N)
            + 4 * m_chunk * ld)


@functools.lru_cache(maxsize=None)
def qdot_plan(m: int, k: int, n: int, bits: int) -> QdotPlan:
    """The launch geometry of the w8a16 (``bits`` 8) or w4a16 (4) kernel for
    x [m, k] and a weight [k, n]. x is cut into chunks of up to 64 rows, one
    cluster each. Up to ``MAX_CHUNK_ROWS`` rows (the decode step, the
    prefill) K is cut into at most 8 pieces of whole k16 steps, one a block
    of the cluster, as long as a piece stays within ``MAX_PIECE_ROWS`` (up
    to K = 5120), so that each weight byte is read once a launch. Above it,
    where the chunks fill the card, K is cut into pieces of
    ``LARGE_M_PIECE_ROWS`` contraction rows that the cluster's blocks walk.
    Chunks are smaller where shared memory would not hold them."""
    if bits == 8:
        rows, per = k, 1
    elif bits == 4:
        if k % 2:
            raise ValueError("w4a16 needs an even contraction dim")
        rows, per = k // 2, 2
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if min(m, k, n) <= 0:
        raise ValueError(f"qdot_plan: empty product {(m, k, n)}")
    unit = 16 // per  # storage rows of one k16 step
    n_tiles = -(-n // TILE_N)
    m_chunk = min(MAX_CHUNK_ROWS, 16 * -(-m // 16))
    while True:
        chunks = -(-m // m_chunk)
        if m <= MAX_CHUNK_ROWS:
            k_slice = min(unit * -(-rows // (MAX_CLUSTER * unit)),
                          MAX_PIECE_ROWS // per)
            pieces = -(-rows // k_slice)
            cluster = min(MAX_CLUSTER, pieces)
        else:
            k_slice = min(LARGE_M_PIECE_ROWS // per, unit * -(-rows // unit))
            pieces = -(-rows // k_slice)
            cluster = next((c for c in range(1, MAX_CLUSTER) if c <= pieces and
                            n_tiles * c * chunks >= LARGE_M_BLOCKS),
                           min(MAX_CLUSTER, pieces))
        buffers = 2 if pieces > cluster else 1
        smem = _smem_bytes(per * k_slice, k_slice, m_chunk, buffers)
        if smem <= MAX_SMEM_BYTES or m_chunk == 16:
            break
        m_chunk -= 16
    return QdotPlan(k_slice, cluster, m_chunk, smem, n_tiles, pieces, chunks)


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_PLAN_ARGTYPES = [_I32] * len(QdotPlan.LAUNCH_FIELDS)
# x, x_is_bf16, weight, scale, y, m, k, n, [groups,] the plan, stream
W8A16_ARGTYPES = [_PTR, _I32, _PTR, _PTR, _PTR, _I32, _I32, _I32,
                  *_PLAN_ARGTYPES, _PTR]
W4A16_ARGTYPES = [_PTR, _I32, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                  *_PLAN_ARGTYPES, _PTR]


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.library("qdot")
    w8, w4 = lib.ws_qdot_w8a16, lib.ws_qdot_w4a16
    w8.argtypes, w4.argtypes = W8A16_ARGTYPES, W4A16_ARGTYPES
    w8.restype = w4.restype = _I32
    return w8, w4


def _kernel_operands(x: torch.Tensor, k: int, storage: torch.Tensor,
                     scale: torch.Tensor):
    """Checks shared by both kernels' wrappers; returns x as the kernel
    reads it ([M, k], contiguous float32 or bfloat16; the kernel rounds to
    bf16; bfloat16 above ``MAX_CHUNK_ROWS`` rows)."""
    if x.shape[-1] != k:
        raise ValueError(f"qdot: x {tuple(x.shape)} does not contract with a "
                         f"weight of {k} rows")
    x2 = x.reshape(-1, k)
    if storage.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("qdot: weight storage must be int8 with float32 scales")
    if not (storage.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qdot: weight storage and scales must be contiguous")
    if not (x2.device == storage.device == scale.device):
        raise ValueError("qdot: x and the weight must be on one device")
    if not 1 <= x2.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"qdot kernel: {x2.shape[0]} rows outside "
                         f"[1, {MAX_KERNEL_ROWS}]")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    if x2.shape[0] > MAX_CHUNK_ROWS:
        # several chunks of x, each read by every column tile's cluster: x
        # is rounded to bf16 once here (the kernel's own first rounding), so
        # that the kernel streams half the bytes, by cp.async
        x2 = x2.to(torch.bfloat16)
    return x2.contiguous()


def qdot_w8a16_kernel(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """The w8a16 CUDA kernel on CUDA tensors: x [..., in] with at most
    ``MAX_KERNEL_ROWS`` rows, a 2-D QuantTensor of any in and out ->
    float32 [..., out]."""
    global launches_w8a16
    k, out = qt.values.shape
    x2 = _kernel_operands(x, k, qt.values, qt.scale)
    if x2.device.type != "cuda":
        raise ValueError(f"qdot kernel: unsupported device {x2.device}")
    if tuple(qt.scale.shape) != (1, out):
        raise ValueError(f"qdot: scale {tuple(qt.scale.shape)} is not [1, {out}]")
    m = x2.shape[0]
    y = torch.empty((m, out), dtype=torch.float32, device=x2.device)
    err = _kernels()[0](x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                        qt.values.data_ptr(), qt.scale.data_ptr(), y.data_ptr(),
                        m, k, out, *qdot_plan(m, k, out, 8).launch_args(),
                        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: CUDA error {err}")
    with _build.count_lock:
        launches_w8a16 += 1
    return y.reshape(*x.shape[:-1], out)


def qdot_w4a16_kernel(x: torch.Tensor, qt: Quant4Tensor) -> torch.Tensor:
    """The w4a16 CUDA kernel on CUDA tensors: x [..., in] with at most
    ``MAX_KERNEL_ROWS`` rows, a 2-D Quant4Tensor of any even in (its groups
    dividing in) and any out -> float32 [..., out]."""
    global launches_w4a16
    k_half, out = qt.packed.shape
    k = 2 * k_half
    x2 = _kernel_operands(x, k, qt.packed, qt.scale)
    if x2.device.type != "cuda":
        raise ValueError(f"qdot4 kernel: unsupported device {x2.device}")
    groups = qt.scale.shape[0]
    if qt.scale.dim() != 2 or qt.scale.shape[1] != out or k % groups:
        raise ValueError(f"qdot4: scale {tuple(qt.scale.shape)} does not "
                         f"group a [{k}, {out}] weight")
    m = x2.shape[0]
    y = torch.empty((m, out), dtype=torch.float32, device=x2.device)
    err = _kernels()[1](x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                        qt.packed.data_ptr(), qt.scale.data_ptr(), y.data_ptr(),
                        m, k, out, groups, *qdot_plan(m, k, out, 4).launch_args(),
                        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a16 kernel launch failed: CUDA error {err}")
    with _build.count_lock:
        launches_w4a16 += 1
    return y.reshape(*x.shape[:-1], out)


def _route(x: torch.Tensor, qt, storage: torch.Tensor, reference, kernel):
    if storage.dim() != 2:
        raise ValueError("qdot takes one layer's 2-D weight: index the "
                         "stacked leaf first")
    if x.device != storage.device:
        raise ValueError("qdot: x and the weight must be on one device")
    if x.shape[-1] != qt.shape[-2]:
        raise ValueError(f"qdot: x {tuple(x.shape)} does not contract with a "
                         f"weight of {qt.shape[-2]} rows")
    if x.device.type == "cpu":
        return reference(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"qdot: unsupported device {x.device}")
    if x.numel() // x.shape[-1] <= MAX_KERNEL_ROWS:
        return kernel(x, qt)
    return dot_f32(x, dequantize(qt, torch.bfloat16), torch.bfloat16)


def qdot4(x: torch.Tensor, qt: Quant4Tensor) -> torch.Tensor:
    """x [..., in] @ Quant4Tensor [in, out] -> float32 [..., out] (w4a16)."""
    return _route(x, qt, qt.packed, qdot_w4a16_reference, qdot_w4a16_kernel)


def qdot_w8a8(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """Dynamic per-row int8 activation quantization times int8 weights,
    rescaled in float32. Experimental in the JAX package too, where no call
    site uses it; plain tensor code, no kernel. The integer products are
    summed in float64, which holds them exactly."""
    if qt.values.dim() != 2:
        raise ValueError("qdot takes one layer's 2-D weight: index the "
                         "stacked leaf first")
    x = x.float()
    row_amax = x.abs().amax(dim=-1, keepdim=True)
    row_scale = torch.where(row_amax > 0, row_amax / 127.0,
                            torch.ones_like(row_amax))
    xq = torch.clamp(torch.round(x / row_scale), -127, 127)
    acc = (xq.double() @ qt.values.double()).float()
    return acc * row_scale * qt.scale[0]


def qdot(x: torch.Tensor, qt, mode: str = "w8a16") -> torch.Tensor:
    """x [..., in] @ quantized weight [in, out] -> float32 [..., out].

    ``mode="w8a16"`` (default): weight-only quantization, see the module
    note. ``mode="w8a8"``: :func:`qdot_w8a8`. Int4 weights take only the
    default mode (w4a16)."""
    if isinstance(qt, Quant4Tensor):
        if mode != "w8a16":
            raise ValueError(f"mode={mode!r} is not supported for int4 "
                             f"(Quant4Tensor) weights; only the default "
                             f"weight-only path (w4a16) exists")
        return qdot4(x, qt)
    if mode == "w8a8":
        return qdot_w8a8(x, qt)
    if mode != "w8a16":
        raise ValueError(f"unknown qdot mode {mode!r}")
    return _route(x, qt, qt.values, qdot_w8a16_reference, qdot_w8a16_kernel)
