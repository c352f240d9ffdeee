"""The launch plan of the w8a16 / w4a16 kernels (whisperseg_torch/ops/quant.py
``qdot_plan``) and the C entry points it feeds (csrc/qdot.cu). The kernels
need the card; what is checked here is the geometry they are given: the
pieces of K and the column tiles partition the product, the cluster and
shared memory stay within the H100's limits, the base model's decode
products fill the card, and the ctypes signatures match the C source."""

import os
import re

import numpy as np
import pytest

from whisperseg_torch.ops import _build
from whisperseg_torch.ops import quant as tq

# every projection of every model size (d_model 384 to 1280, d_ff = 4
# d_model) and out = 640, as chip_smoke.py checks them on the card
QUANT_SHAPES = [s for d in (384, 512, 768, 1024, 1280)
                for s in ((d, d), (d, 4 * d), (4 * d, d))] + [(512, 640)]
ROWS = (1, 16, 48, 512)  # one row, a decode step, the prefill, the limit
# (M, K, out) the kernels take and no model has
PORT_ONLY_SHAPES = [(5, 384, 96), (2, 100, 40), (1, 64, 6), (7, 130, 33)]
# K = 384 with groups of 128: the two nibbles of a w4a16 byte fall in
# different phases of their groups, and 8 pieces of 24 byte rows cut groups
CASES = ([((k, n), ROWS) for k, n in QUANT_SHAPES]
         + [((k, n), (m,)) for m, k, n in PORT_ONLY_SHAPES + [(16, 384, 128)]])
# the base model's decoder products: q, k, v, o, xq, xo; fc1; fc2
BASE_DECODE = [(512, 512), (512, 2048), (2048, 512)]


def pieces_of(plan, k, bits):
    """Contraction rows of each piece, in piece order."""
    rows = k if bits == 8 else k // 2
    out = []
    for p in range(plan.pieces):
        storage = np.arange(p * plan.k_slice, min((p + 1) * plan.k_slice, rows))
        out.append(storage if bits == 8 else np.concatenate([storage, rows + storage]))
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn,rows", CASES, ids=[f"{k}x{n}" for (k, n), _ in CASES])
def test_plan_partitions_the_product(bits, kn, rows):
    k, n = kn
    for m in rows:
        plan = tq.qdot_plan(m, k, n, bits)
        # K: pieces of whole k16 steps; every contraction row (for w4a16,
        # both nibbles of every byte row) in exactly one piece, none empty
        assert plan.k_slice % (16 if bits == 8 else 8) == 0
        assert (plan.k_slice if bits == 8 else 2 * plan.k_slice) <= tq.MAX_PIECE_ROWS
        pieces = pieces_of(plan, k, bits)
        assert all(len(rows_) for rows_ in pieces)
        assert np.array_equal(np.sort(np.concatenate(pieces)), np.arange(k))
        # the cluster's blocks take pieces r, r + cluster, ...: each piece
        # one block, each block at least one piece; up to 64 rows of x and
        # K = 5120 just one, so that every weight byte is read once per
        # launch; above 64 rows pieces of 64 contraction rows
        assert 1 <= plan.cluster <= tq.MAX_CLUSTER
        owner = [p % plan.cluster for p in range(plan.pieces)]
        assert sorted(set(owner)) == list(range(plan.cluster))
        if k <= 5120 and m <= tq.MAX_CHUNK_ROWS:
            assert plan.pieces == plan.cluster
        if m > tq.MAX_CHUNK_ROWS:
            assert plan.k_slice * (1 if bits == 8 else 2) == min(
                tq.LARGE_M_PIECE_ROWS, 16 * -(-k // 16))
        # N: column tiles, none empty, covering [0, n)
        assert tq.TILE_N == 64
        assert (plan.n_tiles - 1) * tq.TILE_N < n <= plan.n_tiles * tq.TILE_N
        assert plan.blocks == plan.n_tiles * plan.cluster * plan.chunks
        # M: chunks of whole m16 tiles, at most 64 rows, no wider than
        # needed, one cluster each, none empty, covering [0, m)
        assert plan.m_chunk % 16 == 0 and 16 <= plan.m_chunk <= tq.MAX_CHUNK_ROWS
        assert plan.m_chunk <= 16 * -(-m // 16)
        assert (plan.chunks - 1) * plan.m_chunk < m <= plan.chunks * plan.m_chunk
        # shared memory: within the H100's 227 KB a block, and room for the
        # bf16 piece, the bf16 x chunk and the piece as stored (two of each
        # where a block walks several pieces) and the float32 partial tile
        kr = plan.k_slice * (1 if bits == 8 else 2)
        buffers = 2 if plan.pieces > plan.cluster else 1
        least = (2 * kr * tq.TILE_N + buffers * (2 * plan.m_chunk * kr
                                                 + plan.k_slice * tq.TILE_N)
                 + 4 * plan.m_chunk * tq.TILE_N)
        assert least <= plan.smem_bytes <= tq.MAX_SMEM_BYTES == 232448


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [16, 48])
def test_base_decode_products_fill_the_card(bits, m):
    """At least 64 blocks a launch at the decode step's and the prefill's
    rows (a block a tile of 8 rows x 128 columns launched 8 to 32)."""
    for k, n in BASE_DECODE:
        plan = tq.qdot_plan(m, k, n, bits)
        assert plan.blocks >= 64, (k, n, plan)
        assert plan.cluster == tq.MAX_CLUSTER


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tq.qdot_plan(16, 512, 512, 2)
    with pytest.raises(ValueError, match="even contraction dim"):
        tq.qdot_plan(16, 511, 512, 4)
    with pytest.raises(ValueError, match="empty product"):
        tq.qdot_plan(0, 512, 512, 8)


def c_signature(name):
    """(type, name) of each parameter of ``extern "C" int <name>(...)`` in
    csrc/qdot.cu."""
    with open(os.path.join(_build.CSRC, "qdot.cu")) as f:
        text = f.read()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
    out = []
    for param in params.split(","):
        words = param.replace("*", " * ").split()
        out.append((" ".join(words[:-1]), words[-1]))
    return out


@pytest.mark.parametrize("name,argtypes", [
    ("ws_qdot_w8a16", tq.W8A16_ARGTYPES), ("ws_qdot_w4a16", tq.W4A16_ARGTYPES)])
def test_entry_points_take_the_plan(name, argtypes):
    """The ctypes argument types the wrappers set match the C parameters,
    pointers and the stream as void pointers, and the C parameters after
    (m, k, n[, groups]) are the plan's launch fields in their order."""
    import ctypes

    params = c_signature(name)
    want = [ctypes.c_void_p if ("*" in t or t == "cudaStream_t") else ctypes.c_int
            for t, _ in params]
    assert [t for t, _ in params if "*" not in t and t != "cudaStream_t"] == \
        ["int"] * sum(w is ctypes.c_int for w in want)
    assert argtypes == want
    names = [n for _, n in params]
    first = names.index("n") + 1 + (name == "ws_qdot_w4a16")
    assert tuple(names[first:first + len(tq.QdotPlan.LAUNCH_FIELDS)]) == \
        tq.QdotPlan.LAUNCH_FIELDS
    assert names[-1] == "stream"
    plan = tq.qdot_plan(16, 512, 512, 8)
    assert len(plan.launch_args()) == len(tq.QdotPlan.LAUNCH_FIELDS)

