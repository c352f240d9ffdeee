"""The port's int8 cross-attention (whisperseg_torch/ops/cross_attention.py)
against the JAX package's: the int8 K/V state bit for bit, and the plain
version of the kernel against the interpreted Pallas kernel, against exact
attention, and under a poisoned padded tail. Also the plain model of the
kernel's walk (positions split across a thread-block cluster) against the
same references, and the launch plan against the C entry point
(csrc/cross_attention_int8.cu)."""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.ops import cross_attention as jca
from whisperseg_torch.ops import _build
from whisperseg_torch.ops import cross_attention as tca


def exact_attention(q, k, v):
    """q [B, H*hd]; k, v [B, S, Hkv, hd] float -> [B, H*hd] in float64, the
    query heads of one kv head adjacent (GQA when H > Hkv)."""
    b, s, hkv, hd = k.shape
    g = q.shape[1] // (hkv * hd)
    qh = q.reshape(b, hkv, g, hd).astype(np.float64)
    scores = np.einsum("bkgd,bskd->bkgs", qh * hd ** -0.5, k.astype(np.float64))
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return np.einsum("bkgs,bskd->bkgd", probs, v.astype(np.float64)).reshape(b, -1)


def make_case(seed, b, s, hkv, g, hd, scale=0.5):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv * g * hd).astype(np.float32)
    k = rng.randn(1, b, s, hkv, hd).astype(np.float32) * scale
    v = rng.randn(1, b, s, hkv, hd).astype(np.float32) * scale
    return q, k, v


def bits(t):
    """bf16 tensor or array -> its float32 widening as numpy."""
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 3, 50, 4, 16), (1, 2, 500, 6, 64)])
def test_int8_kv_state_identical_to_jax(shape):
    """Same int8 values and bf16 scales; the JAX package pads S to a multiple
    of 8 and the heads to 128 lanes, the port does not."""
    rng = np.random.RandomState(0)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32) * 3
    k[0, 0, 1] = 0.0  # all-zero rows take scale 1
    l, b, s, h, hd = shape
    jkq, jks, jvq, jvs, jseq = jca.quantize_kv_for_kernel(
        jnp.asarray(k), jnp.asarray(v), h)
    kq, ks, vq, vs, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                     torch.from_numpy(v))
    assert seq == jseq == s
    assert kq.shape == (l, b, s, h * hd) and ks.shape == (l, b, s, h)
    assert kq.dtype == torch.int8 and ks.dtype == torch.bfloat16
    for got, want in ((kq, jkq), (vq, jvq)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :, :s])
    for got, want in ((ks, jks), (vs, jvs)):
        np.testing.assert_array_equal(bits(got), bits(want)[:, :, :s, :h])
    assert bits(ks)[0, 0, 1, 0] == 1.0
    # bf16 K/V, as the model hands them over, quantize to the same state
    kq2, ks2, _, _, _ = tca.quantize_kv_for_kernel(
        torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v))
    jkq2, jks2, _, _, _ = jca.quantize_kv_for_kernel(
        jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v), h)
    np.testing.assert_array_equal(kq2.numpy(), np.asarray(jkq2)[:, :, :s])
    np.testing.assert_array_equal(bits(ks2), bits(jks2)[:, :, :s, :h])


# b, s, kv heads, group size, head_dim: the JAX package's own three cases
# (MHA 20 heads at S = 500, MHA 4 heads, GQA 2 x 2) and the tiny model's 6
CASES = [(2, 500, 20, 1, 64), (3, 100, 4, 1, 64), (2, 96, 2, 2, 64),
         (2, 500, 6, 1, 64)]


def pallas_and_port_state(b, s, hkv, g, hd):
    """(q, K, V, the interpreted Pallas kernel's output, the port's int8
    K/V state) of one case."""
    q, k, v = make_case(0, b, s, hkv, g, hd)
    jkq, jks, jvq, jvs, seq = jca.quantize_kv_for_kernel(
        jnp.asarray(k), jnp.asarray(v), hkv)
    with jax_kernel_path() as traced:
        pallas = np.asarray(jca.cross_attention_int8(
            jnp.asarray(q), jkq[0], jks[0], jvq[0], jvs[0], hkv, seq,
            num_q_heads=hkv * g))
    assert traced == ["cross_attention.py"]
    kq, ks, vq, vs, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                     torch.from_numpy(v))
    return q, k, v, pallas, (kq[0], ks[0], vq[0], vs[0], hkv, seq)


@pytest.mark.parametrize("b,s,hkv,g,hd", CASES)
def test_plain_version_against_pallas_and_exact(b, s, hkv, g, hd):
    q, k, v, pallas, state = pallas_and_port_state(b, s, hkv, g, hd)
    got = tca.cross_attention_int8(torch.from_numpy(q), *state,
                                   num_q_heads=hkv * g).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    want = exact_attention(q, k[0], v[0])
    top = np.abs(want).max()
    # the same roundings in another order of summation: a weight that lands
    # on the other side of a bf16 tie moves its term (up to 127 times the
    # weight) by 2^-9; a few such flips came to 1.6e-4 of the largest output
    assert np.abs(got - pallas).max() < 1e-3 * top, np.abs(got - pallas).max() / top
    # the JAX package's tolerance for int8 K/V against exact attention
    assert np.abs(got - want).max() < 0.02 * top, np.abs(got - want).max() / top


# the existing cases under their launch plans, a seq_len that is not a
# multiple of the positions a block (301 = 3 x 76 + 73), and seq_lens below
# the cluster size (blocks with no position at all); (cluster, per_block)
# None takes the plan's
WALK_CASES = ([(case, None) for case in CASES]
              + [((2, 301, 4, 1, 64), None), ((2, 301, 2, 2, 64), (8, 38)),
                 ((2, 5, 4, 2, 64), (8, 1)), ((3, 3, 4, 1, 64), (4, 3)),
                 ((2, 6, 2, 1, 64), (8, 2))])


@pytest.mark.parametrize("case,split", WALK_CASES,
                         ids=[f"{c}-{s}" for c, s in WALK_CASES])
def test_kernel_walk_against_pallas_and_exact(case, split):
    """The plain model of the kernel's walk: the global max and sum taken
    before the bf16 rounding of the weights, the blocks' sums and partial
    outputs merged in rank order. The tolerances of the plain version's
    test; against the plain version it differs only in the order of float32
    sums."""
    b, s, hkv, g, hd = case
    q, k, v, pallas, state = pallas_and_port_state(b, s, hkv, g, hd)
    if split is None:
        plan = tca.cross_attention_plan(b, s, hkv, g, hd)
        split = (plan.cluster, plan.per_block)
    cluster, per_block = split
    assert (cluster - 1) * per_block < s <= cluster * per_block or s < cluster
    got = tca.cross_attention_int8_walk(
        torch.from_numpy(q), *state, num_q_heads=hkv * g, cluster=cluster,
        per_block=per_block).numpy()
    plain = tca.cross_attention_int8_reference(
        torch.from_numpy(q), *state, num_q_heads=hkv * g).numpy()
    want = exact_attention(q, k[0], v[0])
    top = np.abs(want).max()
    assert got.dtype == np.float32 and got.shape == q.shape
    assert np.abs(got - pallas).max() < 1e-3 * top, np.abs(got - pallas).max() / top
    assert np.abs(got - want).max() < 0.02 * top, np.abs(got - want).max() / top
    assert np.abs(got - plain).max() < 1e-3 * top, np.abs(got - plain).max() / top


def test_kernel_walk_rounds_after_the_global_normalisation():
    """A merge of partials normalised by local maxima (flash decoding) rounds
    each weight at another point; the walk must not: with one block's
    scores far above the other's, its weights are those of the plain
    version bit for bit."""
    q, k, v = make_case(4, 1, 64, 2, 1, 64)
    k[0, 0, 32:] *= 4.0  # the second block's scores dominate
    kq, ks, vq, vs, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                     torch.from_numpy(v))
    args = (torch.from_numpy(q), kq[0], ks[0], vq[0], vs[0], 2, seq)
    plain = tca.cross_attention_int8_reference(*args)
    walk = tca.cross_attention_int8_walk(*args, cluster=2, per_block=32)
    # the same weights, two partial sums over positions instead of one
    assert (walk - plain).abs().max() <= 1e-6 * plain.abs().max()


@pytest.mark.parametrize("b,s,hkv,g,hd", [
    (16, 500, 8, 1, 64), (16, 500, 6, 1, 64), (16, 500, 4, 1, 128),
    (16, 500, 2, 4, 64), (1, 500, 8, 1, 64), (16, 301, 8, 1, 64),
    (4, 500, 20, 1, 64), (1, 3, 8, 1, 64), (2, 8192, 1, 8, 256),
    (1, 8192, 1, 20, 64), (64, 1500, 16, 1, 80)])
def test_plan_partitions_the_positions(b, s, hkv, g, hd):
    """Every position below seq_len in exactly one block, blocks in rank
    order of their positions, the cluster within the portable 8 and a
    block's shared memory within the H100's 232,448 bytes."""
    plan = tca.cross_attention_plan(b, s, hkv, g, hd)
    assert 1 <= plan.cluster <= tca.MAX_CLUSTER == 8
    runs = [range(min(r * plan.per_block, s), min((r + 1) * plan.per_block, s))
            for r in range(plan.cluster)]
    assert [i for run in runs for i in run] == list(range(s))
    assert plan.blocks == b * hkv * plan.cluster
    assert plan.smem_bytes <= tca.MAX_SMEM_BYTES == 232448
    # room for one float a (position, query head) of the block's run
    assert plan.smem_bytes >= 4 * g * plan.per_block
    if b * hkv * plan.cluster < tca.TARGET_BLOCKS:
        assert plan.cluster == tca.MAX_CLUSTER


def test_plan_fills_the_card_at_the_decode_step():
    """At least 512 blocks at the base model's decode step (16 rows = batch
    4 x beam 4, 8 kv heads; one block a (row, kv head) gave 128) and at
    least 32 at one row."""
    assert tca.cross_attention_plan(16, 500, 8, 1, 64).blocks >= 512
    assert tca.cross_attention_plan(1, 500, 8, 1, 64).blocks >= 32
    with pytest.raises(ValueError, match="do not fit"):
        tca.cross_attention_plan(1, 8192, 1, 64, 64)


def test_entry_point_takes_the_plan():
    """The ctypes argument types the wrapper sets match the C parameters of
    ws_cross_attention_int8, and the plan's launch fields come just before
    the stream, in their order."""
    with open(os.path.join(_build.CSRC, "cross_attention_int8.cu")) as f:
        text = f.read()
    params = re.search(r'extern "C" int ws_cross_attention_int8\(([^)]*)\)',
                       text).group(1)
    types, names = [], []
    for param in params.split(","):
        words = param.replace("*", " * ").split()
        types.append(" ".join(words[:-1]))
        names.append(words[-1])
    want = [ctypes.c_void_p if ("*" in t or t == "cudaStream_t")
            else ctypes.c_float if t == "float" else ctypes.c_int
            for t in types]
    assert all(t in ("int", "float") for t in types
               if "*" not in t and t != "cudaStream_t")
    assert tca.ARGTYPES == want
    fields = tca.CrossAttentionPlan.LAUNCH_FIELDS
    assert tuple(names[-1 - len(fields):-1]) == fields
    assert names[-1] == "stream"


def test_padded_tail_is_ignored():
    """Garbage at and beyond seq_len changes nothing (1e-5, the JAX package's
    bound for its kernel; the port never reads the tail)."""
    b, s, h, hd, pad = 1, 12, 4, 64, 4
    q, k, v = make_case(1, b, s, h, 1, hd, scale=1.0)
    kq, ks, vq, vs, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                     torch.from_numpy(v))
    args = [kq[0], ks[0], vq[0], vs[0]]
    clean = tca.cross_attention_int8(torch.from_numpy(q), *args, h, seq)

    def padded(t, fill):
        tail = torch.full((b, pad) + tuple(t.shape[2:]), fill, dtype=t.dtype)
        return torch.cat([t, tail], dim=1)

    poisoned = [padded(kq[0], 127), padded(ks[0], 10.0), padded(vq[0], 127),
                padded(vs[0], 10.0)]
    got = tca.cross_attention_int8(torch.from_numpy(q), *poisoned, h, seq)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), atol=1e-5)
    moved = tca.cross_attention_int8(torch.from_numpy(q), *poisoned, h, seq + pad)
    assert (moved - clean).abs().max() > 1e-2  # the poison bites once unmasked


def test_dequantize_kv_is_the_prefill_path():
    _, k, v = make_case(2, 2, 20, 4, 1, 16)
    kq, ks, _, _, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                   torch.from_numpy(v))
    kd = tca.dequantize_kv(kq[0], ks[0], 4, seq - 3)
    assert kd.shape == (2, 17, 4, 16) and kd.dtype == torch.float32
    want = kq[0].reshape(2, 20, 4, 16).float() * ks[0].float()[..., None]
    assert torch.equal(kd, want[:, :17])
    assert (kd - torch.from_numpy(k[0, :, :17])).abs().max() < 0.02


def test_misuse_raises():
    q, k, v = make_case(3, 2, 16, 4, 1, 16)
    kq, ks, vq, vs, seq = tca.quantize_kv_for_kernel(torch.from_numpy(k),
                                                     torch.from_numpy(v))
    tq = torch.from_numpy(q)
    ok = (tq, kq[0], ks[0], vq[0], vs[0], 4, seq)
    assert tca.cross_attention_int8(*ok).shape == (2, 64)
    with pytest.raises(ValueError, match="seq_len"):
        tca.cross_attention_int8(*ok[:6], seq + 1)
    with pytest.raises(ValueError, match="seq_len"):
        tca.cross_attention_int8(*ok[:6], 0)
    with pytest.raises(ValueError, match="disagree"):
        tca.cross_attention_int8(*ok[:5], 3, seq)
    with pytest.raises(ValueError, match="is not"):
        tca.cross_attention_int8(tq[:, :32], *ok[1:])
    with pytest.raises(ValueError, match="scales must be"):
        tca.cross_attention_int8(tq, kq[0], ks[0][..., :2], vq[0], vs[0], 4, seq)
    with pytest.raises(TypeError, match="int8 with bf16"):
        tca.cross_attention_int8(tq, kq[0], ks[0].float(), vq[0], vs[0], 4, seq)
    assert tca.launches == 0
