"""The port's int8 cross-attention (whisperseg_torch/ops/cross_attention.py)
against the JAX package's: the int8 K/V state bit for bit, and the plain
version of the kernel against the interpreted Pallas kernel, against exact
attention, and under a poisoned padded tail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.ops import cross_attention as jca
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


@pytest.mark.parametrize("b,s,hkv,g,hd", CASES)
def test_plain_version_against_pallas_and_exact(b, s, hkv, g, hd):
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
    got = tca.cross_attention_int8(torch.from_numpy(q), kq[0], ks[0], vq[0],
                                   vs[0], hkv, seq, num_q_heads=hkv * g).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    want = exact_attention(q, k[0], v[0])
    top = np.abs(want).max()
    # the same roundings in another order of summation: a weight that lands
    # on the other side of a bf16 tie moves its term (up to 127 times the
    # weight) by 2^-9; a few such flips came to 1.6e-4 of the largest output
    assert np.abs(got - pallas).max() < 1e-3 * top, np.abs(got - pallas).max() / top
    # the JAX package's tolerance for int8 K/V against exact attention
    assert np.abs(got - want).max() < 0.02 * top, np.abs(got - want).max() / top


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
