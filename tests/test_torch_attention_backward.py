"""The encoder attention's backward (ops/attention.py): its plain version
against the JAX package's VJP of ``fused_attention_hm`` (Pallas forward in
interpret mode, einsum backward), against the gradients of JAX's stock
Pallas flash attention (interpreted) on the valid rows, and against
``torch.autograd`` through the plain forward. Tolerances are shares of the
largest gradient: 1e-5 in float32; 2e-2 in bf16, where the JAX VJP keeps
bf16 scores and rounds its gradients to bf16 while the port sums in
float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from whisperseg_tpu.ops import attention as jatt
from whisperseg_torch.ops import attention as att

CASES = [  # (b, h, hkv, sp, hd, valid_len)
    (2, 2, 2, 128, 64, 100),     # MHA, the tests' encoder shape
    (1, 4, 2, 128, 64, 90),      # GQA 4/2
]


def _inputs(case, seed, pad_rows_zero=False):
    b, h, hkv, sp, hd, valid = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sp, hd).astype(np.float32) * 0.5
    kt = rng.randn(b, hkv, hd, sp).astype(np.float32) * 0.5
    v = rng.randn(b, hkv, sp, hd).astype(np.float32) * 0.5
    do = rng.randn(b, h, sp, hd).astype(np.float32)
    if pad_rows_zero:
        do[:, :, valid:] = 0
    return q, kt, v, do


def _port_grads(valid, q, kt, v, do, dtype):
    t = [torch.from_numpy(x).to(dtype) for x in (q, kt, v, do)]
    o, lse = att.fused_attention_head_major(valid, *t[:3], with_lse=True)
    return [g.float().numpy()
            for g in att.attention_hm_backward(valid, *t[:3], o, t[3], lse)]


def _share(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(case, dtype, monkeypatch):
    monkeypatch.setattr(jatt, "FORCE_INTERPRET", True)
    valid = case[-1]
    q, kt, v, do = _inputs(case, 0)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b, c: jatt.fused_attention_hm(valid, a, b, c),
                     *(jnp.asarray(x, jdt) for x in (q, kt, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]
    got = _port_grads(valid, q, kt, v, do, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(("dq", "dkt", "dv"), got, want):
        assert _share(g, w) <= tol, (name, _share(g, w))


def test_plain_backward_matches_stock_flash_kernel(monkeypatch):
    """The TPU kernel this backward replaces: bf16, MHA, padding by segment
    ids, dO zero on padded rows (as the encoder's slice leaves it)."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    case = (1, 2, 2, 128, 64, 100)
    b, h, _, sp, hd, valid = case
    q, kt, v, do = _inputs(case, 1, pad_rows_zero=True)
    seg = jnp.asarray(np.repeat([[0] * valid + [1] * (sp - valid)], b, 0),
                      jnp.int32)
    bf = jnp.bfloat16

    def flash(qq, kk, vv):
        return jfa.flash_attention(qq, kk, vv,
                                   segment_ids=jfa.SegmentIds(q=seg, kv=seg),
                                   causal=False, sm_scale=hd ** -0.5)

    k = np.ascontiguousarray(kt.transpose(0, 1, 3, 2))
    _, vjp = jax.vjp(flash, *(jnp.asarray(x, bf) for x in (q, k, v)))
    dq, dk, dv = (np.asarray(g.astype(jnp.float32))
                  for g in vjp(jnp.asarray(do, bf)))
    got = _port_grads(valid, q, kt, v, do, torch.bfloat16)
    pairs = [(got[0], dq), (got[1].transpose(0, 1, 3, 2), dk), (got[2], dv)]
    for name, (g, w) in zip(("dq", "dk", "dv"), pairs):
        assert _share(g[:, :, :valid], w[:, :, :valid]) <= 2e-2, name


@pytest.mark.parametrize("case", CASES + [(1, 2, 2, 128, 128, 128)])
def test_plain_backward_matches_autograd_float32(case):
    valid = case[-1]
    q, kt, v, do = (torch.from_numpy(x) for x in _inputs(case, 2))
    leaves = [t.clone().requires_grad_() for t in (q, kt, v)]
    want = torch.autograd.grad(att.attention_hm_reference(valid, *leaves),
                               leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, kt, v)]
    got = torch.autograd.grad(att.EncoderAttention.apply(valid, *leaves),
                              leaves, do)
    for g, w in zip(got, want):
        assert _share(g.numpy(), w.numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_keys_get_exactly_zero_gradient(dtype):
    case = (1, 4, 2, 128, 64, 70)
    valid = case[-1]
    q, kt, v, do = (torch.from_numpy(x).to(dtype)
                    for x in _inputs(case, 3, pad_rows_zero=True))
    kt[..., valid:] = 3e4   # poisoned padded keys, large but finite
    v[:, :, valid:] = -3e4
    leaves = [t.clone().requires_grad_() for t in (q, kt, v)]
    dq, dkt, dv = torch.autograd.grad(att.EncoderAttention.apply(valid, *leaves),
                                      leaves, do)
    assert torch.count_nonzero(dkt[..., valid:]) == 0
    assert torch.count_nonzero(dv[:, :, valid:]) == 0
    assert all(torch.isfinite(g).all() for g in (dq, dkt, dv))


def test_forward_is_the_kernel_output_with_or_without_grad():
    case = (2, 2, 2, 128, 64, 100)
    q, kt, v, _ = (torch.from_numpy(x) for x in _inputs(case, 4))
    plain = att.fused_attention_head_major(100, q, kt, v)
    with torch.no_grad():
        assert torch.equal(att.encoder_attention(100, q, kt, v), plain)
    leaves = [t.clone().requires_grad_() for t in (q, kt, v)]
    with_grad = att.encoder_attention(100, *leaves)
    assert with_grad.requires_grad
    assert torch.equal(with_grad.detach(), plain)
    o, lse = att.fused_attention_head_major(100, q, kt, v, with_lse=True)
    assert torch.equal(o, plain) and lse.shape == (2, 2, 128)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    case = (1, 4, 2, 128, 64, 90)
    valid = case[-1]
    q, kt, v, do = (torch.from_numpy(x) for x in _inputs(case, 5))
    o, lse = att.fused_attention_head_major(valid, q, kt, v, with_lse=True)
    delta = (o * do).sum(-1)
    att.launches_bwd_dkv = att.launches_bwd_dq = 0
    dkt, dv = att.attention_hm_bwd_dkv(valid, q, kt, v, do, lse, delta)
    dq = att.attention_hm_bwd_dq(valid, q, kt, v, do, lse, delta)
    want = att.attention_hm_backward_reference(valid, q, kt, v, o, do, lse)
    for g, w in zip((dq, dkt, dv), want):
        assert torch.equal(g, w)
    assert att.launches_bwd_dkv == att.launches_bwd_dq == 0


def test_backward_rejects_what_the_kernels_cannot_take():
    z = torch.zeros
    q, kt, v = z(1, 2, 64, 64), z(1, 2, 64, 64), z(1, 2, 64, 64)
    lse = z(1, 2, 64)
    with pytest.raises(ValueError, match="lse"):
        att.attention_hm_bwd_dq(64, q, kt, v, q, z(1, 2, 32), lse)
    with pytest.raises(ValueError, match="dO"):
        att.attention_hm_bwd_dkv(64, q, kt, v, q.to(torch.bfloat16), lse, lse)
    with pytest.raises(ValueError, match="valid_len"):
        att.attention_hm_bwd_dq(0, q, kt, v, q, lse, lse)
