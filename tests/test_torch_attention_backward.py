"""The encoder attention's backward (ops/attention.py): its plain version
against the JAX package's VJP of ``fused_attention_hm`` (Pallas forward in
interpret mode, einsum backward), against the gradients of JAX's stock
Pallas flash attention (interpreted) on the valid rows, and against
``torch.autograd`` through the plain forward, and in bf16 against numpy
with the stock kernel's rounding points. Tolerances are shares of the
largest gradient: 1e-5 in float32; 2e-2 in bf16 against the JAX VJP, which
keeps bf16 scores and rounds its gradients to bf16 while the port sums in
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
    ids, dO zero on padded rows (as the encoder's slice leaves it). Largest
    gap 5.5e-3 of max|grad| (dv; one bf16 step at a large entry), held to
    1e-2 (was 2e-2). Mean gap 2.1e-4 of max|grad| since P and dS are
    rounded where the stock kernel rounds them, against 3.8e-4 with float32
    P and dS: held to 3e-4."""
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
        g, w = g[:, :, :valid], w[:, :, :valid]
        assert _share(g, w) <= 1e-2, (name, _share(g, w))
        mean = np.abs(g - w).mean() / np.abs(w).max()
        assert mean <= 3e-4, (name, mean)


def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), kept as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).view(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_rounds_where_the_stock_kernel_does(case):
    """bf16: the plain backward against float64 numpy that rounds P to bf16
    before dV = P^T dO and dS * scale to bf16 before dQ and dK, on the same
    lse and D. They differ only where float32 and float64 sums round to
    different sides of a bf16 step: at most 23 of 32768 entries and 4.3e-3
    of max|grad| at these cases (float32 P and dS: 15-43 % of the entries),
    held to 1 % of the entries and 1e-2."""
    valid = case[-1]
    q, kt, v, do = (_bf16(x) for x in _inputs(case, 6))
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, kt, v, do)]
    o, lse = att.fused_attention_head_major(valid, *t[:3], with_lse=True)
    delta = att._delta(o, t[3])
    got = [g.float().numpy() for g in att._backward_plain(valid, *t, lse, delta)]

    b, h, sp, hd = q.shape
    hkv = v.shape[1]
    g = h // hkv
    q5 = q.astype(np.float64).reshape(b, hkv, g, sp, hd)
    do5 = do.astype(np.float64).reshape(b, hkv, g, sp, hd)
    s = np.einsum("bkgsf,bkft->bkgst", q5, kt.astype(np.float64)) * hd ** -0.5
    p = np.exp(s - lse.numpy().reshape(b, hkv, g, sp, 1)) * (np.arange(sp) < valid)
    dv = np.einsum("bkgst,bkgsf->bktf", _bf16(p), do5)
    dp = np.einsum("bkgsf,bktf->bkgst", do5, v.astype(np.float64))
    ds = _bf16(p * (dp - delta.numpy().reshape(b, hkv, g, sp, 1)) * hd ** -0.5)
    dq = np.einsum("bkgst,bkft->bkgsf", ds, kt).reshape(b, h, sp, hd)
    dkt = np.einsum("bkgst,bkgsf->bkft", ds, q5)
    for name, gg, w in zip(("dq", "dkt", "dv"), got, (dq, dkt, dv)):
        w = _bf16(w)
        assert _share(gg, w) <= 1e-2, (name, _share(gg, w))
        assert np.mean(gg != w) <= 1e-2, (name, np.mean(gg != w))


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
