"""The head-major encoder attention's plain version against the Pallas kernel
(interpret mode) and against the JAX einsum reference. Tolerances are those of
tests/test_fused_attention.py: 2e-5 in float32, 2 % relative in bf16.

Also the plain model of the CUDA kernels' own walk
(``attention_hm_tiled_reference``: 64-key tiles, p rounded against the
running max, l from the rounded p), which the chip smoke run holds the
kernels to at 1e-3 of max|out|: here against the Pallas kernel in bf16 and
the plain version in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu.ops.attention import (fused_attention_head_major as
                                          pallas_hm, xla_attention_head_major)
from whisperseg_torch.ops.attention import (attention_hm_reference,
                                            attention_hm_tiled_reference,
                                            fused_attention_head_major)

CASES = [  # (b, h, hkv, sp, hd, valid_len)
    (2, 4, 4, 128, 64, 128),     # MHA, no padding
    (2, 6, 6, 128, 64, 100),     # MHA, masked key tail (tiny's head count)
    (1, 4, 2, 128, 64, 90),      # GQA, group 2
    (1, 8, 1, 128, 64, 128),     # GQA, group 8 (the kernel's limit)
    (1, 2, 2, 256, 128, 200),    # hd 128
]


def _inputs(case, seed):
    b, h, hkv, sp, hd, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sp, hd).astype(np.float32) * 0.3,
            rng.randn(b, hkv, hd, sp).astype(np.float32) * 0.3,
            rng.randn(b, hkv, sp, hd).astype(np.float32) * 0.3)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_einsum_float32(case):
    s = case[-1]
    q, kt, v = _inputs(case, 0)
    got = fused_attention_head_major(s, torch.from_numpy(q), torch.from_numpy(kt),
                                     torch.from_numpy(v)).numpy()
    jq, jkt, jv = jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v)
    kernel = np.asarray(pallas_hm(s, jq, jkt, jv, interpret=True))
    einsum = np.asarray(xla_attention_head_major(s, jq, jkt, jv))
    # rows at or beyond valid_len are meaningless by contract
    np.testing.assert_allclose(got[:, :, :s], kernel[:, :, :s], atol=2e-5)
    np.testing.assert_allclose(got[:, :, :s], einsum[:, :, :s], atol=2e-5)


@pytest.mark.parametrize("case", CASES[1:3])
def test_plain_matches_pallas_bf16(case):
    s = case[-1]
    q, kt, v = _inputs(case, 1)
    bf = torch.bfloat16
    got = fused_attention_head_major(
        s, torch.from_numpy(q).to(bf), torch.from_numpy(kt).to(bf),
        torch.from_numpy(v).to(bf))
    assert got.dtype == bf
    kernel = np.asarray(pallas_hm(
        s, jnp.asarray(q, jnp.bfloat16), jnp.asarray(kt, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), interpret=True).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - kernel)[:, :, :s].max()
    assert diff / np.abs(kernel[:, :, :s]).max() < 0.02


# the existing cases, and a short clip whose key tiles 2-3 are wholly masked
# and tile 1 is cut at an odd key
WALK_CASES = CASES + [(1, 4, 2, 256, 64, 75)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("case", WALK_CASES)
def test_kernel_walk_matches_pallas_bf16(case):
    """bf16: within 2 % of max|out| of the Pallas kernel (which rounds p
    against the row's final max, where the walk rounds against the running
    one), and its row log-sum-exp within 1e-2 of the plain version's."""
    s = case[-1]
    arrays = _inputs(case, 2)
    args = _torch(arrays, torch.bfloat16)
    got, lse = attention_hm_tiled_reference(s, *args, with_lse=True)
    assert got.dtype == torch.bfloat16
    kernel = np.asarray(pallas_hm(
        s, *[jnp.asarray(a, jnp.bfloat16) for a in arrays],
        interpret=True).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - kernel)[:, :, :s].max()
    assert diff / np.abs(kernel[:, :, :s]).max() < 0.02
    _, want_lse = attention_hm_reference(s, *args, with_lse=True)
    assert (lse - want_lse).abs().max().item() < 1e-2


@pytest.mark.parametrize("case", WALK_CASES + [(1, 2, 2, 128, 64, 0)])
def test_kernel_walk_matches_plain_float32(case):
    """float32 (rounding p is a no-op): the walk is the plain softmax up to
    the order of float32 sums, within 2e-5; valid_len 0 masks every key and
    weighs all Sp uniformly in both."""
    s = case[-1]
    args = _torch(_inputs(case, 3), torch.float32)
    got, lse = attention_hm_tiled_reference(s, *args, with_lse=True)
    want, want_lse = attention_hm_reference(s, *args, with_lse=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=2e-5)


def test_rejects_what_the_kernel_cannot_take():
    z = torch.zeros
    with pytest.raises(ValueError, match="group size"):
        fused_attention_head_major(64, z(1, 12, 64, 64), z(1, 1, 64, 64),
                                   z(1, 1, 64, 64))
    with pytest.raises(ValueError, match="hd in"):
        fused_attention_head_major(64, z(1, 2, 64, 32), z(1, 2, 32, 64),
                                   z(1, 2, 64, 32))
    with pytest.raises(ValueError, match="Sp % 64"):
        fused_attention_head_major(50, z(1, 2, 100, 64), z(1, 2, 64, 100),
                                   z(1, 2, 100, 64))
    with pytest.raises(TypeError):
        fused_attention_head_major(64, z(1, 2, 64, 64), z(1, 2, 64, 64),
                                   z(1, 2, 64, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_head_major(64, z(1, 64, 2, 64).transpose(1, 2),
                                   z(1, 2, 64, 64), z(1, 2, 64, 64))
