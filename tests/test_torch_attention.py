"""The head-major encoder attention's plain version against the Pallas kernel
(interpret mode) and against the JAX einsum reference. Tolerances are those of
tests/test_fused_attention.py: 2e-5 in float32, 2 % relative in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu.ops.attention import (fused_attention_head_major as
                                          pallas_hm, xla_attention_head_major)
from whisperseg_torch.ops.attention import fused_attention_head_major

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
