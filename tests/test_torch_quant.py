"""The port's quantization (whisperseg_torch/ops/quant.py) against the JAX
package's: the int8 / int4 grids bit for bit, and the plain versions of the
w8a16 / w4a16 kernels against the interpreted Pallas kernels and against a
float64 numpy statement of their roundings."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.models import init_params
from whisperseg_tpu.models import make_config as jax_make_config
from whisperseg_tpu.ops import quant as jq
from whisperseg_torch.checkpoint import (_flatten, params_from_numpy,
                                         params_to_numpy)
from whisperseg_torch.models.config import make_config
from whisperseg_torch.ops import quant as tq

BF16 = ml_dtypes.bfloat16


def weights(seed, *shape):
    """Weights with columns of very different size, one of them all zero."""
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32) * 0.1
    w *= np.exp(rng.randn(shape[-1])).astype(np.float32)
    w[..., 0] = 0.0
    return w


GRID_SHAPES = [(256, 96), (384, 64), (100, 40), (3, 128, 32), (2, 3, 256, 8)]


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_int8_grid_identical_to_jax(shape):
    w = weights(0, *shape)
    want = jq.quantize(jnp.asarray(w))
    got = tq.quantize(torch.from_numpy(w))
    assert got.shape == shape and got.values.dtype == torch.int8
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert np.abs(got.values.numpy()).max() == 127


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_int4_grid_and_unpack_identical_to_jax(shape):
    """K = 384 has three groups of 128, K = 100 falls back to one group."""
    w = weights(1, *shape)
    want = jq.quantize4(jnp.asarray(w))
    got = tq.quantize4(torch.from_numpy(w))
    assert got.shape == shape
    k = shape[-2]
    assert got.scale.shape[-2] == (k // 128 if k % 128 == 0 else 1)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.unpack4(got).numpy(),
                                  np.asarray(jq.unpack4(want)))
    np.testing.assert_array_equal(
        tq.unpack4(got, torch.bfloat16).float().numpy(),
        np.asarray(jq.unpack4(want, jnp.bfloat16).astype(jnp.float32)))
    nib = tq._nibbles(got.packed)
    assert nib.min() == -7 and nib.max() == 7


def test_stacked_leaf_indexes_by_layer():
    w = weights(2, 3, 256, 32)
    for qt, one in ((tq.quantize(torch.from_numpy(w)), tq.quantize),
                    (tq.quantize4(torch.from_numpy(w)), tq.quantize4)):
        moved = qt.to("cpu", dtype=torch.bfloat16)  # the dtype is ignored
        storage = "values" if isinstance(qt, tq.QuantTensor) else "packed"
        assert getattr(moved, storage).dtype == torch.int8
        assert moved.scale.dtype == torch.float32
        for i in range(3):
            want = one(torch.from_numpy(w[i]))
            assert torch.equal(getattr(qt[i], storage), getattr(want, storage))
            assert torch.equal(qt[i].scale, want.scale)
            assert qt[i].shape == (256, 32)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_identical_to_jax_and_carried_across(bits):
    """The port's own quantize_params on the float tree, and the JAX
    package's quantized tree carried over as numpy pairs, are one model."""
    kw = dict(total_spec_columns=200, encoder_layers=2, decoder_layers=2,
              d_model=128, num_heads=2, d_ff=256, frame_head=True)
    jparams = init_params(jax.random.PRNGKey(0), jax_make_config("tiny", **kw))
    cfg = make_config("tiny", **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    own = tq.cast_float_leaves(tq.quantize_params(params, bits=bits),
                               torch.bfloat16)

    storage = "values" if bits == 8 else "packed"
    jq_tree = jq.cast_float_leaves(jq.quantize_params(jparams, bits=bits),
                                   "bfloat16")
    is_q = lambda x: isinstance(x, (jq.QuantTensor, jq.Quant4Tensor))  # noqa: E731
    pairs = jax.tree.map(
        lambda x: ({storage: np.asarray(getattr(x, storage)),
                    "scale": np.asarray(x.scale)} if is_q(x) else np.asarray(x)),
        jq_tree, is_leaf=is_q)
    carried = params_from_numpy(pairs, cfg, "cpu", dtype=torch.bfloat16)

    a, b = _flatten(own), _flatten(carried)
    assert sorted(a) == sorted(b)
    quantized = 0
    for key, leaf in a.items():
        if key.split(".")[-1] in tq.QUANT_LEAF_NAMES:
            quantized += 1
            assert type(leaf) is type(b[key]) and not torch.is_tensor(leaf), key
            assert torch.equal(getattr(leaf, storage), getattr(b[key], storage))
            assert torch.equal(leaf.scale, b[key].scale), key
        else:
            assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, b[key]), key
    assert quantized == 16  # 6 encoder + 10 decoder stacked leaves

    back = _flatten(params_to_numpy(carried))
    want = _flatten(pairs)
    assert sorted(back) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], np.asarray(arr, back[key].dtype),
                                      err_msg=key)


# -------------------------------------------------------- the two products


def bf16_f64(a):
    """float32 -> nearest bf16, widened to float64."""
    return np.asarray(a, np.float32).astype(BF16).astype(np.float64)


def numpy_w8a16(x, values, scale):
    """The w8a16 function in float64: x and the weight rounded as the TPU
    kernel rounds them, the sum exact. The product of two bf16 values is
    exact in float32, so its rounding to bf16 is a single rounding."""
    w = (bf16_f64(values).astype(np.float32)
         * bf16_f64(scale).astype(np.float32))
    return bf16_f64(x) @ bf16_f64(w)


def numpy_w4a16(x, packed, scale):
    p = packed.astype(np.int32)
    lo_u = p & 15
    q = np.concatenate([lo_u - 16 * (lo_u > 7), p >> 4], axis=0)
    gs = q.shape[0] // scale.shape[0]
    s = np.repeat(bf16_f64(scale).astype(np.float32), gs, axis=0)
    return bf16_f64(x) @ bf16_f64(q.astype(np.float32) * s)


# M, K, out: shapes the Pallas kernels take (K % 256 == 0, a 128-multiple tile
# dividing out); out = 640 once left tail columns unwritten there.
PALLAS_SHAPES = [(8, 256, 128), (16, 256, 640), (3, 512, 384), (48, 256, 1280)]
# further shapes the port's kernels take and the Pallas ones refuse
PORT_ONLY_SHAPES = [(5, 384, 96), (2, 100, 40), (1, 64, 6), (7, 130, 33)]


@pytest.mark.parametrize("m,k,out", PALLAS_SHAPES + PORT_ONLY_SHAPES)
def test_w8a16_plain_version(m, k, out):
    rng = np.random.RandomState(3)
    x = rng.randn(m, k).astype(np.float32)
    w = weights(4, k, out)
    qt = tq.quantize(torch.from_numpy(w))
    got = tq.qdot(torch.from_numpy(x), qt).numpy()
    assert got.dtype == np.float32 and got.shape == (m, out)
    want = numpy_w8a16(x, qt.values.numpy(), qt.scale.numpy())
    # float32 summation against the exact sum of the same products
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if (m, k, out) in PALLAS_SHAPES:
        jqt = jq.QuantTensor(jnp.asarray(qt.values.numpy()),
                             jnp.asarray(qt.scale.numpy()))
        assert jq._pallas_w8_ok(x.shape, (k, out))
        with jax_kernel_path() as traced:
            pallas = np.asarray(jq._qdot_pallas_w8a16(jnp.asarray(x), jqt))
        assert traced == ["quant.py"]
        # the JAX package's own tolerance for this kernel, and how close the
        # same roundings really bring the two
        np.testing.assert_allclose(got, pallas, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got, pallas, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert np.abs(got[:, -128:]).max() > 0  # the tail columns are written


@pytest.mark.parametrize("m,k,out", PALLAS_SHAPES + PORT_ONLY_SHAPES)
def test_w4a16_plain_version(m, k, out):
    """K = 384: the two nibbles of a byte (rows i and i + 192) sit in
    different phases of their groups of 128."""
    rng = np.random.RandomState(5)
    x = rng.randn(m, k).astype(np.float32)
    w = weights(6, k, out)
    qt = tq.quantize4(torch.from_numpy(w))
    got = tq.qdot(torch.from_numpy(x), qt).numpy()
    assert got.dtype == np.float32 and got.shape == (m, out)
    want = numpy_w4a16(x, qt.packed.numpy(), qt.scale.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if (m, k, out) in PALLAS_SHAPES:
        jqt = jq.Quant4Tensor(jnp.asarray(qt.packed.numpy()),
                              jnp.asarray(qt.scale.numpy()))
        assert jq._pallas_w4_ok(x.shape, (k // 2, out))
        with jax_kernel_path() as traced:
            pallas = np.asarray(jq._qdot_pallas_w4a16(jnp.asarray(x), jqt))
        assert traced == ["quant.py"]
        np.testing.assert_allclose(got, pallas, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got, pallas, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert np.abs(got[:, -128:]).max() > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_qdot_takes_leading_axes_and_bf16_input(bits):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 256).astype(np.float32))
    qt = (tq.quantize if bits == 8 else tq.quantize4)(
        torch.from_numpy(weights(8, 256, 64)))
    y = tq.qdot(x, qt)
    assert y.shape == (2, 3, 64)
    assert torch.equal(y.reshape(6, 64), tq.qdot(x.reshape(6, 256), qt))
    # x is rounded to bf16 inside, so an x already in bf16 gives the same
    assert torch.equal(y, tq.qdot(x.to(torch.bfloat16), qt))


def test_w8a8_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(6, 256).astype(np.float32)
    x[2] = 0.0  # a row with no scale of its own
    w = weights(10, 256, 96)
    qt = tq.quantize(torch.from_numpy(w))
    jqt = jq.QuantTensor(jnp.asarray(qt.values.numpy()),
                         jnp.asarray(qt.scale.numpy()))
    want = np.asarray(jq.qdot(jnp.asarray(x), jqt, mode="w8a8"))
    got = tq.qdot(torch.from_numpy(x), qt, mode="w8a8").numpy()
    # the integer sums are exact on both sides; two float32 rescales follow
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert np.all(got[2] == 0)
    dense = x @ (qt.values.numpy().astype(np.float32) * qt.scale.numpy())
    assert np.abs(got - dense).max() < 0.02 * np.abs(dense).max()


def test_misuse_raises():
    x = torch.zeros(2, 256)
    q4 = tq.quantize4(torch.from_numpy(weights(11, 256, 8)))
    with pytest.raises(ValueError, match="not supported for int4"):
        tq.qdot(x, q4, mode="w8a8")
    q8 = tq.quantize(torch.from_numpy(weights(11, 256, 8)))
    with pytest.raises(ValueError, match="unknown qdot mode"):
        tq.qdot(x, q8, mode="w4a4")
    stacked = tq.quantize(torch.from_numpy(weights(11, 2, 256, 8)))
    with pytest.raises(ValueError, match="index the stacked leaf"):
        tq.qdot(x, stacked)
    with pytest.raises(ValueError, match="does not contract"):
        tq.qdot(torch.zeros(2, 128), q8)
    with pytest.raises(ValueError, match="even contraction"):
        tq.quantize4(torch.zeros(5, 4))
    with pytest.raises(ValueError, match="bits must be"):
        tq.quantize_params({}, bits=2)
    # the kernels' wrappers take CUDA tensors only: on the CPU qdot must
    # have routed to the plain version before reaching them
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qdot_w8a16_kernel(x, q8)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.qdot_w4a16_kernel(x, q4)
    assert tq.launches_w8a16 == 0 and tq.launches_w4a16 == 0
