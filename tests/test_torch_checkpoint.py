"""The port's checkpoint loader against the JAX package's, and the numpy ->
tensor carry-over of parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.models import init_params
from whisperseg_tpu.models import make_config as jax_make_config
from whisperseg_torch.checkpoint import (_flatten, _from_storage,
                                         load_checkpoint, params_from_numpy,
                                         params_to_numpy)
from whisperseg_torch.models.config import make_config

CHECKPOINTS = ["pretrained/whisperseg-tiny-animal-vad",
               "pretrained/whisperseg-base-animal-vad"]


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_shipped_checkpoint_loads_tensor_equal(path):
    want, want_cfg = jax_load(path, as_jax=False)
    got, cfg = load_checkpoint(path)
    assert cfg.to_dict() == want_cfg.to_dict()
    want, got = _flatten(want), _flatten(got)
    assert sorted(want) == sorted(got)
    for key, arr in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


def test_bf16_storage_is_reinterpreted_not_converted():
    with np.load(f"{CHECKPOINTS[0]}/params.npz") as z:
        raw = z["encoder.layers.q_w"]
    assert raw.dtype == np.uint16
    got = _from_storage(raw, "bfloat16")
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy()
    np.testing.assert_array_equal(bits.view(np.uint16), raw)


@pytest.mark.parametrize("form", ["nested", "flat", "bfloat16"])
def test_params_from_numpy_round_trips(form):
    jcfg = jax_make_config("tiny", total_spec_columns=200, encoder_layers=2,
                           decoder_layers=2, frame_head=True)
    jparams = init_params(jax.random.PRNGKey(0), jcfg)
    dtype = torch.float32
    if form == "bfloat16":  # JAX bf16 leaves reach numpy as ml_dtypes arrays
        jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
        dtype = torch.bfloat16
    tree = jax.tree.map(np.asarray, jparams)
    cfg = make_config("tiny", total_spec_columns=200, encoder_layers=2,
                      decoder_layers=2, frame_head=True)
    src = _flatten(tree) if form == "flat" else tree
    params = params_from_numpy(src, cfg, device="cpu", dtype=dtype)
    assert params["encoder"]["conv1_w"].shape == (3, 80, 384)  # HIO kept
    assert params["encoder"]["conv1_w"].dtype == dtype
    back = _flatten(params_to_numpy(params))
    want = _flatten(tree)
    assert sorted(back) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32),
                                      err_msg=key)


def test_params_from_numpy_rejects_a_tree_of_another_config():
    jcfg = jax_make_config("tiny", total_spec_columns=200, encoder_layers=2,
                           decoder_layers=2)
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    cfg = make_config("tiny", total_spec_columns=200, encoder_layers=3,
                      decoder_layers=2)
    with pytest.raises(ValueError, match="encoder.layers.q_w"):
        params_from_numpy(tree, cfg, "cpu")
