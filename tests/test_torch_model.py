"""The port's encoder, frame head, cross-K/V precompute and cached decoder
step against the JAX package on the same parameters and inputs (float32
compute, 1e-4; the bf16 encoder at 1 % relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.decode import generate as jax_generate
from whisperseg_tpu.models import init_params
from whisperseg_tpu.models import make_config as jax_make_config
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.ops import attention as jatt
from whisperseg_torch.checkpoint import (cast_params, load_checkpoint,
                                         params_from_numpy)
from whisperseg_torch.decode import generate
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import make_config
from whisperseg_torch.synthetic import tone_bursts

ATOL = 1e-4
TINY = "pretrained/whisperseg-tiny-animal-vad"
BASE = "pretrained/whisperseg-base-animal-vad"
# a transcript the tiny checkpoint decodes (prompt, then onset/offset/cluster
# triples, then EOT), fed to the decoder teacher-forced
BF16_TOKENS = np.array([12, 13, 14, 20, 50, 0, 82, 143, 0, 171, 194, 0, 235,
                        317, 0, 364, 389, 0, 423, 455, 0, 495, 510, 0, 523,
                        11], np.int64)


def _model(kv_heads, compute_dtype="float32"):
    kw = dict(total_spec_columns=200, encoder_layers=2, decoder_layers=2,
              num_kv_heads=kv_heads, frame_head=True, frame_head_clusters=2,
              compute_dtype=compute_dtype)
    jcfg = jax_make_config("tiny", **kw)
    jparams = init_params(jax.random.PRNGKey(kv_heads), jcfg)
    cfg = make_config("tiny", **kw)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, tparams


def _features(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 80, 200) * 0.5).astype(np.float32)


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_encoder_and_frame_head_match_jax(kv_heads, monkeypatch):
    jcfg, jparams, cfg, tparams = _model(kv_heads)
    feats = _features()
    enc = tw.encoder_forward(tparams, cfg, torch.from_numpy(feats))
    want = np.asarray(jw.encoder_forward(jparams, jcfg, jnp.asarray(feats)))
    assert enc.shape == want.shape == (2, 100, 384)
    np.testing.assert_allclose(enc.numpy(), want, atol=ATOL)

    # the JAX package's own head-major path, its Pallas kernel interpreted
    monkeypatch.setattr(jatt, "fused_available", lambda *a: True)
    monkeypatch.setattr(jatt, "FORCE_INTERPRET", True)
    want_hm = np.asarray(jw.encoder_forward(jparams, jcfg, jnp.asarray(feats)))
    monkeypatch.undo()
    np.testing.assert_allclose(enc.numpy(), want_hm, atol=ATOL)

    logits = tw.frame_head_forward(tparams, cfg, enc)
    want = np.asarray(jw.frame_head_forward(jparams, jcfg, jnp.asarray(enc.numpy())))
    assert logits.shape == (2, 100, 5)
    np.testing.assert_allclose(logits.numpy(), want, atol=ATOL)


def test_bf16_encoder_matches_jax_head_major_path(monkeypatch):
    jcfg, jparams, cfg, tparams = _model(0, "bfloat16")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    tparams = cast_params(tparams, torch.bfloat16)
    feats = _features(1)
    monkeypatch.setattr(jatt, "fused_available", lambda *a: True)
    monkeypatch.setattr(jatt, "FORCE_INTERPRET", True)
    # jitted, as the JAX package runs it: XLA then keeps the convs' float32
    # sums that the source rounds to bf16 (models/whisper.py _conv3)
    encoder = jax.jit(jw.encoder_forward, static_argnums=(1,))
    want = np.asarray(encoder(jparams, jcfg, jnp.asarray(feats)))
    monkeypatch.undo()
    got = tw.encoder_forward(tparams, cfg, torch.from_numpy(feats)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.01


def _tiny_bf16():
    jparams, jcfg = jax_load(TINY)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params, cfg = load_checkpoint(TINY)
    return jparams, jcfg, cast_params(params, torch.bfloat16), cfg


def _tiny_features():
    clips = tone_bursts(3, duration=7.5).reshape(3, -1)
    return np.asarray(JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000))


def test_bf16_encoder_on_the_tiny_checkpoint_matches_jitted_jax(monkeypatch):
    """The shipped bf16 encoder against the JAX package's jitted head-major
    path, within 0.3 % of the largest state (here 0.09 %). Rounding the
    convs' sums to bf16, as the un-jitted JAX source does, is off by 0.7 %."""
    jparams, jcfg, params, cfg = _tiny_bf16()
    feats = _tiny_features()
    monkeypatch.setattr(jatt, "fused_available", lambda *a: True)
    monkeypatch.setattr(jatt, "FORCE_INTERPRET", True)
    encoder = jax.jit(jw.encoder_forward, static_argnums=(1,))
    want = np.asarray(encoder(jparams, jcfg, jnp.asarray(feats)))
    monkeypatch.undo()
    got = tw.encoder_forward(params, cfg, torch.from_numpy(feats)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.003


def test_bf16_decoder_steps_match_jitted_jax():
    """The shipped bf16 path on the tiny checkpoint: a 20-token prefill, then
    three single-token steps, against ``jax.jit(decoder_step)``, the program
    JAX's ``generate`` runs (under jit XLA drops the bf16 round trip of the
    embedding sum, which the eager call keeps). Both take one encoder
    output. Tolerance 1 % of the largest logit: the K/V cache, the attention
    operands and every matmul input are rounded to bf16 on both sides, and a
    float32 sum taken in another order flips some of those roundings."""
    jparams, jcfg, params, cfg = _tiny_bf16()
    feats = jnp.asarray(_tiny_features())
    enc = jax.jit(jw.encoder_forward, static_argnums=(1,))(jparams, jcfg, feats)

    xk, xv = tw.precompute_cross_kv(params, cfg, torch.from_numpy(np.array(enc)))
    jxk, jxv = jax.jit(jw.precompute_cross_kv, static_argnums=(1,))(jparams, jcfg, enc)
    ck, cv = tw.init_cache(cfg, 3, 32, "cpu")
    jck, jcv = jw.init_cache(jcfg, 3, 32)
    jstep = jax.jit(jw.decoder_step, static_argnums=(1,))
    ids = np.tile(BF16_TOKENS[:20], (3, 1))
    pos = 0
    for step in range(4):  # prefill, then three single-token steps
        logits, ck, cv = tw.decoder_step(params, cfg, xk, xv,
                                         torch.from_numpy(ids), pos, ck, cv)
        jlogits, jck, jcv = jstep(jparams, jcfg, jxk, jxv,
                                  jnp.asarray(ids, jnp.int32), jnp.int32(pos),
                                  jck, jcv)
        want = np.asarray(jlogits)
        err = np.abs(logits.numpy() - want).max() / np.abs(want).max()
        assert err < 0.01, f"step {step}: max error {err:.2e} of max |logit|"
        pos += ids.shape[1]
        ids = np.tile(BF16_TOKENS[pos:pos + 1], (3, 1))


def test_bf16_base_decoder_within_its_own_summation_noise(monkeypatch):
    """The shipped base checkpoint at bf16, on one JAX encoder output of four
    2.5 s windows: greedy ids identical to JAX's, and teacher-forced logits
    along them no farther from ``jax.jit(decoder_step)`` than twice as far
    as the port's own logits move when only the order of its float32 sums
    changes (every matmul summed in float64 instead). Keeping the attention
    scores in float32 lands ten times that far."""
    jparams, jcfg = jax_load(BASE)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params, cfg = load_checkpoint(BASE)
    params = cast_params(params, torch.bfloat16)
    clips = tone_bursts(101, duration=10.0).reshape(4, -1)
    feats = JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000)
    enc = jax.jit(jw.encoder_forward, static_argnums=(1,))(jparams, jcfg, feats)
    tenc = torch.from_numpy(np.array(enc))

    ids = np.asarray(jax_generate(jparams, jcfg, None, max_length=40,
                                  enc_out=enc))
    got = generate(params, cfg, max_length=40, enc_out=tenc)
    assert all((row >= 23).sum() >= 4 for row in ids)
    np.testing.assert_array_equal(got.numpy(), ids)

    jxk, jxv = jax.jit(jw.precompute_cross_kv, static_argnums=(1,))(
        jparams, jcfg, enc)
    jck, jcv = jw.init_cache(jcfg, 4, 40)
    want = np.asarray(jax.jit(jw.decoder_step, static_argnums=(1,))(
        jparams, jcfg, jxk, jxv, jnp.asarray(ids, jnp.int32), jnp.int32(0),
        jck, jcv)[0])

    def port_logits():
        xk, xv = tw.precompute_cross_kv(params, cfg, tenc)
        ck, cv = tw.init_cache(cfg, 4, 40, "cpu")
        return tw.decoder_step(params, cfg, xk, xv,
                               torch.from_numpy(ids.astype(np.int64)), 0,
                               ck, cv)[0].numpy()

    logits = port_logits()
    monkeypatch.setattr(tw, "_dot", lambda x, w, cdt: (
        x.to(cdt).double() @ w.to(cdt).double()).float())
    logits64 = port_logits()
    noise = np.abs(logits64 - logits).max()
    assert 0 < noise
    assert np.abs(logits - want).max() < 2 * noise


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_cross_kv_and_decoder_steps_match_jax(kv_heads):
    jcfg, jparams, cfg, tparams = _model(kv_heads)
    rng = np.random.RandomState(3)
    enc = (rng.randn(2, 100, 384) * 0.5).astype(np.float32)
    xk, xv = tw.precompute_cross_kv(tparams, cfg, torch.from_numpy(enc))
    jxk, jxv = jw.precompute_cross_kv(jparams, jcfg, jnp.asarray(enc))
    assert xk.shape == (2, 2, 100, cfg.kv_heads, 64)
    np.testing.assert_allclose(xk.numpy(), np.asarray(jxk), atol=ATOL)
    np.testing.assert_allclose(xv.numpy(), np.asarray(jxv), atol=ATOL)

    max_len = 12
    ck, cv = tw.init_cache(cfg, 2, max_len, "cpu")
    jck, jcv = jw.init_cache(jcfg, 2, max_len)
    ids = np.array([[12, 13, 14], [12, 13, 14]], np.int64)
    pos = 0
    for step in range(4):  # prefill, then three single-token steps
        logits, ck, cv = tw.decoder_step(tparams, cfg, xk, xv,
                                         torch.from_numpy(ids), pos, ck, cv)
        jlogits, jck, jcv = jw.decoder_step(jparams, jcfg, jxk, jxv,
                                            jnp.asarray(ids, jnp.int32),
                                            jnp.int32(pos), jck, jcv)
        assert logits.shape == (2, ids.shape[1], 1024)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=ATOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=ATOL)
        pos += ids.shape[1]
        ids = np.array([[23 + 5 * step], [40 + step]], np.int64)
