"""Greedy and beam-search token ids of the port against the JAX package's
``generate`` on the shipped tiny checkpoint: identical at float32; at bf16,
as shipped, greedy identical and beam picks of equal score; in the quantized
modes (int8, int4, int8 cross K/V) greedy identical to the JAX package on its
TPU kernel path, and teacher-forced logits within a stated distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.decode import generate as jax_generate
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.ops import quant as jq
from whisperseg_torch import tokenizer as tok
from whisperseg_torch.checkpoint import cast_params, load_checkpoint
from whisperseg_torch.decode import _topk, generate
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.ops.quant import quantize_params
from whisperseg_torch.synthetic import tone_bursts

TINY = "pretrained/whisperseg-tiny-animal-vad"


@pytest.fixture(scope="module")
def setup():
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    audio = tone_bursts(3, duration=7.5)
    clips = audio.reshape(3, -1)  # three 2.5 s windows
    feats = np.array(JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000))
    return jparams, jcfg, params, cfg, feats


@pytest.mark.parametrize("num_beams,length_penalty", [(1, 1.0), (4, 1.0),
                                                      (4, 0.6)])
def test_token_ids_identical_to_jax(setup, num_beams, length_penalty):
    jparams, jcfg, params, cfg, feats = setup
    want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(feats),
                                   max_length=100, num_beams=num_beams,
                                   length_penalty=length_penalty))
    got = generate(params, cfg, torch.from_numpy(feats), max_length=100,
                   num_beams=num_beams, length_penalty=length_penalty)
    # the comparison must bite: every window decodes some segments
    assert all((row >= 23).sum() >= 2 for row in want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def bf16_setup():
    """The tiny checkpoint cast to bf16 on both sides, and one encoder output
    per seed from the JAX package's jitted encoder, handed to both decoders."""
    jparams, jcfg = jax_load(TINY)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params, cfg = load_checkpoint(TINY)
    params = cast_params(params, torch.bfloat16)
    encoder = jax.jit(jw.encoder_forward, static_argnums=(1,))
    encs = {}
    for seed in (5, 6):
        clips = tone_bursts(seed, duration=7.5).reshape(3, -1)
        feats = JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000)
        encs[seed] = encoder(jparams, jcfg, jnp.asarray(feats))
    return jparams, jcfg, params, cfg, encs


@pytest.mark.parametrize("seed", [5, 6])
def test_bf16_greedy_token_ids_identical_to_jax(bf16_setup, seed):
    """The shipped bf16 numerics: greedy ids equal JAX's on one shared
    encoder output. Decoding the embedding sum in bf16, or the attention
    scores in float32, turns some of these windows."""
    jparams, jcfg, params, cfg, encs = bf16_setup
    enc = encs[seed]
    want = np.asarray(jax_generate(jparams, jcfg, None, max_length=100,
                                   enc_out=enc))
    got = generate(params, cfg, max_length=100,
                   enc_out=torch.from_numpy(np.array(enc)))
    assert all((row >= 23).sum() >= 6 for row in want)
    np.testing.assert_array_equal(got.numpy(), want)


def _mean_logp(jparams, jcfg, enc, rows):
    """Beam search's length-penalised score (length penalty 1) of each
    prompt-led row of ``rows``, under the JAX package's jitted decoder."""
    @jax.jit
    def logp(enc, ids):
        xk, xv = jw.precompute_cross_kv(jparams, jcfg, enc)
        ck, cv = jw.init_cache(jcfg, ids.shape[0], ids.shape[1])
        logits = jw.decoder_step(jparams, jcfg, xk, xv, ids, jnp.int32(0),
                                 ck, cv)[0]
        return jax.nn.log_softmax(logits, axis=-1)

    lp = np.asarray(logp(enc, jnp.asarray(rows, jnp.int32)))
    pl = len(tok.PROMPT_IDS)
    scores = []
    for w, row in enumerate(rows):
        end = list(row).index(tok.EOT_ID) + 1
        scores.append(np.mean([lp[w, t - 1, row[t]] for t in range(pl, end)]))
    return np.array(scores)


def test_bf16_beam_picks_score_as_jax_picks(bf16_setup):
    """Beam 4 in bf16 on one shared encoder output. Beam hypotheses tie far
    more often than greedy steps, so a window may end on another hypothesis
    than JAX's: it must then score, under JAX's own decoder, within 0.02 of
    JAX's pick (mean log-probability per token; here they differ by up to
    0.015)."""
    jparams, jcfg, params, cfg, encs = bf16_setup
    enc = encs[5]
    want = np.asarray(jax_generate(jparams, jcfg, None, max_length=100,
                                   num_beams=4, enc_out=enc))
    got = generate(params, cfg, max_length=100, num_beams=4,
                   enc_out=torch.from_numpy(np.array(enc))).numpy()
    assert all((row >= 23).sum() >= 6 for row in want)
    same = [np.array_equal(a, b) for a, b in zip(got, want)]
    assert any(same)
    gap = _mean_logp(jparams, jcfg, enc, want) - _mean_logp(jparams, jcfg, enc, got)
    assert np.all(np.abs(gap) < 0.02), gap


@pytest.fixture(scope="module")
def quant_setup():
    """The float32 tiny checkpoint of both packages (each quantizes it
    itself, as its Segmenter does), and the features of three windows."""
    jparams, jcfg = jax_load(TINY)
    params, cfg = load_checkpoint(TINY)
    clips = tone_bursts(5, duration=7.5).reshape(3, -1)
    feats = np.array(JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000))
    return jparams, jcfg, params, cfg, feats


def _quantized(quant_setup, bits):
    jparams, jcfg, params, cfg, feats = quant_setup
    jparams = jq.cast_float_leaves(jq.quantize_params(jparams, bits=bits),
                                   "bfloat16")
    params = cast_params(quantize_params(params, bits=bits), torch.bfloat16)
    return jparams, jcfg, params, cfg, feats


# the Pallas kernels the JAX package must have traced in each mode
QUANT_MODES = [(8, False, {"attention.py", "quant.py"}),
               (4, False, {"attention.py", "quant.py"}),
               (8, True, {"attention.py", "quant.py", "cross_attention.py"})]


@pytest.mark.parametrize("bits,int8_kv,kernels", QUANT_MODES)
def test_quantized_greedy_token_ids_identical_to_jax_kernel_path(
        quant_setup, bits, int8_kv, kernels):
    """The slice as a whole: encoder, cross K/V, prefill and decode loop with
    quantized weights, against the JAX package with its w8a16 / w4a16 and
    int8 cross-attention Pallas kernels interpreted inside its jitted decode
    loop."""
    jparams, jcfg, params, cfg, feats = _quantized(quant_setup, bits)
    with jax_kernel_path() as traced:
        want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(feats),
                                       max_length=100, int8_kv=int8_kv))
    assert set(traced) == kernels, traced
    got = generate(params, cfg, torch.from_numpy(feats), max_length=100,
                   int8_kv=int8_kv)
    assert all((row >= 23).sum() >= 6 for row in want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_beam_picks_score_as_jax_picks(quant_setup):
    """Beam 4 with int8 weights: as in bf16, a window may end on another of
    two near-tied hypotheses than JAX's (here window 2, from position 12,
    where JAX's two best logits lie 0.003 apart); under JAX's own decoder
    its pick must score within 0.02 of JAX's (mean log-probability per
    token; here -1.7286 against -1.7289)."""
    jparams, jcfg, params, cfg, feats = _quantized(quant_setup, 8)
    got = generate(params, cfg, torch.from_numpy(feats), max_length=100,
                   num_beams=4).numpy()
    with jax_kernel_path():
        want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(feats),
                                       max_length=100, num_beams=4))
        enc = jax.jit(jw.encoder_forward, static_argnums=(1,))(
            jparams, jcfg, jnp.asarray(feats))
        gap = (_mean_logp(jparams, jcfg, enc, want)
               - _mean_logp(jparams, jcfg, enc, got))
    assert all((row >= 23).sum() >= 6 for row in want)
    assert any(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.all(np.abs(gap) < 0.02), gap


def test_quantized_decoder_logits_close_to_jax_kernel_path(quant_setup, bits=8):
    """Teacher-forced along JAX's own greedy ids, on JAX's encoder output:
    a 3-token prefill, then single-token steps through the int8
    cross-attention. Logits within 0.5 % of the largest logit, the argmax
    equal. Measured: 3e-7 on the prefill, up to 0.1 % on the single-token
    steps, where a float32 sum taken in another order moves a value across a
    bf16 rounding edge now and then."""
    jparams, jcfg, params, cfg, feats = _quantized(quant_setup, bits)
    steps = 6
    with jax_kernel_path():
        enc = jax.jit(jw.encoder_forward, static_argnums=(1,))(
            jparams, jcfg, jnp.asarray(feats))
        ids = np.asarray(jax_generate(jparams, jcfg, None, max_length=100,
                                      int8_kv=True, enc_out=enc))
        step = jax.jit(jw.decoder_step, static_argnums=(1, 8))
        xk, xv = jw.precompute_cross_kv(jparams, jcfg, enc, int8_kv=True)
        ck, cv = jw.init_cache(jcfg, 3, 100)
        pl = len(tok.PROMPT_IDS)
        want = []
        logits, ck, cv = step(jparams, jcfg, xk, xv, jnp.asarray(ids[:, :pl]),
                              jnp.int32(0), ck, cv, enc.shape[1])
        want.append(np.asarray(logits[:, -1]))
        for t in range(pl, pl + steps):
            logits, ck, cv = step(jparams, jcfg, xk, xv,
                                  jnp.asarray(ids[:, t:t + 1]), jnp.int32(t),
                                  ck, cv, enc.shape[1])
            want.append(np.asarray(logits[:, -1]))

    tenc = torch.from_numpy(np.array(enc))
    txk, txv = tw.precompute_cross_kv(params, cfg, tenc, int8_kv=True)
    # the int8 state is the JAX package's (padding aside) but for values on a
    # rounding edge: the K projections sum in another order (measured: 33 of
    # 2.3 million values off by one)
    off = txk[0].numpy().astype(np.int32) - np.asarray(xk[0], np.int32)[:, :, :500]
    assert np.abs(off).max() <= 1 and np.mean(off != 0) < 1e-4
    tck, tcv = tw.init_cache(cfg, 3, 100, "cpu")
    tids = torch.from_numpy(np.array(ids))
    got = [tw.decoder_step(params, cfg, txk, txv, tids[:, :pl], 0, tck, tcv,
                           cross_seq_len=500)[0][:, -1].numpy()]
    for t in range(pl, pl + steps):
        got.append(tw.decoder_step(params, cfg, txk, txv, tids[:, t:t + 1], t,
                                   tck, tcv, cross_seq_len=500)[0][:, -1].numpy())
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 0.005 * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_topk_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[0.0, 5.0, -1e30, 5.0, -1e30, 0.0]])
    vals, idx = _topk(x, 5)
    assert idx.tolist() == [[1, 3, 0, 5, 2]]
    assert vals[0, :2].tolist() == [5.0, 5.0]


def test_out_of_slice_options_raise(setup):
    _, _, params, cfg, feats = setup
    f = torch.from_numpy(feats[:1])
    for kw in (dict(top_k=3), dict(top_p=0.9), dict(constrained=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            generate(params, cfg, f, max_length=10, **kw)
    # int8 cross K/V is in the slice now
    assert generate(params, cfg, f, max_length=10, int8_kv=True).shape == (1, 10)
