"""Speculative decoding in the port (``decode.generate_speculative``, the
slot mode of ``models/whisper.py::decoder_step``, ``Segmenter.
set_draft_model`` and the segment CLI's ``--draft_model_path``) against the
JAX package's, on the shipped tiny checkpoint at float32 on the CPU.

The output must be the target's greedy transcript, token for token, and the
JAX package's speculative output, whatever the draft: the tiny checkpoint
drafting for itself (every draft accepted), a random draft (almost every
draft rejected), rows of ragged lengths, and a budget that cuts the
commits; with int8 weights too, against the JAX package on its TPU kernel
path. Tolerance: slot-mode logits within 1e-5 of the largest logit."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.cli import segment as jax_cli
from whisperseg_tpu.decode import generate as jax_generate
from whisperseg_tpu.decode import generate_speculative as jax_speculative
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_tpu.ops import quant as jq
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter
from whisperseg_torch import tokenizer as tok
from whisperseg_torch.audio.io import save_wav
from whisperseg_torch.checkpoint import (cast_params, load_checkpoint,
                                         params_from_numpy)
from whisperseg_torch.cli import segment as cli
from whisperseg_torch.decode import generate, generate_speculative
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.ops.quant import quantize_params
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
SR = 32000
# a random draft: 1 + 1 layers, 2 heads of 64 (the encoder attention's
# plain version takes head dims of 64 and 128)
DRAFT = dict(d_model=128, encoder_layers=1, decoder_layers=1, num_heads=2,
             d_ff=256, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs (the suite runs
    several processes at once; the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """The float32 tiny checkpoint of both packages, and the features of two
    tone-burst windows and two of noise (the noise rows end at other
    lengths than the tone rows)."""
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    clips = tone_bursts(3, duration=5.0).reshape(2, -1)
    feats = np.array(JaxFrontend(SR, 0.0025).features_for_clips(clips, 1000))
    noise = np.random.RandomState(1).uniform(
        feats.min(), feats.max(), (2,) + feats.shape[1:]).astype(np.float32)
    return jparams, jcfg, params, cfg, np.concatenate([feats, noise])


def _random_draft():
    """A randomly initialised draft, the same weights in both packages."""
    jcfg = JaxConfig(**DRAFT)
    np_params = jax.tree.map(lambda x: np.array(x, np.float32),
                             jw.init_params(jax.random.PRNGKey(7), jcfg))
    cfg = WhisperConfig(**DRAFT)
    return (jax.tree.map(jnp.asarray, np_params), jcfg,
            params_from_numpy(np_params, cfg, "cpu"), cfg)


def test_decoder_step_slot_mode_matches_jax(tiny):
    """A 3-token chunk at cache slot 10 with random per-row true positions
    and a random map of valid history slots, after a prompt prefill: logits
    and the chunk's cache entries within 1e-5 of the largest logit / value.
    Without the slot arguments the step is the plain one (within 1e-5 of
    JAX's), and slot mode with true positions equal to the slots and every
    earlier slot valid reduces to it."""
    jparams, jcfg, params, cfg, _ = tiny
    rng = np.random.RandomState(0)
    b, max_len, pos0 = 3, 24, 10
    enc = rng.randn(b, 30, cfg.d_model).astype(np.float32)
    prompt = np.tile(np.array(tok.PROMPT_IDS, np.int32), (b, 1))
    chunk = rng.randint(0, 1024, (b, 3)).astype(np.int32)
    truepos = rng.randint(3, 20, b).astype(np.int32)
    slot_valid = rng.rand(b, max_len) < 0.6
    slot_valid[:, :3] = True

    step = jax.jit(jw.decoder_step, static_argnums=(1, 8))
    xk, xv = jw.precompute_cross_kv(jparams, jcfg, jnp.asarray(enc))
    ck, cv = jw.init_cache(jcfg, b, max_len)
    _, ck, cv = step(jparams, jcfg, xk, xv, jnp.asarray(prompt), jnp.int32(0),
                     ck, cv, 30)
    want, wck, _ = step(jparams, jcfg, xk, xv, jnp.asarray(chunk),
                        jnp.int32(pos0), ck, cv, 30, jnp.asarray(truepos),
                        jnp.asarray(slot_valid))
    want_plain = step(jparams, jcfg, xk, xv, jnp.asarray(chunk),
                      jnp.int32(pos0), ck, cv, 30)[0]

    txk, txv = tw.precompute_cross_kv(params, cfg, torch.from_numpy(enc))

    def prefilled():
        tck, tcv = tw.init_cache(cfg, b, max_len, "cpu")
        tw.decoder_step(params, cfg, txk, txv, torch.from_numpy(prompt).long(),
                        torch.tensor(0), tck, tcv)
        return tck, tcv

    tck, tcv = prefilled()
    got, gck, _ = tw.decoder_step(
        params, cfg, txk, txv, torch.from_numpy(chunk).long(), pos0, tck, tcv,
        truepos=torch.from_numpy(truepos).long(),
        slot_valid=torch.from_numpy(slot_valid))
    want = np.asarray(want)
    top = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * top
    written = np.asarray(wck)[:, :, pos0:pos0 + 3]
    assert np.abs(gck[:, :, pos0:pos0 + 3].numpy() - written).max() <= \
        1e-5 * np.abs(written).max()

    tck, tcv = prefilled()
    plain = tw.decoder_step(params, cfg, txk, txv,
                            torch.from_numpy(chunk).long(),
                            torch.tensor(pos0), tck, tcv)[0]
    assert np.abs(plain.numpy() - np.asarray(want_plain)).max() <= 1e-5 * top
    tck, tcv = prefilled()
    as_slots = tw.decoder_step(
        params, cfg, txk, txv, torch.from_numpy(chunk).long(), pos0, tck, tcv,
        truepos=torch.full((b,), pos0),
        slot_valid=torch.ones(b, max_len, dtype=torch.bool))[0]
    assert np.abs(as_slots.numpy() - plain.numpy()).max() <= 1e-5 * top
    assert torch.equal(as_slots.argmax(-1), plain.argmax(-1))


@pytest.mark.parametrize("draft,rows,max_length,spec_k", [
    ("self", 4, 60, 3), ("random", 2, 60, 4), ("self", 4, 7, 3)],
    ids=["self_draft_ragged", "random_draft", "budget_cap"])
def test_speculative_ids_identical_to_jax_and_to_greedy(tiny, draft, rows,
                                                        max_length, spec_k):
    """Rows that end at different steps (the four windows end after 10 to
    31 tokens), and a budget that cuts every row."""
    jparams, jcfg, params, cfg, feats = tiny
    feats = feats[:rows]
    if draft == "self":
        jd, jdc, d, dc = jparams, jcfg, params, cfg
    else:
        jd, jdc, d, dc = _random_draft()
    f = torch.from_numpy(feats)
    stats = {}
    got = generate_speculative(params, cfg, d, dc, f, max_length=max_length,
                               spec_k=spec_k, stats=stats).numpy()
    want = np.asarray(jax_speculative(jparams, jcfg, jd, jdc,
                                      jnp.asarray(feats),
                                      max_length=max_length, spec_k=spec_k))
    greedy = generate(params, cfg, f, max_length=max_length).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, greedy)
    lengths = [list(r).index(tok.EOT_ID) if tok.EOT_ID in r else max_length
               for r in greedy]
    committed = int(stats["committed"])
    per_forward = committed / int(stats["row_forwards"])
    if max_length > 7:
        assert min(lengths) > 6
        assert len(set(lengths[:rows])) == rows  # ragged
        # a row commits spec_k + 1 tokens a target forward when it drafts
        # for itself (fewer where it ends), about one with a random draft
        assert (per_forward > 2.5) if draft == "self" else (per_forward < 1.5)
    else:
        assert max(lengths) == max_length  # the budget cut every row


def test_speculative_int8_target_identical_to_jax_kernel_path(tiny):
    """An int8 target, the float32 tiny checkpoint drafting: the verify
    chunk's products (4 rows x 4 tokens) take the w8a16 route. The ids are
    the JAX package's speculative ones on its TPU kernel path (interpreted
    Pallas), and its greedy ones there."""
    jparams, jcfg, params, cfg, feats = tiny
    feats = feats[:2]
    jq8 = jq.cast_float_leaves(jq.quantize_params(jparams, bits=8), "bfloat16")
    q8 = cast_params(quantize_params(params, bits=8), torch.bfloat16)
    with jax_kernel_path() as traced:
        want = np.asarray(jax_speculative(jq8, jcfg, jparams, jcfg,
                                          jnp.asarray(feats), max_length=40,
                                          spec_k=3))
        greedy = np.asarray(jax_generate(jq8, jcfg, jnp.asarray(feats),
                                         max_length=40))
    assert "quant.py" in traced
    got = generate_speculative(q8, cfg, params, cfg, torch.from_numpy(feats),
                               max_length=40, spec_k=3).numpy()
    assert all((row >= 23).sum() >= 4 for row in greedy)
    np.testing.assert_array_equal(want, greedy)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def float32_checkpoint(tmp_path_factory):
    """The shipped tiny checkpoint with a config that computes in float32
    (the weights file linked, not copied)."""
    root = str(tmp_path_factory.mktemp("tiny_f32"))
    os.symlink(os.path.join(TINY, "params.npz"),
               os.path.join(root, "params.npz"))
    with open(os.path.join(TINY, "config.json")) as f:
        config = json.load(f)
    config["compute_dtype"] = "float32"
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return root


@pytest.fixture(scope="module")
def drafted(float32_checkpoint):
    """One JAX and one port Segmenter with the tiny checkpoint as draft, and
    a port Segmenter without one (the speculative warning silenced while
    the module runs)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WS_SPEC_NO_WARN", "1")
    jseg = JaxSegmenter.from_pretrained(float32_checkpoint,
                                        inference_dtype="float32")
    jseg.set_draft_model(TINY, spec_k=3)
    seg = Segmenter.from_pretrained(float32_checkpoint,
                                    inference_dtype="float32", device="cpu")
    seg.set_draft_model(TINY, spec_k=3)
    plain = Segmenter.from_pretrained(float32_checkpoint,
                                      inference_dtype="float32", device="cpu")
    yield jseg, seg, plain
    mp.undo()


def test_set_draft_model_table_identical_to_jax(drafted):
    """Greedy requests decode speculatively (the frame tracks of the
    checkpoint's post-processing from a second encoder pass): the table is
    the JAX package's and plain greedy's; a beam request does not take the
    draft."""
    jseg, seg, plain = drafted
    audio = tone_bursts(8, duration=6.0)
    assert seg.draft[0]["decoder"]["tok_emb"].dtype == torch.bfloat16
    want = jseg.segment(audio, SR, num_beams=1, batch_size=3)
    got = seg.segment(audio, SR, num_beams=1, batch_size=3)
    assert len(want["onset"]) >= 3, want
    assert got == want
    assert got == plain.segment(audio, SR, num_beams=1, batch_size=3)
    assert seg.spec_stats["verify_forwards"] > 0
    before = seg.spec_stats["verify_forwards"]
    seg.segment(audio[:SR], SR, num_beams=2, batch_size=3)
    assert seg.spec_stats["verify_forwards"] == before


def test_cli_with_draft_model_csv_bytes_identical_to_jax(
        tmp_path, float32_checkpoint, drafted, monkeypatch):
    """``--draft_model_path``: the CSV bytes of the JAX package's CLI. The
    JAX CLI gets the module's Segmenter, whose draft is already this one (a
    second ``set_draft_model`` would compile its programs again)."""
    jseg = drafted[0]
    monkeypatch.setattr(JaxSegmenter, "from_pretrained",
                        lambda *a, **k: jseg)
    asked = []
    monkeypatch.setattr(JaxSegmenter, "set_draft_model",
                        lambda self, path, spec_k=4: asked.append(
                            (path, spec_k)))
    wav = str(tmp_path / "rec.wav")
    save_wav(wav, tone_bursts(8, duration=6.0), SR)
    argv = ["--model_path", float32_checkpoint, "--compute_type", "float32",
            "--batch_size", "3", "--num_beams", "1", "--audio_path", wav,
            "--draft_model_path", TINY, "--spec_k", "3"]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, main in (("jax", jax_cli.main), ("port", cli.main)):
            path = str(tmp_path / f"{name}.csv")
            main(argv + ["--csv_save_path", path]
                 + (["--device", "cpu"] if name == "port" else []))
            with open(path, "rb") as f:
                out[name] = f.read()
    assert asked == [(TINY, 3)]
    assert out["jax"].count(b"\n") >= 4, out["jax"]
    assert out["port"] == out["jax"]
