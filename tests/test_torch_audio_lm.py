"""The ``audio_lm`` decoder family (models/audio_lm.py, ops/moe.py and its
beam-search path) against the plain float32 reference (tests/plain_audio_lm.py)
on a tiny model: d 64, one dense and two expert layers, 8 experts top-2 and
one shared, latent 32, rotary 16, in front of a one-layer Whisper encoder.
Each layer within 1e-5; the prefill and then cached decoding (absorbed form)
against the reference's full forward; the router's choice at a planted near
tie; the plain expert product against a per-token loop and the card's
grouped route (run on the CPU) against the plain one; ``segment()``'s
beam tokens against a beam search over the reference's logits, eagerly and
through the graph path's buffers; a checkpoint round trip; and every decode
mode the family does not run raising."""

import dataclasses
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

import plain_audio_lm as ref
from whisperseg_torch import decode
from whisperseg_torch import segmenter as seg_mod
from whisperseg_torch import tokenizer as tok
from whisperseg_torch.checkpoint import _flatten, save_checkpoint
from whisperseg_torch.models import audio_lm as alm
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.ops import moe as moe_ops
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts

LM = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
      "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 16, "v_head_dim": 16, "intermediate_size": 128,
      "moe_intermediate_size": 32, "n_routed_experts": 8,
      "n_shared_experts": 1, "num_experts_per_tok": 2,
      "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
      "norm_topk_prob": True, "scoring_func": "sigmoid",
      "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
      "rope_theta": 50000, "rms_norm_eps": 1e-5, "vocab_size": 1024,
      "tie_word_embeddings": False}
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    """The tiny model at float32, its nested and flat weights (the router's
    correction bias and the projector's bias drawn, not zero)."""
    enc = WhisperConfig(d_model=128, encoder_layers=1, num_heads=2, d_ff=256,
                        compute_dtype="float32", model_name="tiny-audio-lm")
    cfg = alm.make_config(LM, enc)
    gen = torch.Generator().manual_seed(7)
    params = alm.init_params(gen, cfg)
    params["lm"]["moe"]["router_b"] = 0.02 * torch.randn(
        params["lm"]["moe"]["router_b"].shape, generator=gen)
    params["lm"]["proj_b"] = 0.02 * torch.randn(64, generator=gen)
    return params, cfg, _flatten(params), dict(cfg.lm)


def _x(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _close(a, b, tol=TOL):
    err = float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
    assert err < tol, err


@pytest.mark.parametrize("piece", ["rms_norm", "rope", "attention", "dense",
                                   "experts"])
def test_each_layer_matches_the_reference(model, piece):
    params, cfg, flat, c = model
    lmc = alm.lm_config(cfg)
    lm = params["lm"]
    x = _x(40, 64, seed=1)
    lp = {k: v[1] for k, v in lm["layers"].items()}
    if piece == "rms_norm":
        got = alm.rms_norm(x, lp["attn_norm_g"] + 0.1, 1e-5)
        want = ref.rms_norm(x, lp["attn_norm_g"] + 0.1, 1e-5)
    elif piece == "rope":
        pe = _x(40, 4, 16, seed=2)
        cos, sin = alm.rope_tables(torch.arange(40) + 500, 16, 50000.0)
        got = alm.apply_rope(pe, cos[:, None], sin[:, None])
        r = ref.rope(pe, torch.arange(40) + 500, 50000.0)
        want = torch.cat([r[..., 0::2], r[..., 1::2]], dim=-1)
    elif piece == "attention":
        cos, sin = alm.rope_tables(torch.arange(40), 16, 50000.0)
        got = alm._attend_prefill(x[None], lp, lmc, torch.float32, cos,
                                  sin)[0][0]
        want = ref.attention(flat, 1, x, c)
    else:
        i = 0 if piece == "dense" else 2
        got = alm._mlp(x, lm, i, lmc, torch.float32, None)
        want = ref.mlp(flat, i, x, c)
    _close(got, want)


def test_prefill_then_cached_decode_match_the_full_forward(model):
    """Two windows, three rows each: the prefill's logits at every prefix
    position, then four cached steps in the absorbed form with a different
    token on each row, against the reference's full forward of each row's
    sequence."""
    params, cfg, flat, c = model
    enc = _x(2, 20, 128, seed=3)
    logits, prefix = alm.prefill(params, cfg, enc, all_logits=True)
    for b in range(2):
        want = ref.logits(flat, c, enc[b], torch.tensor(tok.PROMPT_IDS))
        _close(logits[b], want)
    k, steps = 3, 4
    ids = torch.randint(0, 1024, (2 * k, steps),
                        generator=torch.Generator().manual_seed(4))
    cache = alm.init_cache(cfg, 2 * k, steps, "cpu")
    load = torch.zeros(3, dtype=torch.long)
    for t in range(steps):
        got = alm.step(params, cfg, prefix, cache, ids[:, t],
                       torch.tensor(t), load=load)
        for row in range(2 * k):
            seq = torch.cat([torch.tensor(tok.PROMPT_IDS), ids[row, :t + 1]])
            want = ref.logits(flat, c, enc[row // k], seq, first=-1)[0]
            _close(got[row], want)
    assert load.tolist()[0] == steps * 2 * k * 2 * 2   # rows x layers x top-2


def test_the_router_keeps_a_planted_near_tie_and_uses_its_bias(model):
    """Scores that tie but for 1e-6 at the k-th place, and a bias that
    lifts a low-scoring expert into the top k: the choice and the weights
    (from the scores, not the bias) are the reference's."""
    params, cfg, flat, c = model
    d, e = 64, 8
    x = torch.zeros(3, d)
    x[:, 0] = 1.0
    w = torch.zeros(d, e)
    w[0] = torch.tensor([2.0, 1.0, 1.0 + 1e-6, 0.5, -1.0, -2.0, 0.0, 0.3])
    b = torch.zeros(e)
    b[5] = 3.0          # sigmoid(-2) + 3 beats every other expert
    wb = {"lm.moe.router_w": w[None], "lm.moe.router_b": b[None]}
    want_idx, want_w = ref.router(wb, 0, x, c)
    idx, wt = alm.route(x, w, b, alm.lm_config(cfg))
    assert torch.equal(idx.sort(-1).values, want_idx.sort(-1).values)
    assert sorted(idx[0].tolist()) == [0, 5]
    order, want_order = idx.argsort(-1), want_idx.argsort(-1)
    _close(wt.gather(1, order), want_w.gather(1, want_order), 1e-6)
    s = torch.sigmoid(torch.tensor([2.0, -2.0]))
    _close(wt[0].sort().values, (s / s.sum() * 2.446).sort().values, 1e-6)
    # without the bias the near tie goes to the larger score
    idx, _ = alm.route(x, w, torch.zeros(e), alm.lm_config(cfg))
    assert sorted(idx[0].tolist()) == [0, 2]


def test_the_plain_expert_product_matches_a_per_token_loop(model):
    params, _cfg, _flat, _c = model
    mp = {k: v[0] for k, v in params["lm"]["moe"].items()}
    x = _x(30, 64, seed=5)
    idx = torch.randint(0, 8, (30, 2), generator=torch.Generator().manual_seed(6))
    counts = moe_ops.expert_counts(idx, 8)
    assert counts.tolist() == torch.bincount(idx.reshape(-1), minlength=8).tolist()
    got = moe_ops.expert_mlp(x, idx, mp["gate_w"], mp["up_w"], mp["down_w"],
                             counts)
    for t in range(30):
        for j in range(2):
            e = int(idx[t, j])
            want = (F.silu(x[t] @ mp["gate_w"][e]) * (x[t] @ mp["up_w"][e])
                    ) @ mp["down_w"][e]
            _close(got[t, j], want)



def test_the_grouped_expert_product_matches_the_plain_version(model):
    """The card's route (pairs sorted by expert, three grouped products at
    the experts' running ends) run on the CPU in bf16, with an expert that
    gets no pair, against the plain loop: within bf16's rounding of the
    gate, up and down rows, and three launches counted."""
    params, _cfg, _flat, _c = model
    mp = {k: v[0].to(torch.bfloat16) for k, v in params["lm"]["moe"].items()}
    x = _x(30, 64, seed=8).to(torch.bfloat16)
    idx = torch.randint(0, 8, (30, 2), generator=torch.Generator().manual_seed(9))
    idx[idx == 3] = 4
    counts = moe_ops.expert_counts(idx, 8)
    assert counts[3] == 0
    before = moe_ops.launches
    got = moe_ops._expert_mlp_grouped(x, idx, mp["gate_w"], mp["up_w"],
                                      mp["down_w"], counts)
    assert moe_ops.launches - before == 3
    want = moe_ops.expert_mlp_plain(x, idx, mp["gate_w"], mp["up_w"],
                                    mp["down_w"])
    assert got.shape == want.shape == (30, 2, 64) and got.dtype == torch.float32
    _close(got, want, 2e-2)
    with pytest.raises(ValueError, match="bfloat16"):
        moe_ops._expert_mlp_grouped(x.float(), idx, mp["gate_w"].float(),
                                    mp["up_w"].float(), mp["down_w"].float(),
                                    counts)

# ------------------------------------------------------------- beam search


NEG = -1e30


def _reference_beam(flat, c, enc, k, max_length, lp=1.0):
    """The banked beam search of decode.py, written over the reference's
    logits of whole sequences (no cache), for a batch of windows enc [B, S,
    A]: top-2K candidates a window, end-of-text to a bank of the K best by
    score / length^lp, the K best others live; it goes on while any
    window's best live hypothesis beats its worst banked one."""
    pl = len(tok.PROMPT_IDS)
    nb, vocab = enc.shape[0], c["vocab_size"]
    live = [[(0.0, [])] for _ in range(nb)]     # (score, generated ids)
    bank = [[(NEG, None)] * k for _ in range(nb)]
    for pos in range(pl, max_length):
        for b in range(nb):
            cands = []
            for parent, (score, gen) in enumerate(live[b]):
                seq = torch.tensor(list(tok.PROMPT_IDS) + gen)
                lg = ref.logits(flat, c, enc[b], seq, first=-1)[0]
                logp = torch.log_softmax(lg.double(), -1)
                cands += [(score + float(v), parent * vocab + i, gen + [i])
                          for i, v in enumerate(logp)]
            cands.sort(key=lambda t: (-t[0], t[1]))
            top = cands[:2 * k]
            for score, _, gen in top:
                if gen[-1] == tok.EOT_ID:
                    bank[b].append((score / len(gen) ** lp, gen))
            bank[b] = sorted(bank[b], key=lambda t: -t[0])[:k]
            live[b] = [(s, g) for s, _, g in top if g[-1] != tok.EOT_ID][:k]
        if pos == max_length - 1:
            break
        if not any(max(s / len(g) ** lp for s, g in live[b])
                   > min(s for s, _ in bank[b]) for b in range(nb)):
            break
    out = []
    for b in range(nb):
        pool = bank[b] + [(s / len(g) ** lp, g) for s, g in live[b]]
        gen = max(pool, key=lambda t: t[0])[1]
        ids = list(tok.PROMPT_IDS) + gen
        out.append(ids + [tok.PAD_ID] * (max_length - len(ids)))
    return out


def _served(monkeypatch):
    """Every beam search that segment() runs: (encoder output, tokens)."""
    seen = []
    real = seg_mod.generate

    def recording(params, cfg, **kwargs):
        out = real(params, cfg, **kwargs)
        seen.append((kwargs["enc_out"], out))
        return out
    monkeypatch.setattr(seg_mod, "generate", recording)
    return seen


@pytest.mark.parametrize("graphed", [False, True])
def test_segment_beam_tokens_match_a_beam_search_over_the_reference(
        model, monkeypatch, graphed):
    """segment() on 4 s of tone bursts (two windows of a batch of 2, beam 2,
    10 tokens): the tokens it decodes are the reference beam search's over
    the same encoder states; with ``graphed`` the search runs through a
    graph's static buffers (its capture replaced by running the step)."""
    params, cfg, flat, c = model
    if graphed:
        monkeypatch.setattr(decode, "graph_engages", lambda *args: True)
        monkeypatch.setattr(decode, "_GRAPHS", {})
        monkeypatch.setattr(decode, "_capture", lambda body, device: (
            body(), body)[1])
        monkeypatch.setattr(decode, "_device_memory", lambda device: 1 << 40)
    seen = _served(monkeypatch)
    s = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
    audio = tone_bursts(3, duration=4.0)
    s.segment(audio, sr=32000, spec_time_step=0.0025, num_trials=1,
              num_beams=2, batch_size=2, max_length=10)
    assert len(seen) == 1
    enc, tokens = seen[0]
    want = _reference_beam(flat, c, enc, 2, 10)
    assert tokens.tolist() == want
    if graphed:
        assert len(decode._GRAPHS) == 1


def test_the_expert_load_reaches_the_stats(model):
    params, cfg, _flat, _c = model
    stats = {}
    enc = _x(2, 20, 128, seed=8)
    decode.generate(params, cfg, enc_out=enc, num_beams=2, max_length=6,
                    stats=stats)
    # the prefill: 2 windows of 23 positions, 2 expert layers, top-2
    assert stats["routed_prefill"] == 2 * 23 * 2 * 2
    assert 0 < stats["experts_prefill"] <= 2 * 8
    assert stats["routed_decode"] % (4 * 2 * 2) == 0
    assert stats["busiest_decode"] <= stats["routed_decode"]


def test_a_checkpoint_round_trip(model, tmp_path):
    """config.json + params.npz of the audio_lm family load through
    Segmenter.from_pretrained with the same config, weights and tokens."""
    params, cfg, flat, _c = model
    save_checkpoint(str(tmp_path), params, dataclasses.replace(cfg))
    loaded = Segmenter.from_pretrained(str(tmp_path), inference_dtype="float32",
                                       device="cpu")
    assert loaded.config.decoder_family == "audio_lm"
    assert loaded.config.lm == cfg.lm
    got = _flatten(loaded.params)
    assert set(got) == set(flat)
    assert all(torch.equal(got[k], flat[k]) for k in flat)
    enc = _x(1, 20, 128, seed=9)
    assert torch.equal(
        decode.generate(loaded.params, loaded.config, enc_out=enc,
                        num_beams=2, max_length=6),
        decode.generate(params, cfg, enc_out=enc, num_beams=2, max_length=6))


@pytest.mark.parametrize("mode", ["greedy", "sampling", "speculative",
                                  "int8", "int4", "int8_kv"])
def test_each_unsupported_decode_mode_raises(model, mode, tmp_path):
    params, cfg, _flat, _c = model
    enc = _x(1, 20, 128, seed=10)
    with pytest.raises(ValueError, match="audio_lm"):
        if mode == "greedy":
            decode.generate(params, cfg, enc_out=enc, num_beams=1)
        elif mode == "sampling":
            decode.generate(params, cfg, enc_out=enc, num_beams=1, top_k=5)
        elif mode == "speculative":
            s = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
            s.set_draft_model(str(tmp_path))
        elif mode == "int8_kv":
            decode.generate(params, cfg, enc_out=enc, num_beams=2,
                            int8_kv=True)
        else:
            Segmenter(params, cfg, inference_dtype=mode, device="cpu")
    if mode == "speculative":
        with pytest.raises(ValueError, match="audio_lm"):
            decode.generate_speculative(params, cfg, params, cfg,
                                        torch.zeros(1, 80, 40))


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, 'tests'); import plain_audio_lm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "whisperseg_tpu",
                       "whisperseg_torch"}
