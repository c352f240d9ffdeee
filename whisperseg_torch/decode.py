"""Batched autoregressive generation: greedy search, sampling, constrained
decoding, banked beam search and greedy speculative decoding.

The port of ``whisperseg_tpu/decode.py`` (``generate``, ``_generate_greedy``,
``generate_speculative``, ``_generate_beam``, the grammar and the samplers).
JAX's ``lax.while_loop`` becomes a Python loop that exits early; its
condition is read on the host once per step (per iteration, speculative).
Each iteration, from that read to the end of its dispatch, is a
``decode.step`` span (profiling.py).

Beam search's step runs at a position held on the device, so that nothing
it launches depends on the step. Where :func:`graph_engages` (a CUDA
device, plain weights, float cross K/V) the step is captured once as a CUDA
graph over static buffers, per device, weights and shape, and each later
step is one replay; its ``decode.step`` span counts ``graphed=1``. The
tokens are those of the eager loop.

Beam search runs either decoder family (models/config.py) through one small
interface (``_FAMILIES``): the prefill of each window, which returns what
every step reads (Whisper's cross K/V; the audio LM's prefix cache, one a
window, shared by its beams and never reordered) and the logits of the
first pick; the cache of the generated tokens, which beams reorder; the
step; and the bytes of a graph's static buffers. Greedy search, sampling,
speculative decoding and int8 cross K/V are Whisper's alone.

Sampling (``top_k > 1`` or ``top_p < 1``, greedy path only) is Gumbel-max, as
``jax.random.categorical`` is: the pick is ``argmax(logits + g)`` with g
standard Gumbel noise, drawn once per step from a ``noise`` callable (by
default from a ``torch.Generator``; tests pass the noise JAX draws).
``constrained=True`` masks the tokens the transcript grammar forbids at each
step, so every transcript parses.

Beam search is the static banked formulation: each step takes the top-2K
candidates, finished (EOT) candidates move to a per-sequence bank of the K
best hypotheses by ``score / length**length_penalty``, and the K live slots
keep exploring unfinished continuations. The result is the best of the bank
and the length-penalised live set. It ignores ``top_k``, ``top_p`` and
``constrained``, as the JAX package's does. Every top-k breaks ties toward
the lower index, as ``lax.top_k`` does (``torch.topk`` promises no order).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from . import profiling
from . import tokenizer as tok
from .models import audio_lm
from .models.config import WhisperConfig
from .models.whisper import (compute_dtype, decoder_step, encoder_forward,
                             init_cache, precompute_cross_kv)
from .ops.quant import Quant4Tensor, QuantTensor

NEG_INF = -1e30

# Gumbel noise of a given shape on a given device, one call per decode step
Noise = Callable[[tuple, torch.device], torch.Tensor]

# ------------------------------------------------------------ grammar constraint
#
# The transcript grammar is  species? (ts_open digit+ ts_close)* EOT  with
# non-decreasing timestamps. State per sequence: mode in {0: start (species |
# ts | EOT), 1: after ts_open (digits only), 2: in digits (digits | ts > open),
# 3: after ts_close (ts >= close | EOT)}, and the last timestamp column.

_TS0 = tok.TIMESTAMP_BASE
_TS1 = tok.TIMESTAMP_BASE + tok.NUM_TIMESTAMPS


def _is_digit(ids: torch.Tensor, n_extra: int) -> torch.Tensor:
    """Digits 0-9 and the ``n_extra`` extended tokens (ids >= VOCAB_SIZE,
    imported multi-digit cluster pieces) are digit-class."""
    return (((ids >= 0) & (ids < 10))
            | ((ids >= tok.VOCAB_SIZE) & (ids < tok.VOCAB_SIZE + n_extra)))


def _grammar_mask(mode: torch.Tensor, last_col: torch.Tensor, vocab: int,
                  n_extra: int = 0) -> torch.Tensor:
    """mode [B], last_col [B] -> allowed-token bool mask [B, V]. Vocabulary
    padding rows beyond the extended tokens stay disallowed."""
    ids = torch.arange(vocab, device=mode.device)
    is_digit = _is_digit(ids, n_extra)
    is_ts = (ids >= _TS0) & (ids < _TS1)
    is_species = (ids >= tok.SPECIES_BASE) & (
        ids < tok.SPECIES_BASE + len(tok.SPECIES_TOKEN_IDS))
    is_eot = ids == tok.EOT_ID

    first_ok = (_TS0 + last_col)[:, None]
    ts_geq = is_ts & (ids[None, :] >= first_ok)
    # closing a span needs a strictly later column (a zero-length segment
    # would be dropped by the parser); re-opening after a close may abut
    ts_gt = is_ts & (ids[None, :] > first_ok)

    m0 = (is_species | is_ts | is_eot)[None, :]
    m1 = is_digit[None, :]
    m2 = is_digit[None, :] | ts_gt
    m3 = is_eot[None, :] | ts_geq
    mode = mode[:, None]
    return torch.where(mode == 0, m0, torch.where(
        mode == 1, m1, torch.where(mode == 2, m2, m3)))


def _grammar_step(mode: torch.Tensor, last_col: torch.Tensor,
                  token: torch.Tensor, n_extra: int = 0):
    """Advance (mode, last_col) given the emitted tokens [B]."""
    is_digit = _is_digit(token, n_extra)
    is_ts = (token >= _TS0) & (token < _TS1)
    col = torch.where(is_ts, token - _TS0, last_col)
    opens = (mode == 0) | (mode == 3)
    new_mode = torch.where(
        is_ts, torch.where(opens, 1, 3),            # ts opens or closes a span
        torch.where(is_digit, 2, mode))             # digits stay in the span
    return new_mode, col


def _nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask the tokens outside the smallest set whose probability reaches
    ``top_p`` (HF semantics: the most probable token always survives)."""
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p, sort_idx = _topk(probs, probs.shape[-1])
    cum = torch.cumsum(sorted_p, dim=-1)
    keep_sorted = (cum - sorted_p) < top_p          # mass before the token
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits.float(), NEG_INF)


def gumbel_noise(generator: torch.Generator) -> Noise:
    """Standard Gumbel noise drawn from ``generator`` (which must live on the
    device asked for), as ``jax.random.gumbel`` makes it:
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(shape, device):
        u = torch.rand(shape, generator=generator, device=device)
        return -torch.log(-torch.log(u.clamp_min(tiny)))
    return draw


def samples(top_k: int, top_p: float) -> bool:
    """Whether greedy decoding with these filters samples (else argmax)."""
    return top_k > 1 or float(top_p) < 1.0


def _sample_or_argmax(logits: torch.Tensor, top_k: int, top_p: float,
                      noise: Optional[Noise]) -> torch.Tensor:
    """logits [B, V] -> tokens [B]. Greedy when neither filter is active;
    otherwise Gumbel-max over the (top_k ∩ nucleus) filtered distribution
    (the filters compose, as in HF)."""
    if not samples(top_k, top_p):
        return torch.argmax(logits, dim=-1)
    logits = logits.float()
    if top_p < 1.0:
        logits = _nucleus_filter(logits, top_p)
    if top_k > 1:
        vals, idxs = _topk(logits, top_k)
        choice = torch.argmax(vals + noise(vals.shape, vals.device), dim=-1)
        return torch.gather(idxs, 1, choice[:, None])[:, 0]
    return torch.argmax(logits + noise(logits.shape, logits.device), dim=-1)


@torch.no_grad()
def generate(params, cfg: WhisperConfig, features=None, max_length: int = 448,
             num_beams: int = 1, top_k: int = 1, top_p: float = 1.0,
             length_penalty: float = 1.0, constrained: bool = False,
             int8_kv: bool = False, enc_out=None,
             noise: Optional[Noise] = None,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Features [B, num_mel_bins, T] (or a ready ``enc_out`` [B, S, D]) ->
    token ids [B, max_length] (prompt included, PAD-padded). ``int8_kv``
    keeps the cross-attention K/V in int8 (ops/cross_attention.py).
    ``noise`` gives the Gumbel noise of sampling, one call a step (default:
    a ``torch.Generator`` seeded with 0 on the encoder output's device).
    An ``audio_lm`` decoder decodes by beam search only; its search adds
    the expert load to ``stats`` where given (one host read)."""
    _check_family(cfg, num_beams, int8_kv)
    if enc_out is None:
        enc_out = encoder_forward(params, cfg, features)
    if num_beams <= 1:
        if noise is None and samples(top_k, top_p):
            noise = gumbel_noise(
                torch.Generator(device=enc_out.device).manual_seed(0))
        return _generate_greedy(params, cfg, enc_out, max_length, int8_kv,
                                top_k, top_p, constrained, noise)
    return _generate_beam(params, cfg, enc_out, max_length, num_beams,
                          length_penalty, int8_kv, stats)


def _check_family(cfg: WhisperConfig, num_beams: int, int8_kv: bool) -> None:
    """Raise for what the config's decoder family cannot decode: an
    ``audio_lm`` decoder decodes by beam search alone (num_beams > 1) and
    has no cross-attention K/V."""
    if cfg.decoder_family == "whisper":
        return
    if num_beams <= 1:
        raise ValueError("an audio_lm decoder decodes by beam search only "
                         "(num_beams > 1): greedy search, sampling and "
                         "speculative decoding are not supported")
    if int8_kv:
        raise ValueError("an audio_lm decoder has no cross-attention K/V to "
                         "keep in int8 (int8_kv)")


def _prompt(rows: int, device) -> torch.Tensor:
    return torch.tensor(tok.PROMPT_IDS, device=device).expand(rows, -1)


def _generate_greedy(params, cfg, enc_out, max_length: int,
                     int8_kv: bool = False, top_k: int = 1, top_p: float = 1.0,
                     constrained: bool = False,
                     noise: Optional[Noise] = None) -> torch.Tensor:
    batch, device = enc_out.shape[0], enc_out.device
    seq_len = enc_out.shape[1]
    prompt = _prompt(batch, device)
    pl = prompt.shape[1]
    xk, xv = precompute_cross_kv(params, cfg, enc_out, int8_kv=int8_kv)
    ck, cv = init_cache(cfg, batch, max_length, device)
    tokens = torch.full((batch, max_length), tok.PAD_ID, dtype=torch.long,
                        device=device)
    tokens[:, :pl] = prompt
    mode = torch.zeros(batch, dtype=torch.long, device=device)
    last_col = torch.zeros(batch, dtype=torch.long, device=device)
    n_extra = len(cfg.extra_tokens)

    def pick(logits, mode, last_col):
        if constrained:
            mask = _grammar_mask(mode, last_col, cfg.vocab_size, n_extra)
            logits = torch.where(mask, logits.float(), NEG_INF)
        nxt = _sample_or_argmax(logits, top_k, top_p, noise)
        return (nxt, *_grammar_step(mode, last_col, nxt, n_extra))

    logits, ck, cv = decoder_step(params, cfg, xk, xv, prompt, 0, ck, cv,
                                  cross_seq_len=seq_len)
    cur, mode, last_col = pick(logits[:, -1], mode, last_col)
    finished = cur == tok.EOT_ID
    tokens[:, pl] = cur
    pos = pl
    while pos + 1 < max_length:
        with profiling.span("decode.step") as step:
            if bool(finished.all()):
                step.drop()
                break
            logits, ck, cv = decoder_step(params, cfg, xk, xv, cur[:, None],
                                          pos, ck, cv, cross_seq_len=seq_len)
            cur, mode, last_col = pick(logits[:, -1], mode, last_col)
            cur = torch.where(finished, tok.PAD_ID, cur)
            finished = finished | (cur == tok.EOT_ID)
            tokens[:, pos + 1] = cur
            pos += 1
    return tokens


# --------------------------------------------------------------- speculative


@torch.no_grad()
def generate_speculative(params, cfg: WhisperConfig, draft_params,
                         draft_cfg: WhisperConfig, features: torch.Tensor,
                         max_length: int = 448, spec_k: int = 4, enc_out=None,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy speculative decoding: the draft model proposes ``spec_k``
    tokens an iteration, the target verifies them in one forward over the
    chunk ``[cur, d_1 .. d_k]``, and the longest matching prefix plus the
    target's own next token are committed. The result is the target's greedy
    transcript as chunked verification forwards compute it (in bf16 a chunk's
    products sum in another order than single-token steps, so a near tie may
    turn); the acceptance rate only moves the speed.

    Cache slots are decoupled from sequence positions (``decoder_step``'s
    slot mode): every iteration takes ``spec_k + 1`` slots at one cursor for
    all rows, each row's history lives in a ``slot_valid`` map (rejected
    drafts stay masked) and its true position in ``tp``. The draft runs
    ``spec_k + 1`` single-token steps an iteration, the last one ingesting
    its own final draft, so that every committed token's K/V is in both
    caches. Both encoders read the same ``features`` [B, mel, T]; ``enc_out``
    is the target's encoder output when the caller has it. The loop ends
    when every row has finished (read on the host once an iteration) or the
    slots run out. ``stats``, when given, gains ``verify_forwards`` (the
    target's chunk forwards) and ``committed`` (tokens committed, a device
    scalar)."""
    if "audio_lm" in (cfg.decoder_family, draft_cfg.decoder_family):
        raise ValueError("speculative decoding runs Whisper decoders only, "
                         "not an audio_lm decoder")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("the draft and the target must share the vocabulary")
    k = spec_k
    enc_t = (encoder_forward(params, cfg, features) if enc_out is None
             else enc_out)
    enc_d = encoder_forward(draft_params, draft_cfg, features)
    batch, s_t = enc_t.shape[:2]
    s_d = enc_d.shape[1]
    device = enc_t.device
    xk_t, xv_t = precompute_cross_kv(params, cfg, enc_t)
    xk_d, xv_d = precompute_cross_kv(draft_params, draft_cfg, enc_d)

    prompt = _prompt(batch, device)
    pl = prompt.shape[1]
    max_slots = pl + (max_length - pl) * (k + 1)
    ck_t, cv_t = init_cache(cfg, batch, max_slots, device)
    ck_d, cv_d = init_cache(draft_cfg, batch, max_slots, device)
    tokens = torch.full((batch, max_length), tok.PAD_ID, dtype=torch.long,
                        device=device)
    tokens[:, :pl] = prompt

    # prefill both models (slots are positions for the prompt)
    logits, ck_t, cv_t = decoder_step(params, cfg, xk_t, xv_t, prompt, 0,
                                      ck_t, cv_t, cross_seq_len=s_t)
    decoder_step(draft_params, draft_cfg, xk_d, xv_d, prompt, 0, ck_d, cv_d,
                 cross_seq_len=s_d)
    cur = torch.argmax(logits[:, -1].float(), dim=-1)
    tokens[:, pl] = cur
    finished = cur == tok.EOT_ID
    tp = torch.full((batch,), pl + 1, dtype=torch.long, device=device)
    cols_s = torch.arange(max_slots, device=device)
    slot_valid = (cols_s < pl)[None].repeat(batch, 1)
    cols_k = torch.arange(k + 1, device=device)
    cols_len = torch.arange(max_length, device=device)
    pad = torch.full((batch, 1), tok.PAD_ID, dtype=torch.long, device=device)
    committed = torch.zeros((), dtype=torch.long, device=device)
    row_forwards = torch.zeros((), dtype=torch.long, device=device)
    forwards = 0

    slot0 = pl
    while slot0 + k + 1 <= max_slots:
        with profiling.span("decode.step") as step:
            if bool(finished.all()):
                step.drop()
                break
            # draft: k proposals, then one step that ingests the last of them
            x_j, drafts = cur, []
            for j in range(k + 1):
                spec_prefix = (cols_s >= slot0) & (cols_s < slot0 + j)
                dl, ck_d, cv_d = decoder_step(
                    draft_params, draft_cfg, xk_d, xv_d, x_j[:, None],
                    slot0 + j, ck_d, cv_d, cross_seq_len=s_d,
                    truepos=tp - 1 + j,
                    slot_valid=slot_valid | spec_prefix[None])
                x_j = torch.argmax(dl[:, -1].float(), dim=-1)
                if j < k:
                    drafts.append(x_j)
            drafts = torch.stack(drafts, dim=1)                    # [B, k]

            # verify: one target forward over [cur, d_1 .. d_k]
            chunk = torch.cat([cur[:, None], drafts], dim=1)       # [B, k+1]
            tl, ck_t, cv_t = decoder_step(
                params, cfg, xk_t, xv_t, chunk, slot0, ck_t, cv_t,
                cross_seq_len=s_t, truepos=tp - 1, slot_valid=slot_valid)
            forwards += 1
            g = torch.argmax(tl.float(), dim=-1)                   # [B, k+1]

            # the longest matching prefix, then the target's own next token
            accepted = torch.cumprod((drafts == g[:, :k]).long(),
                                     dim=1).sum(dim=1)
            bonus = torch.gather(g, 1, accepted[:, None])[:, 0]
            commit = torch.where(
                cols_k[None] < accepted[:, None],
                torch.cat([drafts, pad], dim=1),
                torch.where(cols_k[None] == accepted[:, None], bonus[:, None],
                            tok.PAD_ID))                           # [B, k+1]

            # commits stop at (and include) the first EOT, and at the budget
            is_eot = commit == tok.EOT_ID
            any_eot = is_eot.any(dim=1)
            first_eot = torch.argmax(is_eot.int(), dim=1)
            count = torch.where(any_eot, first_eot + 1, accepted + 1)
            count = torch.where(finished, 0, count)
            count = torch.minimum(count, max_length - tp)

            # committed tokens at each row's true positions
            rel = (cols_len[None] - tp[:, None]).clamp(0, k)
            vals = torch.gather(commit, 1, rel)                    # [B, L]
            write = (cols_len[None] >= tp[:, None]) & \
                (cols_len[None] < (tp + count)[:, None])
            tokens = torch.where(write, vals, tokens)

            # the slots of cur and of the committed drafts become history
            n_drafts = torch.minimum(accepted, count)
            slot_valid = slot_valid | (
                (cols_s[None] >= slot0)
                & (cols_s[None] <= slot0 + n_drafts[:, None])
                & ~finished[:, None])
            committed = committed + count.sum()
            row_forwards = row_forwards + (~finished).sum()
            finished = finished | any_eot | (tp + count >= max_length)
            cur = torch.where(finished, tok.PAD_ID, bonus)
            tp = tp + count
            slot0 += k + 1
    if stats is not None:
        stats["verify_forwards"] = stats.get("verify_forwards", 0) + forwards
        stats["row_forwards"] = stats.get("row_forwards", 0) + row_forwards
        stats["committed"] = stats.get("committed", 0) + committed
    return tokens


# ---------------------------------------------------------------------- beam


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_rows(beam_idx: torch.Tensor, batch: int, k: int) -> torch.Tensor:
    """[B, K'] within-batch beam indices -> flat row indices of a B*K axis."""
    offs = torch.arange(batch, device=beam_idx.device)[:, None] * k
    return (beam_idx + offs).reshape(-1)


def _beam_candidates(total: torch.Tensor, k: int, vocab: int):
    """total [B, P*V] summed log-probs -> top-2K (scores, parent, token).
    2K candidates leave >= K non-EOT continuations, so the live set never
    starves while EOT candidates move to the bank."""
    scores, flat = _topk(total, 2 * k)
    return scores, flat // vocab, flat % vocab


def _bank_merge(bank_scores, bank_tokens, cand_scores, cand_tokens):
    """Keep the K best of (bank ∪ candidates) per sequence; scores are already
    length-penalised. [B, K], [B, K, L], [B, C], [B, C, L] -> bank."""
    k = bank_scores.shape[1]
    all_scores = torch.cat([bank_scores, cand_scores], dim=1)
    all_tokens = torch.cat([bank_tokens, cand_tokens], dim=1)
    new_scores, idx = _topk(all_scores, k)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return new_scores, all_tokens[rows, idx]


def _keep_going(live_scores, lengths, bank_scores, lp_pow: float):
    """A 0-dim bool tensor: whether some sequence may still improve. A
    sequence is done when no live beam's length-normalised score can still
    beat its worst banked hypothesis (HF's early_stopping=False heuristic;
    empty bank slots sit at NEG_INF)."""
    best_live = (live_scores / lengths.to(torch.float32) ** lp_pow).amax(dim=1)
    worst_bank = bank_scores.amin(dim=1)
    return (best_live > worst_bank).any()


# ------------------------------------------------------------ decoder families


class _Whisper:
    """Whisper's decoder: cross K/V for every row (each beam its copy of its
    window's) and the self-attention cache ``ck`` / ``cv``."""
    CACHE = ("ck", "cv")

    @staticmethod
    def leaves(params) -> list:
        dec = params["decoder"]
        return ([v for name, v in dec.items() if name != "layers"]
                + list(dec["layers"].values()))

    @staticmethod
    def static_bytes(cfg, batch: int, k: int, max_length: int,
                     seq_len: int) -> int:
        per_pos = (cfg.decoder_layers * batch * k * cfg.kv_heads * cfg.head_dim
                   * torch.empty((), dtype=compute_dtype(cfg)).element_size())
        return 2 * per_pos * (seq_len + max_length)

    @staticmethod
    def buffers(cfg, device, batch: int, k: int, max_length: int,
                seq_len: int):
        shape = (cfg.decoder_layers, batch * k, seq_len, cfg.kv_heads,
                 cfg.head_dim)
        xk = torch.empty(shape, dtype=compute_dtype(cfg), device=device)
        ck, cv = init_cache(cfg, batch * k, max_length, device)
        return (xk, torch.empty_like(xk)), {"ck": ck, "cv": cv}

    @staticmethod
    def prefill(params, cfg, enc_out, k: int, max_length: int, int8_kv: bool,
                buffers):
        batch, device = enc_out.shape[0], enc_out.device
        seq_len = enc_out.shape[1]
        # encoder state expanded to B*K rows, beam-major within each batch
        # item; beams reorder the self-attention cache only, never these
        xk, xv = precompute_cross_kv(
            params, cfg, enc_out.repeat_interleave(k, dim=0), int8_kv=int8_kv,
            out=None if buffers is None else buffers[0])
        if buffers is None:
            ck, cv = init_cache(cfg, batch * k, max_length, device)
        else:
            ck, cv = buffers[1]["ck"].zero_(), buffers[1]["cv"].zero_()
        logits, ck, cv = decoder_step(params, cfg, xk, xv,
                                      _prompt(batch * k, device), 0, ck, cv,
                                      cross_seq_len=seq_len)
        return (xk, xv, seq_len), {"ck": ck, "cv": cv}, logits[:, -1]

    @staticmethod
    def step(params, cfg, memory, cache, cur, pos):
        xk, xv, seq_len = memory
        logits, ck, cv = decoder_step(params, cfg, xk, xv, cur[:, None], pos,
                                      cache["ck"], cache["cv"],
                                      cross_seq_len=seq_len)
        return logits[:, -1], {"ck": ck, "cv": cv}

    @staticmethod
    def count(memory, stats: dict) -> None:
        pass


def _tree_leaves(node) -> list:
    if isinstance(node, dict):
        return [leaf for v in node.values() for leaf in _tree_leaves(v)]
    return [node]


class _AudioLM:
    """The audio LM (models/audio_lm.py): the prefix cache of each window,
    written by its prefill and shared by its beams; the generated tokens'
    cache ``kv`` [L, B*K, max_length - prompt, r + dr]; and the expert load
    summed on the device, [prefill, decode] x [routed pairs, experts that
    got any, the busiest expert's pairs], read once after the search."""
    CACHE = ("kv",)
    LOAD = ("routed", "experts", "busiest")

    @staticmethod
    def leaves(params) -> list:
        return _tree_leaves(params["lm"])

    @staticmethod
    def static_bytes(cfg, batch: int, k: int, max_length: int,
                     seq_len: int) -> int:
        c = audio_lm.lm_config(cfg)
        pl = audio_lm.prompt_length()
        item = torch.empty((), dtype=compute_dtype(cfg)).element_size()
        return (c.num_hidden_layers * c.latent * item
                * batch * (seq_len + pl + k * (max_length - pl)))

    @staticmethod
    def buffers(cfg, device, batch: int, k: int, max_length: int,
                seq_len: int):
        c = audio_lm.lm_config(cfg)
        pl = audio_lm.prompt_length()
        prefix = torch.empty((c.num_hidden_layers, batch, seq_len + pl,
                              c.latent), dtype=compute_dtype(cfg),
                             device=device)
        load = torch.zeros((2, 3), dtype=torch.long, device=device)
        return (prefix, load), {"kv": audio_lm.init_cache(
            cfg, batch * k, max_length - pl, device)}

    @staticmethod
    def prefill(params, cfg, enc_out, k: int, max_length: int, int8_kv: bool,
                buffers):
        batch, device = enc_out.shape[0], enc_out.device
        pl = audio_lm.prompt_length()
        with profiling.span("segment.prefill", windows=batch) as span:
            if buffers is None:
                prefix, load = None, torch.zeros((2, 3), dtype=torch.long,
                                                 device=device)
                cache = audio_lm.init_cache(cfg, batch * k, max_length - pl,
                                            device)
            else:
                (prefix, load), cache = buffers[0], buffers[1]["kv"]
                load.zero_()
                cache.zero_()
            logits, prefix = audio_lm.prefill(params, cfg, enc_out, out=prefix,
                                              load=load[0])
            span.settle(device)
        return (prefix, load), {"kv": cache}, logits

    @staticmethod
    def step(params, cfg, memory, cache, cur, pos):
        prefix, load = memory
        logits = audio_lm.step(params, cfg, prefix, cache["kv"], cur,
                               pos - audio_lm.prompt_length(), load=load[1])
        return logits, cache

    @staticmethod
    def count(memory, stats: dict) -> None:
        rows = memory[1].tolist()
        for phase, row in zip(("prefill", "decode"), rows):
            for name, value in zip(_AudioLM.LOAD, row):
                key = f"{name}_{phase}"
                stats[key] = stats.get(key, 0) + int(value)


_FAMILIES = {"whisper": _Whisper, "audio_lm": _AudioLM}


# ---------------------------------------------------------------------- beam


def _beam_step(params, cfg, family, memory, k: int, lp_pow: float,
               s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One beam-search step from the state ``s`` (``_generate_beam``) at
    its device-side position ``s["pos"]``: the next state. It writes the
    step's cache entries into the family's cache in ``s`` and changes
    nothing else of ``s``, and no shape, launch or host read depends on the
    position or the data, so a CUDA graph can capture it."""
    tokens, pos = s["tokens"], s["pos"]
    rows, max_length = tokens.shape
    batch, vocab = rows // k, cfg.vocab_size
    nxt = pos + 1
    at = nxt.reshape(1)     # the column this step's tokens take
    logits, cache = family.step(params, cfg, memory,
                                {n: s[n] for n in family.CACHE}, s["cur"],
                                pos)
    logp = torch.log_softmax(logits.float(), dim=-1)
    total = s["live_scores"].reshape(-1, 1) + logp                 # [B*K, V]
    c_scores, c_parent, c_tok = _beam_candidates(
        total.reshape(batch, k * vocab), k, vocab)                 # [B, 2K]
    is_eot = c_tok == tok.EOT_ID

    # bank the EOT candidates at their length-penalised score
    cand_len = torch.gather(s["lengths"], 1, c_parent) + 1
    cand_pen = c_scores / cand_len.to(torch.float32) ** lp_pow
    cand_tokens = tokens[_beam_rows(c_parent, batch, k)].reshape(
        batch, 2 * k, max_length)
    cand_tokens.index_copy_(2, at, c_tok[:, :, None])
    bank_scores, bank_tokens = _bank_merge(
        s["bank_scores"], s["bank_tokens"],
        torch.where(is_eot, cand_pen, NEG_INF), cand_tokens)

    # continue with the K best unfinished candidates
    live_scores, lv_idx = _topk(torch.where(is_eot, NEG_INF, c_scores), k)
    lv_parent = torch.gather(c_parent, 1, lv_idx)
    beams = _beam_rows(lv_parent, batch, k)
    tokens = tokens[beams]
    lengths = torch.gather(s["lengths"], 1, lv_parent) + 1
    cur = torch.gather(c_tok, 1, lv_idx).reshape(-1)
    tokens.index_copy_(1, at, cur[:, None])
    return {"tokens": tokens, "bank_scores": bank_scores,
            "bank_tokens": bank_tokens, "live_scores": live_scores,
            "lengths": lengths, "cur": cur,
            **{n: c[:, beams] for n, c in cache.items()}, "pos": nxt,
            "go": _keep_going(live_scores, lengths, bank_scores, lp_pow)}


def _decoder_leaves(params) -> list:
    return (_AudioLM if "lm" in params else _Whisper).leaves(params)


def graph_engages(params, device, int8_kv: bool) -> bool:
    """Whether a beam search replays its steps from a CUDA graph: on a CUDA
    device, with plain (unquantized) decoder weights and float cross K/V.
    The quantized weights' kernels and the int8 cross-attention run
    eagerly; so do greedy search, sampling and speculative decoding, which
    never ask."""
    return (torch.device(device).type == "cuda" and not int8_kv
            and not any(isinstance(w, (QuantTensor, Quant4Tensor))
                        for w in _decoder_leaves(params)))


def _capture(body: Callable[[], None], device) -> Callable[[], None]:
    """Run ``body`` once on a side stream, the warm-up CUDA graph capture
    asks for (it computes a real step), then capture it as a CUDA graph on
    that stream; returns the graph's replay. Captures are taken one at a
    time, each checked on its own thread only, since the mesh path decodes
    on one thread a device."""
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(graph, stream=stream,
                                             capture_error_mode="thread_local"):
            body()
        torch.cuda.current_stream().wait_stream(stream)

    def replay():
        with torch.cuda.device(device):
            graph.replay()
    return replay


class _BeamGraph:
    """One beam-search shape on one device: the decoder family's static
    buffers (what every step reads, and the cache of the generated tokens),
    the search's state, and the CUDA graph of one step over them, captured
    at the first step run and replayed after. ``lock`` is held by the
    search that uses the buffers."""

    def __init__(self, cfg: WhisperConfig, device, batch: int, k: int,
                 max_length: int, seq_len: int):
        family = _FAMILIES[cfg.decoder_family]
        self.device = device
        self.nbytes = family.static_bytes(cfg, batch, k, max_length, seq_len)
        self.buffers = family.buffers(cfg, device, batch, k, max_length,
                                      seq_len)
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self.replay: Optional[Callable[[], None]] = None
        self.lock = threading.Lock()
        self.refs: list = []

    def load(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The state after the seed step copied into the static buffers
        (the caches are the static ones already); returns those."""
        if self.state is None:
            own = list(self.buffers[1].values())
            self.state = {n: t if any(t is c for c in own)
                          else torch.empty_like(t) for n, t in state.items()}
        for n, t in state.items():
            if t is not self.state[n]:
                self.state[n].copy_(t)
        return self.state

    def step(self, fn: Callable[[Dict], Dict]) -> None:
        """One step ``fn`` over the static state: the graph's replay, or
        its capture, whose warm-up runs the step."""
        if self.replay is not None:
            self.replay()
            return

        def body():
            for n, t in fn(self.state).items():
                self.state[n].copy_(t)
        self.replay = _capture(body, self.device)


def _static_bytes(cfg: WhisperConfig, rows: int, max_length: int,
                  seq_len: int, k: int = 1) -> int:
    """The bytes of a graph's static buffers: what every step reads and
    the caches (Whisper's cross K/V and self-attention cache), for ``rows``
    = windows x ``k`` beams."""
    return _FAMILIES[cfg.decoder_family].static_bytes(
        cfg, rows // k, k, max_length, seq_len)


def _device_memory(device) -> int:
    return torch.cuda.get_device_properties(device).total_memory


# The beam graphs by device, weights and shape. A graph keeps its static
# buffers between calls: each device keeps its most recently used graphs
# while their static buffers fit in _GRAPH_SHARE of its memory, and a shape
# that alone does not fit runs eagerly. A graph is also dropped when one of
# the weights it reads is freed.
_GRAPHS: "OrderedDict[tuple, _BeamGraph]" = OrderedDict()
_GRAPHS_LOCK = threading.RLock()
_GRAPH_SHARE = 0.25
_CAPTURE_LOCK = threading.Lock()


def _forget(key: tuple) -> None:
    with _GRAPHS_LOCK:
        _GRAPHS.pop(key, None)


def _beam_graph(params, cfg: WhisperConfig, device, batch: int, k: int,
                max_length: int, seq_len: int,
                lp_pow: float) -> Optional[_BeamGraph]:
    """The graph of this shape for these weights (by identity and address)
    on ``device``, made on first use; None where the shape's buffers alone
    exceed the device's share."""
    device = torch.device(device)
    leaves = _FAMILIES[cfg.decoder_family].leaves(params)
    key = (device, tuple((id(w), w.data_ptr()) for w in leaves),
           cfg.decoder_family, cfg.decoder_layers, cfg.num_heads,
           cfg.kv_heads, cfg.vocab_size, cfg.compute_dtype, batch, k,
           max_length, seq_len, lp_pow)
    with _GRAPHS_LOCK:
        graph = _GRAPHS.get(key)
        if graph is not None:
            _GRAPHS.move_to_end(key)
            return graph
        need = _static_bytes(cfg, batch * k, max_length, seq_len, k)
        budget = _GRAPH_SHARE * _device_memory(device)
        if need > budget:
            return None
        held = [(n, g) for n, g in _GRAPHS.items() if g.device == device]
        used = sum(g.nbytes for _, g in held)
        for n, g in held:       # least recently used first
            if used + need <= budget:
                break
            del _GRAPHS[n]
            used -= g.nbytes
        graph = _BeamGraph(cfg, device, batch, k, max_length, seq_len)
        graph.refs = [weakref.ref(w, lambda _ref, key=key: _forget(key))
                      for w in leaves]
        _GRAPHS[key] = graph
    return graph


def _generate_beam(params, cfg, enc_out, max_length: int, num_beams: int,
                   length_penalty: float, int8_kv: bool = False,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """Beam search; its steps replay a CUDA graph where
    :func:`graph_engages`, with the same tokens."""
    device = enc_out.device
    graph = None
    if graph_engages(params, device, int8_kv):
        graph = _beam_graph(params, cfg, device, enc_out.shape[0], num_beams,
                            max_length, enc_out.shape[1],
                            float(length_penalty))
    if graph is None:
        return _beam_search(params, cfg, enc_out, max_length, num_beams,
                            float(length_penalty), int8_kv, None, stats)
    with graph.lock:
        tokens = _beam_search(params, cfg, enc_out, max_length, num_beams,
                              float(length_penalty), int8_kv, graph, stats)
        if device.type == "cuda":   # the buffers are read before the next use
            torch.cuda.current_stream(device).synchronize()
    return tokens


def _beam_search(params, cfg, enc_out, max_length: int, k: int,
                 lp_pow: float, int8_kv: bool, graph: Optional[_BeamGraph],
                 stats: Optional[dict] = None) -> torch.Tensor:
    family = _FAMILIES[cfg.decoder_family]
    batch, device = enc_out.shape[0], enc_out.device
    vocab = cfg.vocab_size
    f32 = torch.float32

    memory, cache, logits = family.prefill(
        params, cfg, enc_out, k, max_length, int8_kv,
        None if graph is None else graph.buffers)
    prompt = _prompt(batch * k, device)
    pl = prompt.shape[1]
    tokens = torch.full((batch * k, max_length), tok.PAD_ID, dtype=torch.long,
                        device=device)
    tokens[:, :pl] = prompt
    logp = torch.log_softmax(logits.float(), dim=-1)
    logp0 = logp.reshape(batch, -1, vocab)[:, 0]  # beams identical at step 0

    # seed step: one virtual parent; split the top-2K into bank and live
    c_scores, _, c_tok = _beam_candidates(logp0, k, vocab)        # [B, 2K]
    is_eot = c_tok == tok.EOT_ID
    cand_tokens = tokens.reshape(batch, k, max_length)[:, :1].expand(
        batch, 2 * k, max_length).clone()
    cand_tokens[:, :, pl] = c_tok
    bank_scores, bank_tokens = _bank_merge(
        torch.full((batch, k), NEG_INF, dtype=f32, device=device),
        torch.full((batch, k, max_length), tok.PAD_ID, dtype=torch.long,
                   device=device),
        torch.where(is_eot, c_scores, NEG_INF), cand_tokens)   # len 1: 1**p == 1

    live_scores, lv_idx = _topk(torch.where(is_eot, NEG_INF, c_scores), k)
    cur = torch.gather(c_tok, 1, lv_idx).reshape(-1)
    tokens[:, pl] = cur
    lengths = torch.ones((batch, k), dtype=torch.long, device=device)
    s = {"tokens": tokens, "bank_scores": bank_scores,
         "bank_tokens": bank_tokens, "live_scores": live_scores,
         "lengths": lengths, "cur": cur, **cache,
         "pos": torch.full((), pl, dtype=torch.long, device=device),
         "go": _keep_going(live_scores, lengths, bank_scores, lp_pow)}
    if graph is not None:
        s = graph.load(s)

    def step(state):
        return _beam_step(params, cfg, family, memory, k, lp_pow, state)

    for _ in range(pl, max_length - 1):     # the step at each position
        graphed = graph is not None and graph.replay is not None
        with profiling.span("decode.step", graphed=int(graphed)) as span:
            if not bool(s["go"]):
                span.drop()
                break
            if graph is None:
                s = step(s)
            else:
                graph.step(step)

    # best of bank ∪ live (live covers budget exhaustion before K finish)
    live_pen = s["live_scores"] / s["lengths"].to(f32) ** lp_pow
    all_scores = torch.cat([s["bank_scores"], live_pen], dim=1)
    all_tokens = torch.cat([s["bank_tokens"],
                            s["tokens"].reshape(batch, k, max_length)], dim=1)
    best = torch.argmax(all_scores, dim=1)
    out = all_tokens[torch.arange(batch, device=device), best]
    if stats is not None:
        family.count(memory, stats)
    return out
