"""Batched autoregressive generation: greedy search, sampling, constrained
decoding, banked beam search and greedy speculative decoding.

The port of ``whisperseg_tpu/decode.py`` (``generate``, ``_generate_greedy``,
``generate_speculative``, ``_generate_beam``, the grammar and the samplers).
JAX's ``lax.while_loop`` becomes a Python loop that exits early; its
condition is read on the host once per step (per iteration, speculative).
Each iteration, from that read to the end of its dispatch, is a
``decode.step`` span (profiling.py).

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

from typing import Callable, Optional

import torch

from . import profiling
from . import tokenizer as tok
from .models.config import WhisperConfig
from .models.whisper import (decoder_step, encoder_forward, init_cache,
                             precompute_cross_kv)

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
             noise: Optional[Noise] = None) -> torch.Tensor:
    """Features [B, num_mel_bins, T] (or a ready ``enc_out`` [B, S, D]) ->
    token ids [B, max_length] (prompt included, PAD-padded). ``int8_kv``
    keeps the cross-attention K/V in int8 (ops/cross_attention.py).
    ``noise`` gives the Gumbel noise of sampling, one call a step (default:
    a ``torch.Generator`` seeded with 0 on the encoder output's device)."""
    if enc_out is None:
        enc_out = encoder_forward(params, cfg, features)
    if num_beams <= 1:
        if noise is None and samples(top_k, top_p):
            noise = gumbel_noise(
                torch.Generator(device=enc_out.device).manual_seed(0))
        return _generate_greedy(params, cfg, enc_out, max_length, int8_kv,
                                top_k, top_p, constrained, noise)
    return _generate_beam(params, cfg, enc_out, max_length, num_beams,
                          length_penalty, int8_kv)


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


def _generate_beam(params, cfg, enc_out, max_length: int, num_beams: int,
                   length_penalty: float, int8_kv: bool = False) -> torch.Tensor:
    batch, device = enc_out.shape[0], enc_out.device
    seq_len = enc_out.shape[1]
    k = num_beams
    vocab = cfg.vocab_size
    lp_pow = float(length_penalty)
    f32 = torch.float32

    # encoder state expanded to B*K rows, beam-major within each batch item;
    # beams reorder the self-attention cache only, never the cross K/V
    xk, xv = precompute_cross_kv(params, cfg,
                                 enc_out.repeat_interleave(k, dim=0),
                                 int8_kv=int8_kv)
    ck, cv = init_cache(cfg, batch * k, max_length, device)
    prompt = _prompt(batch * k, device)
    pl = prompt.shape[1]
    tokens = torch.full((batch * k, max_length), tok.PAD_ID, dtype=torch.long,
                        device=device)
    tokens[:, :pl] = prompt

    logits, ck, cv = decoder_step(params, cfg, xk, xv, prompt, 0, ck, cv,
                                  cross_seq_len=seq_len)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    logp0 = logp.reshape(batch, k, -1)[:, 0]  # beams identical at step 0

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
    pos = pl

    def keep_going() -> bool:
        # a sequence is done when no live beam's length-normalised score can
        # still beat its worst banked hypothesis (HF's early_stopping=False
        # heuristic; empty bank slots sit at NEG_INF)
        best_live = (live_scores / lengths.to(f32) ** lp_pow).amax(dim=1)
        worst_bank = bank_scores.amin(dim=1)
        return bool((best_live > worst_bank).any())

    while pos + 1 < max_length:
        with profiling.span("decode.step") as step:
            if not keep_going():
                step.drop()
                break
            logits, ck, cv = decoder_step(params, cfg, xk, xv, cur[:, None],
                                          pos, ck, cv, cross_seq_len=seq_len)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            total = live_scores.reshape(-1, 1) + logp              # [B*K, V]
            c_scores, c_parent, c_tok = _beam_candidates(
                total.reshape(batch, k * vocab), k, vocab)         # [B, 2K]
            is_eot = c_tok == tok.EOT_ID

            # bank the EOT candidates at their length-penalised score
            cand_len = torch.gather(lengths, 1, c_parent) + 1
            cand_pen = c_scores / cand_len.to(f32) ** lp_pow
            cand_tokens = tokens[_beam_rows(c_parent, batch, k)].reshape(
                batch, 2 * k, max_length)
            cand_tokens[:, :, pos + 1] = c_tok
            bank_scores, bank_tokens = _bank_merge(
                bank_scores, bank_tokens,
                torch.where(is_eot, cand_pen, NEG_INF), cand_tokens)

            # continue with the K best unfinished candidates
            live_scores, lv_idx = _topk(
                torch.where(is_eot, NEG_INF, c_scores), k)
            lv_parent = torch.gather(c_parent, 1, lv_idx)
            rows = _beam_rows(lv_parent, batch, k)
            tokens = tokens[rows]
            ck, cv = ck[:, rows], cv[:, rows]
            lengths = torch.gather(lengths, 1, lv_parent) + 1
            cur = torch.gather(c_tok, 1, lv_idx).reshape(-1)
            tokens[:, pos + 1] = cur
            pos += 1

    # best of bank ∪ live (live covers budget exhaustion before K finish)
    live_pen = live_scores / lengths.to(f32) ** lp_pow
    all_scores = torch.cat([bank_scores, live_pen], dim=1)
    all_tokens = torch.cat([bank_tokens, tokens.reshape(batch, k, max_length)],
                           dim=1)
    best = torch.argmax(all_scores, dim=1)
    return all_tokens[torch.arange(batch, device=device), best]
