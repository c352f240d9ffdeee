"""Batched autoregressive generation: greedy search and banked beam search.

The port of ``whisperseg_tpu/decode.py`` (``generate``, ``_generate_greedy``,
``_generate_beam``). JAX's ``lax.while_loop`` becomes a Python loop that
exits early; its condition is read on the host once per step.

Beam search is the static banked formulation: each step takes the top-2K
candidates, finished (EOT) candidates move to a per-sequence bank of the K
best hypotheses by ``score / length**length_penalty``, and the K live slots
keep exploring unfinished continuations. The result is the best of the bank
and the length-penalised live set. Every top-k breaks ties toward the lower
index, as ``lax.top_k`` does (``torch.topk`` promises no order).
"""

from __future__ import annotations

import torch

from . import tokenizer as tok
from .models.config import WhisperConfig
from .models.whisper import (decoder_step, encoder_forward, init_cache,
                             precompute_cross_kv)

NEG_INF = -1e30


def check_decode_options(top_k: int, top_p: float, constrained: bool
                         ) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP.md item that will
    bring it, for a decoding option this port does not have yet."""
    if top_k > 1 or top_p < 1.0:
        raise NotImplementedError(
            "sampling (top_k > 1 or top_p < 1) is not ported yet: ROADMAP.md "
            "Queue A item 8 (sampling and constrained decoding)")
    if constrained:
        raise NotImplementedError(
            "constrained decoding is not ported yet: ROADMAP.md Queue A item 8 "
            "(sampling and constrained decoding)")


@torch.no_grad()
def generate(params, cfg: WhisperConfig, features=None, max_length: int = 448,
             num_beams: int = 1, top_k: int = 1, top_p: float = 1.0,
             length_penalty: float = 1.0, constrained: bool = False,
             int8_kv: bool = False, enc_out=None) -> torch.Tensor:
    """Features [B, num_mel_bins, T] (or a ready ``enc_out`` [B, S, D]) ->
    token ids [B, max_length] (prompt included, PAD-padded). ``int8_kv``
    keeps the cross-attention K/V in int8 (ops/cross_attention.py)."""
    check_decode_options(top_k, top_p, constrained)
    if enc_out is None:
        enc_out = encoder_forward(params, cfg, features)
    if num_beams <= 1:
        return _generate_greedy(params, cfg, enc_out, max_length, int8_kv)
    return _generate_beam(params, cfg, enc_out, max_length, num_beams,
                          length_penalty, int8_kv)


def _prompt(rows: int, device) -> torch.Tensor:
    return torch.tensor(tok.PROMPT_IDS, device=device).expand(rows, -1)


def _generate_greedy(params, cfg, enc_out, max_length: int,
                     int8_kv: bool = False) -> torch.Tensor:
    batch, device = enc_out.shape[0], enc_out.device
    seq_len = enc_out.shape[1]
    prompt = _prompt(batch, device)
    pl = prompt.shape[1]
    xk, xv = precompute_cross_kv(params, cfg, enc_out, int8_kv=int8_kv)
    ck, cv = init_cache(cfg, batch, max_length, device)
    tokens = torch.full((batch, max_length), tok.PAD_ID, dtype=torch.long,
                        device=device)
    tokens[:, :pl] = prompt

    logits, ck, cv = decoder_step(params, cfg, xk, xv, prompt, 0, ck, cv,
                                  cross_seq_len=seq_len)
    cur = torch.argmax(logits[:, -1], dim=-1)
    finished = cur == tok.EOT_ID
    tokens[:, pl] = cur
    pos = pl
    while pos + 1 < max_length and not bool(finished.all()):
        logits, ck, cv = decoder_step(params, cfg, xk, xv, cur[:, None], pos,
                                      ck, cv, cross_seq_len=seq_len)
        cur = torch.argmax(logits[:, -1], dim=-1)
        cur = torch.where(finished, tok.PAD_ID, cur)
        finished = finished | (cur == tok.EOT_ID)
        tokens[:, pos + 1] = cur
        pos += 1
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

    while pos + 1 < max_length and keep_going():
        logits, ck, cv = decoder_step(params, cfg, xk, xv, cur[:, None], pos,
                                      ck, cv, cross_seq_len=seq_len)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        total = live_scores.reshape(-1, 1) + logp                  # [B*K, V]
        c_scores, c_parent, c_tok = _beam_candidates(
            total.reshape(batch, k * vocab), k, vocab)             # [B, 2K]
        is_eot = c_tok == tok.EOT_ID

        # bank the EOT candidates at their length-penalised score
        cand_len = torch.gather(lengths, 1, c_parent) + 1
        cand_pen = c_scores / cand_len.to(f32) ** lp_pow
        cand_tokens = tokens[_beam_rows(c_parent, batch, k)].reshape(
            batch, 2 * k, max_length)
        cand_tokens[:, :, pos + 1] = c_tok
        bank_scores, bank_tokens = _bank_merge(
            bank_scores, bank_tokens, torch.where(is_eot, cand_pen, NEG_INF),
            cand_tokens)

        # continue with the K best unfinished candidates
        live_scores, lv_idx = _topk(torch.where(is_eot, NEG_INF, c_scores), k)
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
