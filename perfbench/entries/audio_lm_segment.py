"""Offline segmentation through an audio-LM decoder (the program's
``audio_lm`` family): ``Segmenter.segment()`` on one recording at a time,
back to back, for the window, as ``segment.py`` drives it; the program's
weights are drawn from the seed by ``weights_audio_lm.py``.

End-to-end: ``audio_s_per_s``. ``correct``: ``token_gap``, the reference
(``reference/audio_lm.py`` behind ``reference/model.py``'s encoder) teacher
forced over each sampled window's served tokens, as ``check.py`` judges a
beam's tokens. With ``control`` in the options (``calibrate.py``) the same
windows are judged again by the reference in float8 (``control_*``)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

# the program must have the decoder family: without it the run ends here
from whisperseg_torch.models import audio_lm  # noqa: F401

from .. import check, program, traffic
from .. import weights as wt
from .. import weights_audio_lm as wal
from ..reference import audio_lm as ra
from ..reference import model as rm
from ..reference import targets as rt
from ..roofline import encoder_flops
from ..roofline_moe import decoded_window_flops
from .segment import _kwargs, _tokens, _windows


def build_segmenter(model: dict, seed: int, device):
    """The cell's Segmenter (the harness's recording subclass) over
    weights drawn from ``seed`` on the device in the served type."""
    from whisperseg_torch.segmenter import Segmenter

    dtype = torch.bfloat16 if model["inference_dtype"] == "bfloat16" \
        else torch.float32
    flat = wal.random_weights(model, seed, device, dtype)
    seg = program.recording_class(Segmenter)(
        wt.tree(flat), wal.program_config(model),
        inference_dtype=model["inference_dtype"], device=device)
    del flat
    seg._start_recording()
    return seg


def run(ctx) -> dict:
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    sr, seconds_each = mix["sr"], float(mix["recording_s"])
    seg = build_segmenter(model, ctx.seed, device)
    pool = [traffic.recording(ctx.seed, i, sr, seconds_each)
            for i in range(int(mix["pool"]))]
    audio = [program.as_float(p) for p in pool]
    kwargs = _kwargs(mix)
    seg.segment(audio[-1], **kwargs)        # builds and warms every shape
    program.sync(device)
    setup_s = time.perf_counter() - ctx.t_start

    def call(i, k):
        seg.tag(i)
        seg.segment(audio[k], **kwargs)

    spans, tracer, traced, window = program.back_to_back(
        ctx, call, len(pool), int(mix["trace_requests"]))
    wall = (spans[-1][3] - spans[0][2]) / 1e9
    out = {"e2e": {"audio_s_per_s": len(spans) * seconds_each / wall,
                   "setup_s": setup_s},
           "attempted": len(spans), "failed": 0,
           "memory_peak": program.memory_peak(device),
           "window_s": window}
    served = {key: rec["tokens"] for key, rec in seg.records.items()}
    if tracer is not None:
        out["trace"] = tracer
        out["work"] = _work(ctx, spans[:traced], served)
    del seg
    program.release()
    out["check"] = _check(ctx, spans, served, pool)
    return out


def _work(ctx, spans, served) -> dict:
    """What the traced requests did, for the per-layer readers."""
    model, mix = ctx.cell.model, ctx.cell.mix
    cols = model["total_spec_columns"]
    windows, flops = 0, 0.0
    for i, _k, _a, _b in spans:
        for tokens in _tokens(served[i]):
            end = check.served_span(tokens, mix["max_length"]) or \
                mix["max_length"]
            fed = max(end - 1 - len(rt.PROMPT), 0)
            flops += encoder_flops(model, cols) + decoded_window_flops(
                model, cols, fed, mix["num_beams"])
            windows += 1
    return {"requests": [(a, b) for _i, _k, a, b in spans],
            "windows": windows, "model_flops": flops,
            "encoder_batch": mix["batch_size"]}


def _check(ctx, spans, served, pool) -> dict:
    """A sample of the completed windows drawn from the seed, the window
    with the longest served sequence always in it, against the reference."""
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    cands = []
    for i, k, _a, _b in spans:
        for j, t in enumerate(_tokens(served[i])):
            cands.append((check.served_span(t, mix["max_length"]) or 10 ** 9,
                          i, k, j))
    rng = np.random.RandomState(traffic.derived(ctx.seed, 9))
    want = min(int(mix["check_windows"]), len(cands))
    longest = max(range(len(cands)), key=lambda c: cands[c][0])
    pick = [longest] + [int(c) for c in rng.permutation(len(cands))
                        if c != longest][:want - 1]
    cache, windows, tokens = {}, [], []
    for c in sorted(pick):
        _, i, k, j = cands[c]
        if k not in cache:
            cache[k] = _windows(pool[k], mix, model, mix["num_trials"])
        toks = _tokens(served[i])
        if len(toks) != len(cache[k]):   # another set of windows was cut
            return {"token_gap": math.inf, "tokens": 0}
        windows.append(cache[k][j])
        tokens.append(toks[j])
    weights = wal.reference_weights(model, ctx.seed, device)
    args = (weights, model, np.stack(windows), tokens, mix["num_beams"],
            mix["max_length"], mix["sr"], mix["spec_time_step"],
            mix["min_frequency"], device)
    out = token_gap(*args)
    if ctx.options.get("control"):
        with rm.lower_precision():
            low = token_gap(*args)
        out.update({"control_" + k: v for k, v in low.items()})
    return out


@torch.no_grad()
def token_gap(weights, model: dict, windows: np.ndarray, served, beams: int,
              max_length: int, sr: int, step: float, min_frequency: float,
              device, block: int = 4) -> dict:
    """``check.token_gap`` for an audio LM: each window's encoder states
    (blocks of ``block`` windows), then the LM teacher forced over the
    prompt and the served tokens, one window at a time; the widest
    shortfall of a served token below what the search needed of it, and
    the share of judged tokens with any."""
    rm.no_tf32()
    lm = wal.lm_dict(model)
    bad = {"token_gap": math.inf, "token_off_share": math.inf, "tokens": 0}
    widest, off, judged = 0.0, 0, 0
    pl = len(rt.PROMPT)
    for lo in range(0, len(windows), block):
        feats = check._features(windows[lo:lo + block], sr, step,
                                min_frequency, model["total_spec_columns"],
                                device)
        enc = rm.encoder(weights, feats, model["encoder_layers"],
                         model["encoder_attention_heads"])
        for i, tokens in enumerate(served[lo:lo + block]):
            end = check.served_span(tokens, max_length)
            if end is None or not all(0 <= t < model["vocab_size"]
                                      for t in tokens):
                return bad
            ids = torch.tensor(tokens[:end - 1], device=device)
            logits = ra.logits(weights, lm, enc[i], ids,
                               first=enc.shape[1] + pl - 1)
            for t in range(pl, end):
                gap = check._pick_gap(logits[t - pl], int(tokens[t]), beams)
                widest = max(widest, gap)
                off += int(gap > 0)
                judged += 1
    return {"token_gap": widest, "token_off_share": off / max(judged, 1),
            "tokens": judged}
