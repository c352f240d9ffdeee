"""Offline segmentation: ``Segmenter.segment()`` on one recording at a time,
back to back, for the window. End-to-end: ``audio_s_per_s``, the audio
seconds of every recording completed over the time from the first one's
start to the last one's end (no recording starts after the window)."""

from __future__ import annotations

import time

import numpy as np

from .. import check, program, traffic
from ..reference import frontend as rf


def _kwargs(mix: dict) -> dict:
    keys = ("sr", "spec_time_step", "min_frequency", "min_segment_length",
            "eps", "num_trials", "num_beams", "batch_size", "max_length")
    return {k: mix[k] for k in keys if k in mix}


def run(ctx) -> dict:
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    sr, seconds_each = mix["sr"], float(mix["recording_s"])
    # the control runs the program's own lower-precision path in its place
    control = ctx.options.get("program_control", {})
    seg = program.build_segmenter(
        model, ctx.seed, device,
        inference_dtype=control.get("inference_dtype",
                                    model["inference_dtype"]))
    pool = [traffic.recording(ctx.seed, i, sr, seconds_each)
            for i in range(int(mix["pool"]))]
    audio = [program.as_float(p) for p in pool]
    kwargs = dict(_kwargs(mix), **{k: v for k, v in control.items()
                                    if k != "inference_dtype"})
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


def _windows(pcm, mix, model, trials):
    return rf.sliding_windows(rf.pcm16_to_float(pcm), mix["sr"],
                              mix["spec_time_step"],
                              model["total_spec_columns"], trials)


def _tokens(parts):
    return [t for part in parts for t in part]


def _work(ctx, spans, served) -> dict:
    """What the traced requests did, for the per-layer readers."""
    from ..roofline import decoded_window_flops, encoder_flops

    model, mix = ctx.cell.model, ctx.cell.mix
    cols = model["total_spec_columns"]
    windows, flops = 0, 0.0
    for i, _k, _a, _b in spans:
        for tokens in _tokens(served[i]):
            end = check.served_span(tokens, mix["max_length"]) or \
                mix["max_length"]
            flops += encoder_flops(model, cols) + decoded_window_flops(
                model, cols, end - 1, mix["num_beams"])
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
        toks = _tokens(served[i])
        for j, t in enumerate(toks):
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
        ref = cache[k]
        toks = _tokens(served[i])
        if len(toks) != len(ref):   # the program cut another set of windows
            return {"token_gap": float("inf"), "tokens": 0}
        windows.append(ref[j])
        tokens.append(toks[j])
    weights = program.reference_weights(model, ctx.seed, device)
    return check.token_gap(weights, model, np.stack(windows), tokens,
                           mix["num_beams"], mix["max_length"], mix["sr"],
                           mix["spec_time_step"], mix["min_frequency"],
                           device)
