"""Offline frame-VAD segmentation: ``Segmenter.segment_from_frames()`` (the
encoder and the frame head, no decoder) on one recording at a time, back to
back, with the checkpoint's fitted defaults. End-to-end: ``audio_s_per_s``,
as in the segment entry."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .. import check, program, traffic
from ..common import ROOT
from ..reference import frontend as rf


def run(ctx) -> dict:
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    sr, seconds_each = mix["sr"], float(mix["recording_s"])
    seg = program.build_segmenter(model, ctx.seed, device,
                                  inference_dtype=model["inference_dtype"])
    pool = [traffic.recording(ctx.seed, i, sr, seconds_each)
            for i in range(int(mix["pool"]))]
    audio = [program.as_float(p) for p in pool]
    kwargs = {"sr": sr, "batch_size": mix["batch_size"],
              "spec_time_step": mix["spec_time_step"],
              "min_frequency": mix["min_frequency"]}
    seg.segment_from_frames(audio[-1], **kwargs)    # builds, warms the shape
    program.sync(device)
    setup_s = time.perf_counter() - ctx.t_start
    tables = {}

    def call(i, k):
        seg.tag(i)
        tables[i] = seg.segment_from_frames(audio[k], **kwargs)

    spans, tracer, traced, window = program.back_to_back(
        ctx, call, len(pool), int(mix["trace_requests"]))
    wall = (spans[-1][3] - spans[0][2]) / 1e9
    out = {"e2e": {"audio_s_per_s": len(spans) * seconds_each / wall,
                   "setup_s": setup_s},
           "attempted": len(spans), "failed": 0,
           "memory_peak": program.memory_peak(device),
           "window_s": window}
    frames = {key: rec["frames"] for key, rec in seg.records.items()}
    if tracer is not None:
        out["trace"] = tracer
        out["work"] = _work(ctx, spans[:traced])
    del seg
    program.release()
    out["check"] = _check(ctx, spans, frames, tables, pool)
    return out


def _n_windows(mix, model) -> int:
    clip = int(model["total_spec_columns"] * mix["spec_time_step"] * mix["sr"])
    return -(-int(mix["recording_s"] * mix["sr"]) // clip)


def _work(ctx, spans) -> dict:
    from ..roofline import encoder_flops, frame_head_flops

    model, mix = ctx.cell.model, ctx.cell.mix
    cols = model["total_spec_columns"]
    windows = len(spans) * _n_windows(mix, model)
    return {"requests": [(a, b) for _i, _k, a, b in spans],
            "windows": windows,
            "model_flops": windows * (encoder_flops(model, cols)
                                      + frame_head_flops(model, cols)),
            "encoder_batch": mix["batch_size"]}


def tail_settings(model: dict, mix: dict) -> dict:
    """The frame mode's settings as the checkpoint's file states them (its
    fitted thresholds, else the mode's documented defaults), for the
    reference host tail."""
    with open(os.path.join(ROOT, model["checkpoint"], "config.json")) as f:
        conf = json.load(f)
    dsc = conf.get("default_segmentation_config", {})
    names = {int(v): k for k, v in conf.get("cluster_codebook", {}).items()}
    return {"names": names,
            "vocal_threshold": dsc.get("frame_vocal_threshold", 0.5),
            "cut_threshold": dsc.get("frame_cut_threshold", 0.5),
            "boundary_snap": int(dsc.get("frame_boundary_snap", 2)),
            "gap_cut": int(dsc.get("frame_gap_cut", 0)),
            "min_segment_length": mix["spec_time_step"] * 2,
            "precision_bits": 3}


def _check(ctx, spans, frames, tables, pool) -> dict:
    """A sample of the completed recordings drawn from the seed, every
    window of each (so every row of every batch): the served frame
    probabilities against the reference's, and the returned tables against
    the reference host tail's over the served outputs."""
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    per = _n_windows(mix, model)
    bad = {"frame_track_median": float("inf"),
           "table_mismatch": float("inf")}
    rng = np.random.RandomState(traffic.derived(ctx.seed, 9))
    want = min(int(mix["check_recordings"]), len(spans))
    pick = sorted(rng.permutation(len(spans))[:want])
    windows, probs, served, returned = [], [], [], []
    for c in pick:
        i, k = spans[c][0], spans[c][1]
        if i not in frames or i not in tables:
            return bad
        got = np.concatenate([p for p, _cl in frames[i]])
        cl = np.concatenate([ids for _p, ids in frames[i]])
        ref = rf.sliding_windows(rf.pcm16_to_float(pool[k]), mix["sr"],
                                 mix["spec_time_step"],
                                 model["total_spec_columns"], 1)
        if got.shape[0] < per or len(ref) != per:
            return bad
        windows.extend(ref)
        probs.extend(got[:per])
        served.append((got[:per], cl[:per], len(pool[k]) / mix["sr"]))
        returned.append(tables[i])
    weights = program.reference_weights(model, ctx.seed, device)
    out = check.frame_gap(weights, model, np.stack(windows), np.stack(probs),
                          mix["sr"], mix["spec_time_step"],
                          mix["min_frequency"], device,
                          control=ctx.options.get("control", False))
    out.update(check.table_mismatch(served, returned,
                                    tail_settings(model, mix),
                                    mix["spec_time_step"], mix["sr"]))
    out["windows"] = len(windows)
    return out
