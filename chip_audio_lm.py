"""The ``audio_lm`` decoder family's logits on the card at Moonlight-16B-A3B's
published widths (the benchmark configuration ``perfbench/configs/
whisperseg-moonlight-a3b.json``, random weights drawn from a seed) against
the reference's, with a witness of where they part.

The program's beam search (beam 4, 32 tokens) serves 4 windows of tone
bursts; then its prefill logits (every prefix position) and its cached
decode logits (absorbed form, teacher-forced over the served tokens, each
window's row given 4 times so that every product has the search's shape
and its rows repeat the served beam's computation) are held against the
reference's full forward over the same sequence (``perfbench/reference/audio_lm.py``, float32 layer by layer, TF32
off), as |program - reference| in units of the reference logits' standard
deviation: the median over every value, and the largest at a position apart
for the positions at which every expert layer routed the token to the same
experts as the reference ("agreeing") and those at which some layer chose
another ("flipped": a near tie of the router's scores, which a rounding
tips either way). Each served token is judged as the cell's ``token_gap``
judges it (how far its reference logit lies below what the search needed),
apart at the positions that chose it with agreeing and with flipped
routing, and by the program's own teacher-forced logits (0 where they
repeat the search's). The reference in float8 (e4m3) products is read the same way, to
show that the tolerances catch a lower precision. One JSON line:

    python3 chip_audio_lm.py [--seed N]

Runs on the card only."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from perfbench import common, traffic  # noqa: E402
from perfbench import weights as wt  # noqa: E402
from perfbench import weights_audio_lm as wal  # noqa: E402
from perfbench.reference import audio_lm as ra  # noqa: E402
from perfbench.reference import model as rm  # noqa: E402
from perfbench.reference.targets import PROMPT  # noqa: E402

CELL = "moonlight.segment"
BEAMS, MAX_LENGTH = 4, 32       # the cell's search
# |program - reference| / std(reference logits) on an NVIDIA H100 (PERF.md).
# The median over every value: the program 0.032-0.042, the reference in
# float8 0.285-0.310; it is what a lower precision fails. The largest at an
# agreeing position (the same experts summed in another precision): the
# program 0.051-0.147, while at flipped positions it reads up to 2.37 (the
# float8 reference flips every position). Flipped positions are not bounded:
# a rounding may tip a near tie.
TOLERANCE = {"median": 0.08, "agreeing_max": 0.5}


def _window_states(params, cfg, seed: int, device):
    """The program's encoder states of 4 windows of tone bursts."""
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.models.whisper import encoder_forward

    pcm = traffic.recording(seed, 0, 32000, 10.0)
    clips = torch.from_numpy(pcm.astype(np.float32) / 32768.0).reshape(4, -1)
    feats = Frontend(32000, 0.0025).features_for_clips(clips.to(device), 1000)
    return encoder_forward(params, cfg, feats)


@contextlib.contextmanager
def _recorded(module, name: str, into: list):
    """``module.name`` (a router: (x, ...) -> (experts, weights)) with each
    call's choice of experts, sorted within a token, appended to ``into``."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        idx, w = fn(*args, **kwargs)
        into.append(idx.sort(-1).values)
        return idx, w
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _gaps(got, want, flips) -> dict:
    """|got - want| / std(want): the median over every value, and the
    largest at a position where ``flips`` is False and where it is True."""
    d = (got - want).abs() / want.std()
    top = d.amax(-1)
    return {"median": float(d.median()),
            "agreeing_max": float(top[~flips].max()) if (~flips).any() else 0.0,
            "flipped_max": float(top[flips].max()) if flips.any() else 0.0,
            "flipped": int(flips.sum()), "positions": int(flips.numel())}


def _merge(parts: list) -> dict:
    """The rows' readings together: the median of the medians, the largest
    of the largest, the sums of the counts."""
    out = {}
    for key in parts[0]:
        pick = np.median if key == "median" else (
            max if key.endswith("_max") else sum)
        out[key] = float(pick([p[key] for p in parts]))
    return out


def _token_gaps(logits, ids, first: int, flips) -> dict:
    """The served ids judged by ``logits`` (each by the position before
    it, from ``first`` on), apart where that position's routing agreed and
    where it flipped: the widest gap and the tokens off."""
    from perfbench.check import _pick_gap

    out = {"tokens": len(ids)}
    for side, pick in (("agreeing", False), ("flipped", True)):
        gaps = [_pick_gap(logits[first + t], int(i), BEAMS)
                for t, i in enumerate(ids) if bool(flips[first + t]) == pick]
        out[f"{side}_tokens"] = len(gaps)
        out[f"{side}_gap_max"] = max(gaps, default=0.0)
        out[f"{side}_off"] = sum(g > 0 for g in gaps)
    return out


@torch.no_grad()
def logits(model: dict, seed: int, device) -> dict:
    from whisperseg_torch import decode
    from whisperseg_torch.models import audio_lm

    rm.no_tf32()
    flat = wal.random_weights(model, seed, device, torch.bfloat16)
    params, cfg = wt.tree(flat), wal.program_config(model)
    enc = _window_states(params, cfg, seed, device)
    lm = wal.lm_dict(model)
    layers = lm["num_hidden_layers"] - lm["first_k_dense_replace"]
    served = decode.generate(params, cfg, max_length=MAX_LENGTH,
                             num_beams=BEAMS, enc_out=enc)
    prompt = len(PROMPT)
    ids = served[:, prompt:]                    # [B, steps]: no EOT drawn
    rows, steps = ids.shape
    fed = ids.repeat_interleave(BEAMS, dim=0)   # the search's rows
    pre_routes, step_routes = [], []
    t0 = time.perf_counter()
    with _recorded(audio_lm, "route", pre_routes):
        pre, prefix = audio_lm.prefill(params, cfg, enc, all_logits=True)
    cache = audio_lm.init_cache(cfg, rows * BEAMS, steps, device)
    with _recorded(audio_lm, "route", step_routes):
        dec = torch.stack([audio_lm.step(params, cfg, prefix, cache,
                                         fed[:, t],
                                         torch.tensor(t, device=device))
                           for t in range(steps)], dim=1)[::BEAMS]
    # dec [B, steps, V]: the first of each window's rows
    if device.type == "cuda":
        torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    p = prefix.shape[2]
    # the program's choices of experts a position: [layer, row, position, k]
    prog = torch.cat([
        torch.stack(pre_routes).reshape(layers, rows, p, -1),
        torch.stack(step_routes).reshape(steps, layers, rows * BEAMS, -1
                                         )[:, :, ::BEAMS].permute(1, 2, 0, 3)
    ], dim=2)
    parts = {key: [] for key in ("f32_prefill", "f32_decode", "f32_tokens",
                                 "fp8_prefill", "fp8_decode", "fp8_tokens",
                                 "program_tokens")}
    stds = []
    for r in range(rows):
        seq = torch.cat([torch.tensor(PROMPT, device=device), ids[r]])
        ref_routes, low_routes = [], []
        with _recorded(ra, "router", ref_routes):
            want = ra.logits(flat, lm, enc[r], seq)        # [p + steps, V]
        with _recorded(ra, "router", low_routes), rm.lower_precision():
            low = ra.logits(flat, lm, enc[r], seq)
        ref = torch.stack(ref_routes)               # [layer, p + steps, k]
        flips = {"f32": (prog[:, r] != ref).any(-1).any(0),
                 "fp8": (torch.stack(low_routes) != ref).any(-1).any(0)}
        got = {"f32": torch.cat([pre[r], dec[r]]), "fp8": low}
        for side in ("f32", "fp8"):
            parts[f"{side}_prefill"].append(_gaps(got[side][:p], want[:p],
                                                  flips[side][:p]))
            parts[f"{side}_decode"].append(_gaps(got[side][p:], want[p:],
                                                 flips[side][p:]))
        # the served ids judged by the reference, and by the float8 one
        parts["f32_tokens"].append(_token_gaps(want, ids[r], p - 1,
                                               flips["f32"]))
        parts["fp8_tokens"].append(_token_gaps(low, ids[r], p - 1,
                                               flips["fp8"]))
        # the program's own logits judge the tokens it served
        mine = torch.cat([pre[r, -1:], dec[r]])
        parts["program_tokens"].append(_token_gaps(mine, ids[r], 0,
                                                   flips["f32"][p - 1:]))
        stds.append(float(want.std()))
        del want, low, got
    out = {"program_s": program_s, "prefix_positions": p, "steps": steps,
           "rows": rows, "tolerance": TOLERANCE,
           "reference_logit_std": float(np.median(stds))}
    for key, got in parts.items():
        out[key] = _merge(got)
    out["ok"] = all(out[f"f32_{part}"][s] <= TOLERANCE[s]
                    for part in ("prefill", "decode") for s in TOLERANCE)
    out["control_fails"] = all(any(out[f"fp8_{part}"][s] > TOLERANCE[s]
                                   for s in TOLERANCE)
                               for part in ("prefill", "decode"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs on the card only")
    device = torch.device("cuda", 0)
    cell = common.load_cell(CELL)
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "card": common.card_name(),
                      **logits(cell.model, args.seed, device)}),
          flush=True)


if __name__ == "__main__":
    main()
