"""How ``correct`` is decided: the numbers that hold what the timed path
produced against the plain reference (``perfbench/reference``).

* Served tokens (beam or greedy search): the reference runs once, teacher
  forced, over each sampled window's prompt and served tokens. A search of
  K beams keeps a non-final token only while fewer than K other tokens of
  the same hypothesis (end-of-text aside) score higher, and banks
  end-of-text only among the top 2K; greedy search keeps the best token. So
  the reference's logit of each served token may lie below the reference's
  K-th best (2K-th for end-of-text, best for greedy) by rounding alone:
  ``token_gap`` is the widest such shortfall, in logits, and
  ``token_off_share`` the share of judged tokens with any shortfall (the
  steadier number on a trained model, whose widest shortfall swings with
  the few near ties a sample holds). The control of the tokens is the
  program's own lower-precision path (int8 weights and int8 K/V), run in
  the program's place; the reference has none for them.
* Frame probabilities: ``frame_track_median``, the largest over the
  sampled windows and the three tracks (vocal, onset, offset) of the
  median distance of a window's served track from the reference's, in
  logits (probabilities clipped to [1e-6, 1 - 1e-6]), so that one track or
  one window gone wrong shows whole; ``frame_logit_median``, the median of
  all of them pooled, and ``frame_gap``, the widest probability difference
  (it swings with the few frames on a steep part of the sigmoid), are
  reported beside it.
* The frame-VAD table: ``table_mismatch``, the recordings whose returned
  table differs from the reference host tail's (``reference/tail.py``)
  over the same served tracks; exact.
* Fine-tuning: ``loss_gap`` (each of the first steps' loss, relative),
  ``grad_gap`` (the first step's gradient norm of each leaf, as the
  optimizer's first moment holds it), ``change_gap`` (the norm of each
  leaf's change over the first steps), each by the worst leaf against the
  larger of the reference leaf's norm and the median leaf's; and, since a
  gap of norms cannot see a change in the wrong direction, the norm of the
  difference of the two changes on the same scale, by the worst leaf
  (``change_diff``) and the median leaf (``change_diff_median``). Leaves
  whose reference gradient is under a thousandth of the median leaf's take
  no part (none in these models: Whisper's keys carry no bias).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference import frontend as rf
from .reference import model as rm
from .reference import tail as rtail
from .reference import targets as rt


def _pick_gap(logits: torch.Tensor, token: int, beams: int) -> float:
    """How far ``token``'s reference logit lies below what the search
    needed of it (0 when it clears it), in logits."""
    if beams <= 1:
        need = logits.max()
    elif token == rt.EOT:
        need = torch.topk(logits, 2 * beams).values[-1]
    else:
        other = logits.clone()
        other[rt.EOT] = -math.inf
        need = torch.topk(other, beams).values[-1]
    return max(0.0, float(need - logits[token]))


def served_span(tokens: Sequence[int], max_length: int) -> Optional[int]:
    """One past the last generated token of a served sequence (its
    end-of-text included), or None where the sequence is malformed: another
    prompt, or anything but padding after end-of-text."""
    pl = len(rt.PROMPT)
    if tuple(tokens[:pl]) != rt.PROMPT or len(tokens) != max_length:
        return None
    gen = list(tokens[pl:])
    if rt.EOT in gen:
        end = pl + gen.index(rt.EOT) + 1
        if any(t != rt.PAD for t in tokens[end:]):
            return None
        return end
    return max_length


def _features(windows, sr, step, min_frequency, columns, device):
    return torch.from_numpy(np.stack([
        rf.window_features(w, sr, step, min_frequency, columns)
        for w in windows])).to(device)


@torch.no_grad()
def token_gap(weights, model: dict, windows: np.ndarray, served: List[list],
              beams: int, max_length: int, sr: int, step: float,
              min_frequency: float, device, block: int = 8) -> dict:
    """The widest ``token_gap`` and the ``token_off_share`` over ``windows``
    [N, samples] (float audio) and their served token lists, with the
    number of tokens judged."""
    rm.no_tf32()
    heads = model["encoder_attention_heads"]
    layers = model["encoder_layers"], model["decoder_layers"]
    widest, off, judged = 0.0, 0, 0
    bad = {"token_gap": math.inf, "token_off_share": math.inf, "tokens": 0}
    for lo in range(0, len(windows), block):
        feats = _features(windows[lo:lo + block], sr, step, min_frequency,
                          model["total_spec_columns"], device)
        enc = rm.encoder(weights, feats, layers[0], heads)
        for i, tokens in enumerate(served[lo:lo + block]):
            end = served_span(tokens, max_length)
            if end is None or not all(0 <= t < model["vocab_size"]
                                      for t in tokens):
                return bad
            ids = torch.tensor(tokens[:end - 1], device=device)[None]
            logits = rm.decoder(weights, enc[i:i + 1], ids, layers[1],
                                heads)[0]
            for t in range(len(rt.PROMPT), end):
                gap = _pick_gap(logits[t - 1], int(tokens[t]), beams)
                widest = max(widest, gap)
                off += int(gap > 0)
                judged += 1
    return {"token_gap": widest, "token_off_share": off / max(judged, 1),
            "tokens": judged}


@torch.no_grad()
def frame_gap(weights, model: dict, windows: np.ndarray, probs: np.ndarray,
              sr: int, step: float, min_frequency: float, device,
              block: int = 8, control: bool = False) -> dict:
    """The served frame probabilities [N, S, 3] of ``windows`` against the
    reference's; with ``control`` also the reference in float8 against
    itself (``control_*``)."""
    rm.no_tf32()
    heads, layers = model["encoder_attention_heads"], model["encoder_layers"]
    bad = {"frame_gap": math.inf, "frame_logit_median": math.inf,
           "frame_track_median": math.inf}
    diffs, low_diffs = [], []
    for lo in range(0, len(windows), block):
        feats = _features(windows[lo:lo + block], sr, step, min_frequency,
                          model["total_spec_columns"], device)
        enc = rm.encoder(weights, feats, layers, heads)
        logit = rm.frame_head(weights, enc)[..., :3].cpu().numpy()
        got = probs[lo:lo + block]
        if got.shape != logit.shape or not np.isfinite(got).all():
            return bad
        diffs.append((got, logit))
        if control:
            with rm.lower_precision():
                enc_low = rm.encoder(weights, feats, layers, heads)
                low = rm.frame_head(weights, enc_low)[..., :3]
            low_diffs.append((torch.sigmoid(low).cpu().numpy(), logit))
    if not diffs:
        return bad
    out = _frame_numbers(diffs)
    if control:
        out.update({"control_" + k: v
                    for k, v in _frame_numbers(low_diffs).items()})
    return out


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p.astype(np.float64), 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


def _frame_numbers(pairs) -> dict:
    """(served probabilities, reference logits) pairs, each [n, S, 3] ->
    the largest per-window, per-track median gap in logits, the pooled
    median, and the widest probability gap."""
    dp = np.concatenate([np.abs(p - 1 / (1 + np.exp(-l.astype(np.float64))))
                         for p, l in pairs])
    dl = np.concatenate([np.abs(_logit(p) - np.clip(l, -13.8155, 13.8155))
                         for p, l in pairs])
    return {"frame_gap": float(dp.max()),
            "frame_logit_median": float(np.median(dl)),
            "frame_track_median": float(np.median(dl, axis=1).max())}


def table_mismatch(served: List[tuple], tables: List[dict], settings: dict,
                   spec_time_step: float, sr: int) -> dict:
    """The recordings whose returned table differs from the reference host
    tail's over the same served outputs. ``served``: per recording, its
    windows' (probabilities [N, S, 3], cluster ids [N, S]) and its length
    in seconds; ``tables``: what the program returned for it."""
    differ = 0
    segments = 0
    for (probs, cluster, duration), got in zip(served, tables):
        want = rtail.table(rtail.tracks(probs, cluster, duration,
                                        spec_time_step),
                           duration, sr, **settings)
        segments += len(want["onset"])
        same = all(list(got.get(k, [])) == want[k]
                   for k in ("onset", "offset", "cluster"))
        differ += int(not same)
    return {"table_mismatch": float(differ), "table_segments": segments}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             counted: Sequence[str]) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖."""
    med = float(np.median([want[k] for k in counted]))
    worst = 0.0
    for k in counted:
        g = got.get(k)
        if g is None or not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - want[k]) / max(want[k], med))
    return worst


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return sorted(k for k, v in ref_grad.items() if v >= 1e-3 * med)


def norm64(x: torch.Tensor, device=None) -> float:
    """The norm of ``x`` summed in float64 (on ``device`` where given):
    float32 sums over a stacked leaf of 10^8 elements drift by per cents
    on the CPU."""
    return float(x.to(device if device is not None else x.device,
                      torch.float64).norm())


def _diff_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               counted: Sequence[str]) -> tuple:
    """Each counted leaf's ‖got - want‖ over the larger of ‖want‖ and the
    median leaf's ‖want‖: (the worst leaf's, the median leaf's)."""
    norms = {k: norm64(want[k]) for k in counted}
    med = float(np.median(list(norms.values())))
    gaps = []
    for k in counted:
        g = got.get(k)
        if g is None or g.shape != want[k].shape:
            return math.inf, math.inf
        d = norm64(g.to(want[k].device) - want[k])
        gaps.append(d / max(norms[k], med) if math.isfinite(d) else math.inf)
    return max(gaps), float(np.median(gaps))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [per step], "grad": {leaf: norm},
    "delta": {leaf: the change over the first steps}}."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(math.inf)
    counted = counted_leaves(ref["grad"])
    want = {k: norm64(v) for k, v in ref["delta"].items()}
    device = next(iter(ref["delta"].values())).device
    change = {k: norm64(v, device) for k, v in prog["delta"].items()}
    diff, diff_median = _diff_gaps(prog["delta"], ref["delta"], counted)
    return {"loss_gap": max(losses),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], counted),
            "change_gap": leaf_gap(change, want, counted),
            "change_diff": diff, "change_diff_median": diff_median}


def reference_training(weights: Dict[str, torch.Tensor], model: dict,
                       batches: List[dict], lr_of_step, device,
                       weight_decay: float) -> dict:
    """The reference's first steps from ``weights`` over ``batches`` (each
    {"features" [B, 80, T] float32 numpy, "inputs" [B, L], "labels"
    [B, L]}): each step's loss, the first gradient's norm a leaf and each
    leaf's change after the last step."""
    rm.no_tf32()
    heads = model["encoder_attention_heads"]
    params = rm.weights_on(weights, device, requires_grad=True)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = rm.AdamW(params, rm.decay_leaves(params), weight_decay=weight_decay)
    losses, first = [], None
    for i, b in enumerate(batches):
        feats = torch.from_numpy(b["features"]).to(device)
        ids = torch.from_numpy(b["inputs"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        enc = rm.encoder(params, feats, model["encoder_layers"], heads)
        logits = rm.decoder(params, enc, ids, model["decoder_layers"], heads)
        loss = rm.token_loss(logits, labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params.keys(), grads))
        if first is None:
            first = {k: norm64(g) for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(grads, lr_of_step(i))
        del grads, logits, enc
    delta = {k: params[k].detach() - start[k] for k in params}
    del start, opt
    return {"loss": losses, "grad": first, "delta": delta}


def training_batch(files: Dict[str, dict], items: List[dict], model: dict,
                   max_length: int) -> dict:
    """The reference's own batch for the items a program batch was made
    of: each item's crop located in its file's training window, its
    features and its targets derived again from the label file."""
    feats, inputs, labels = [], [], []
    cols = model["total_spec_columns"]
    for it in items:
        f = files[it["file"]]
        piece_samples, on, off = f["windows"][it["window"]]
        s = rt.find_crop(piece_samples, it["crop"])
        n = int(np.round(cols * f["step"] * f["sr"]))
        if s < 0:
            inp = np.full(max_length, -1, np.int64)
            lab = np.full(max_length, -1, np.int64)
        else:
            inp, lab = rt.crop_target(on, off, s, min(n, len(piece_samples) - s),
                                      f["sr"], f["step"], cols, max_length)
        feats.append(rf.window_features(it["crop"], f["sr"], f["step"],
                                        f["min_frequency"], cols))
        inputs.append(inp)
        labels.append(lab)
    return {"features": np.stack(feats), "inputs": np.stack(inputs),
            "labels": np.stack(labels)}
