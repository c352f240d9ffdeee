"""Post-processing of the segmenter: a copy of ``whisperseg_tpu/refine.py``
(the energy chain, the frame-head chain, ``segments_from_tracks``, and the
offline fitters of their knobs, ``fit_postprocess`` and ``fit_frame_mode``).

Energy-edge boundary refinement. Segment-wise F1 requires onset AND offset within a ±tolerance of ~4 columns
(reference model.py:494-495); a from-scratch model's boundary error is far
larger than its detection error (RESULTS.md: frame F1 0.76 with segment F1
0.05 means segments are FOUND but their edges sit tens of ms off). The model
decodes at column resolution from a blurred spectrogram — but the raw
waveform still holds the sharp amplitude edge. This module snaps each
predicted boundary to the strongest local energy edge within a small search
window, a host-side O(n) post-process with no model change.

Opt-in via ``Segmenter.segment(..., refine_boundaries_ms=R)``: R is the half-width (ms) of the search window
around each predicted boundary. Refinement never moves a boundary across the
midpoint toward a neighboring segment and falls back to the model's boundary
when no sufficiently contrasted edge exists in the window.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def energy_envelope_db(audio: np.ndarray, sr: int, hop_s: float = 0.001,
                       win_s: float = 0.004) -> np.ndarray:
    """Short-time RMS energy in dB at ``hop_s`` resolution (centered windows).

    Broadband — kept as the fallback for very short signals; boundary
    refinement uses :func:`band_envelope_db` (band-limited), because
    annotation boundaries align with the energy of the VOCALIZATION band, not
    of the full spectrum (measured on zebra finch: GT onsets sit on
    500-8000 Hz band edges with p90 distance 0 ms, while broadband edges are
    up to 118 ms away — low-frequency noise smears them)."""
    hop = max(int(round(hop_s * sr)), 1)
    win = max(int(round(win_s * sr)), hop)
    sq = np.concatenate([[0.0], np.cumsum(audio.astype(np.float64) ** 2)])
    n_frames = len(audio) // hop
    centers = np.arange(n_frames) * hop
    lo = np.clip(centers - win // 2, 0, len(audio))
    hi = np.clip(centers + win // 2, 1, len(audio))
    rms = np.sqrt((sq[hi] - sq[lo]) / np.maximum(hi - lo, 1))
    return 10.0 * np.log10(np.maximum(rms, 1e-10) ** 2)


def band_envelope_db(audio: np.ndarray, sr: int, hop_s: float = 0.001,
                     fmin: Optional[float] = None,
                     fmax: Optional[float] = None) -> np.ndarray:
    """Band-limited short-time energy (dB) at ``hop_s`` resolution.

    With ``fmin``/``fmax`` unset, the vocalization band is auto-selected as
    the frequency bins with the highest temporal contrast (p90 - p20 of the
    per-bin dB trace): vocal bands switch on and off, noise bands do not."""
    from scipy.signal import stft

    audio = np.asarray(audio, dtype=np.float32)
    hop = max(int(round(hop_s * sr)), 1)
    nper = 1 << max(int(np.ceil(np.log2(max(0.006 * sr, hop * 2)))), 4)
    if nper > len(audio):
        return energy_envelope_db(audio, sr, hop_s=hop_s)
    f, _, Z = stft(audio, fs=sr, nperseg=nper, noverlap=nper - hop,
                   boundary="zeros", padded=True)
    power = np.abs(Z) ** 2  # [bins, frames]
    if fmin is not None or fmax is not None:
        sel = (f >= (fmin or 0)) & (f <= (fmax if fmax else sr / 2))
    else:
        per_bin_db = 10 * np.log10(np.maximum(power, 1e-12))
        contrast = (np.percentile(per_bin_db, 90, axis=1)
                    - np.percentile(per_bin_db, 20, axis=1))
        thresh = 0.5 * contrast.max()
        sel = contrast >= thresh
        sel[0] = False  # never DC
        if not sel.any():
            sel[:] = True
    env = 10 * np.log10(np.maximum(power[sel].sum(axis=0), 1e-12))
    return env


def _edge_scores(env: np.ndarray, edge_frames: int) -> np.ndarray:
    """score[t] = mean(env[t:t+w]) - mean(env[t-w:t]): positive at rising
    edges, negative at falling edges. Frames too close to either end get 0."""
    c = np.concatenate([[0.0], np.cumsum(env)])
    w = edge_frames
    t = np.arange(len(env))
    valid = (t >= w) & (t + w <= len(env))
    tl = np.clip(t, w, max(len(env) - w, w))
    after = (c[tl + w] - c[tl]) / w
    before = (c[tl] - c[tl - w]) / w
    return np.where(valid, after - before, 0.0)


def split_merged_segments(
    prediction: Dict[str, list],
    env: np.ndarray,
    drop_db: float = 15.0,
    min_gap_s: float = 0.008,
    min_len_s: float = 0.01,
    hop_s: float = 0.001,
) -> Dict[str, list]:
    """Split predictions that span multiple vocalizations at sustained energy
    valleys.

    The dominant from-scratch segment-F1 failure is STRUCTURAL: one predicted
    segment covering several closely spaced syllables (measured: 65/210
    predictions merged >= 2 ground-truth syllables while frame F1 was 0.72 —
    scripts/diagnose_boundaries.py). Ground-truth syllabification follows
    energy gaps, so inside each predicted segment we find valleys that drop
    ``drop_db`` below BOTH flanking peaks for at least ``min_gap_s``, and cut
    there. Sub-segments shorter than ``min_len_s`` are dropped; clusters are
    inherited from the parent segment. ``env`` is the band envelope
    (:func:`band_envelope_db`) at ``hop_s`` resolution."""
    onsets = list(map(float, prediction["onset"]))
    offsets = list(map(float, prediction["offset"]))
    clusters = list(prediction.get("cluster", ["" for _ in onsets]))
    if not onsets:
        return prediction
    min_gap = max(int(round(min_gap_s / hop_s)), 1)

    new_on, new_off, new_cl = [], [], []
    for on, off, cl in zip(onsets, offsets, clusters):
        a = int(np.clip(round(on / hop_s), 0, len(env)))
        b = int(np.clip(round(off / hop_s), 0, len(env)))
        r = env[a:b]
        if len(r) < 3 * min_gap:
            new_on.append(on); new_off.append(off); new_cl.append(cl)
            continue
        left_max = np.maximum.accumulate(r)
        right_max = np.maximum.accumulate(r[::-1])[::-1]
        valley = r < np.minimum(left_max, right_max) - drop_db
        # runs of sustained valley -> cut points
        cuts = []  # (valley_start, valley_end) in region frames
        i = 0
        while i < len(valley):
            if valley[i]:
                j = i
                while j < len(valley) and valley[j]:
                    j += 1
                if j - i >= min_gap:
                    cuts.append((i, j))
                i = j
            else:
                i += 1
        if not cuts:
            new_on.append(on); new_off.append(off); new_cl.append(cl)
            continue
        bounds = [on]
        for i, j in cuts:
            bounds.append(on + i * hop_s)   # sub-offset at valley start
            bounds.append(on + j * hop_s)   # next sub-onset at valley end
        bounds.append(off)
        for k in range(0, len(bounds), 2):
            o1, o2 = bounds[k], bounds[k + 1]
            if o2 - o1 >= min_len_s:
                new_on.append(round(o1, 3))
                new_off.append(round(o2, 3))
                new_cl.append(cl)

    out = dict(prediction)
    out["onset"], out["offset"], out["cluster"] = new_on, new_off, new_cl
    return out


def refine_prediction(
    prediction: Dict[str, list],
    audio: np.ndarray,
    sr: int,
    env: np.ndarray,
    search_ms: float = 40.0,
    hop_s: float = 0.001,
    edge_s: float = 0.006,
    min_contrast_db: float = 4.0,
) -> Dict[str, list]:
    """Snap each onset to the best local rising energy edge and each offset to
    the best falling edge, within ±``search_ms``.

    A boundary moves only when the winning edge has at least
    ``min_contrast_db`` of level contrast — silence/noise regions keep the
    model's boundary. Onsets/offsets of the same segment cannot cross, and a
    boundary never moves past the midpoint of the gap to a neighboring
    segment (preserves segment ordering and non-overlap guarantees of the
    reference's output contract). ``env`` is the band envelope
    (:func:`band_envelope_db`) of ``audio`` at ``hop_s`` resolution.
    """
    onsets = list(map(float, prediction["onset"]))
    offsets = list(map(float, prediction["offset"]))
    if not onsets:
        return prediction
    if len(env) < 8:
        return prediction
    edge_frames = max(int(round(edge_s / hop_s)), 1)
    scores = _edge_scores(env, edge_frames)
    search = search_ms / 1000.0
    n = len(onsets)
    duration = len(audio) / sr

    def window(t_lo, t_hi):
        a = int(np.clip(round(t_lo / hop_s), 0, len(env) - 1))
        b = int(np.clip(round(t_hi / hop_s), 0, len(env) - 1))
        return (a, b + 1) if b >= a else (a, a + 1)

    new_on, new_off = list(onsets), list(offsets)
    order = np.argsort(onsets)
    for idx_pos, i in enumerate(order):
        on, off = onsets[i], offsets[i]
        mid = (on + off) / 2
        # neighbor guards: stay on our side of the gap midpoints
        prev_off = offsets[order[idx_pos - 1]] if idx_pos > 0 else 0.0
        next_on = (onsets[order[idx_pos + 1]]
                   if idx_pos + 1 < n else duration)
        lo = max(on - search, (prev_off + on) / 2 if idx_pos > 0 else 0.0)
        hi = min(on + search, mid)
        a, b = window(lo, hi)
        seg = scores[a:b]
        if len(seg):
            j = int(np.argmax(seg))
            if seg[j] >= min_contrast_db:
                new_on[i] = (a + j) * hop_s
        lo2 = max(off - search, mid)
        hi2 = min(off + search, (off + next_on) / 2 if idx_pos + 1 < n
                  else duration)
        a2, b2 = window(lo2, hi2)
        seg2 = scores[a2:b2]
        if len(seg2):
            j2 = int(np.argmin(seg2))
            if -seg2[j2] >= min_contrast_db:
                new_off[i] = (a2 + j2) * hop_s
        if new_off[i] <= new_on[i]:  # refinement collapsed the segment: revert
            new_on[i], new_off[i] = on, off

    out = dict(prediction)
    out["onset"] = [float(np.round(t, 3)) for t in new_on]
    out["offset"] = [float(np.round(t, 3)) for t in new_off]
    return out


def merge_small_gaps(
    prediction: Dict[str, list],
    gap_s: float,
) -> Dict[str, list]:
    """Merge consecutive same-cluster predictions separated by an implausibly
    small gap.

    The complement of split_merged_segments: the other structural from-scratch
    failure is one ground-truth syllable covered by >= 2 predictions (measured:
    64/205 GT split — scripts/diagnose_boundaries.py), while the empirical
    minimum inter-syllable gap in the corpus is much larger (zebra finch
    adults: 12 ms). A predicted gap shorter than the corpus minimum is
    therefore almost surely a spurious split; this merges such neighbors when
    their clusters agree. Opt-in via ``segment(..., merge_gap_ms=...)``."""
    onsets = list(map(float, prediction["onset"]))
    offsets = list(map(float, prediction["offset"]))
    clusters = list(prediction.get("cluster", ["" for _ in onsets]))
    if len(onsets) < 2:
        return prediction
    order = np.argsort(onsets)
    new_on, new_off, new_cl = [], [], []
    for i in order:
        if (new_on and clusters[i] == new_cl[-1]
                and onsets[i] - new_off[-1] < gap_s):
            new_off[-1] = max(new_off[-1], offsets[i])
        else:
            new_on.append(onsets[i])
            new_off.append(offsets[i])
            new_cl.append(clusters[i])
    out = dict(prediction)
    out["onset"], out["offset"], out["cluster"] = new_on, new_off, new_cl
    return out


def apply_postprocess(
    prediction: Dict[str, list],
    audio: np.ndarray,
    sr: int,
    merge_gap_ms: Optional[float] = None,
    split_merged_db: Optional[float] = None,
    refine_boundaries_ms: Optional[float] = None,
    min_len_s: float = 0.01,
    env: Optional[np.ndarray] = None,
) -> Dict[str, list]:
    """Apply the opt-in post-processing chain in its canonical order:
    merge small gaps -> split merged segments -> refine boundaries; a
    zero/None knob disables that stage. The merge runs first so a wrong
    merge across a genuine energy valley is re-cut by the split stage.
    ``env`` is the band envelope of ``audio``, made here when not given
    (:func:`fit_postprocess` makes it once a file)."""
    if merge_gap_ms:
        prediction = merge_small_gaps(prediction, gap_s=merge_gap_ms / 1000.0)
    if not (split_merged_db or refine_boundaries_ms):
        return prediction
    if env is None:
        env = band_envelope_db(np.asarray(audio, dtype=np.float32), sr)
    if split_merged_db:
        prediction = split_merged_segments(prediction, env,
                                           drop_db=split_merged_db,
                                           min_len_s=min_len_s)
    if refine_boundaries_ms:
        prediction = refine_prediction(prediction, audio, sr, env,
                                       search_ms=refine_boundaries_ms)
    return prediction


POSTPROCESS_KEYS = ("merge_gap_ms", "split_merged_db", "refine_boundaries_ms")
FRAME_POSTPROCESS_KEYS = ("frame_split", "frame_refine_ms", "frame_filter")


def _scoring_resolutions(labels):
    """Per-label (tolerance, time_per_frame_for_scoring) with the reference's
    defaults (reference model.py:494-495, 519-520)."""
    tols = [lab.get("tolerance",
                    lab.get("spec_time_step", 0.0025) * 4) for lab in labels]
    tpfs = [lab.get("time_per_frame_for_scoring",
                    min(0.001, lab.get("spec_time_step", 0.0025)))
            for lab in labels]
    return tols, tpfs


def micro_f1(preds, labels, tols, tpfs):
    """Micro-averaged (segment_F1, frame_F1) over a corpus — the shared
    objective of both offline fitters below."""
    from .scoring import frame_score, segment_score

    seg_tp = seg_p = seg_l = fr_tp = fr_p = fr_l = 0.0
    for pred, lab, tol, tpf in zip(preds, labels, tols, tpfs):
        tp, p, l = segment_score(pred, lab, tolerance=tol)[:3]
        seg_tp += tp; seg_p += p; seg_l += l
        tp, p, l = frame_score(pred, lab, time_per_frame_for_scoring=tpf)[:3]
        fr_tp += tp; fr_p += p; fr_l += l

    def f1(tp, p, l):
        pr, rc = tp / max(p, 1e-9), tp / max(l, 1e-9)
        return 2 * pr * rc / max(pr + rc, 1e-9)

    return f1(seg_tp, seg_p, seg_l), f1(fr_tp, fr_p, fr_l)


def fit_postprocess(
    predictions,
    labels,
    audios,
    srs,
    merge_gap_ms=(0.0, 5.0, 10.0),
    split_db=(0.0, 10.0, 12.0, 15.0),
    widths_ms=(0.0, 20.0, 30.0, 40.0, 60.0),
    min_len_s: float = 0.01,
    frame_tracks=None,
    time_deltas=None,
    frame_split=(0.0,),
    frame_refine_ms=(0.0,),
    frame_filter=(0.0,),
):
    """Grid-fit the post-processing knobs on a labeled set (intended: the
    TRAINING files) by maximizing micro segment F1, tie-broken by frame F1
    and then by simplicity (fewest active knobs, smallest values) so the
    no-op chain wins whenever post-processing does not measurably help.

    ``predictions`` are raw ``segment()`` outputs for ``audios`` (decode once,
    fit many). Per-file scoring tolerance / frame resolution come from each
    label's ``tolerance`` / ``time_per_frame_for_scoring`` keys with the
    reference's defaults (reference model.py:494-495, 519-520).

    When ``frame_tracks`` (per-audio ``Segmenter.frame_probs`` dicts) and
    ``time_deltas`` (per-audio FFT-blur half-widths) are given, the grid also
    spans the learned frame-head knobs ``frame_split`` / ``frame_refine_ms``,
    chained AFTER the energy stages exactly as ``segment()`` applies them.

    Returns ``(best_params, table)`` where ``best_params`` maps
    ``POSTPROCESS_KEYS`` (+ ``FRAME_POSTPROCESS_KEYS`` when fitted) to the
    winning (nonzero) values — an empty dict means post-processing off — and
    ``table`` maps ``"merge_g+split_d+refine_w[+fsplit_s+fsnap_m]"`` combo
    names to their ``{"segment_F1", "frame_F1"}`` train scores.
    """
    from itertools import product

    envs = [band_envelope_db(np.asarray(a, dtype=np.float32), sr)
            for a, sr in zip(audios, srs)]
    tols, tpfs = _scoring_resolutions(labels)

    def micro(preds):
        return micro_f1(preds, labels, tols, tpfs)

    fit_frames = frame_tracks is not None
    if not fit_frames:
        frame_split, frame_refine_ms, frame_filter = (0.0,), (0.0,), (0.0,)

    def _with_zero(vals):
        # every grid must span the no-op point: the tie-break prefers it, and
        # callers (scripts/fit_postprocess.py) read the raw score from the
        # all-zero combo — a user-supplied grid without 0 must not break that
        vals = tuple(float(v) for v in vals)
        return vals if 0.0 in vals else (0.0,) + vals

    merge_gap_ms = _with_zero(merge_gap_ms)
    split_db = _with_zero(split_db)
    widths_ms = _with_zero(widths_ms)
    frame_split = _with_zero(frame_split)
    frame_refine_ms = _with_zero(frame_refine_ms)
    frame_filter = _with_zero(frame_filter)

    best, best_key, table = None, None, {}
    for g, d, w in product(merge_gap_ms, split_db, widths_ms):
        energy = [
            apply_postprocess(pred, audio, sr, merge_gap_ms=g,
                              split_merged_db=d, refine_boundaries_ms=w,
                              min_len_s=min_len_s, env=env)
            for pred, audio, sr, env in zip(predictions, audios, srs, envs)
        ]
        for fs, fm, ff in product(frame_split, frame_refine_ms, frame_filter):
            if fit_frames and (fs or fm or ff):
                processed = [
                    apply_frame_postprocess(pred, tr, td, frame_split=fs,
                                            frame_refine_ms=fm,
                                            frame_filter=ff,
                                            min_len_s=min_len_s)
                    for pred, tr, td in zip(energy, frame_tracks, time_deltas)
                ]
            else:
                processed = energy
            seg_f1, fr_f1 = micro(processed)
            name = f"merge_{g:g}+split_{d:g}+refine_{w:g}"
            if fit_frames:
                name += f"+fsplit_{fs:g}+fsnap_{fm:g}+ffilt_{ff:g}"
            table[name] = {"segment_F1": round(seg_f1, 4),
                           "frame_F1": round(fr_f1, 4)}
            combo = (g, d, w, fs, fm, ff)
            simplicity = (-sum(1 for v in combo if v),) + tuple(
                -v for v in combo)
            key = (round(seg_f1, 4), round(fr_f1, 4), simplicity)
            if best_key is None or key > best_key:
                best_key, best = key, combo

    params = {k: v for k, v in
              zip(POSTPROCESS_KEYS + FRAME_POSTPROCESS_KEYS, best) if v}
    return params, table


# ------------------------------------------------------- frame-head refinement
#
# Learned counterparts of the energy heuristics above, driven by the optional
# encoder frame head (models/whisper.frame_head_forward): the onset/offset
# event tracks replace energy edges, the vocal track replaces the band
# envelope. Tracks live on the decoder's timestamp grid ("label space" — the
# FFT-blur-widened boundaries the model was trained on), while predictions
# from segment() are already blur-corrected, so conversions below carry the
# ±time_delta offset explicitly.


def frame_peak_pos(track: np.ndarray, center: int, radius: int,
                   min_peak: float = 0.1) -> float:
    """Best event-peak position in ``[center - radius, center + radius]``
    with parabolic sub-quantum interpolation; falls back to ``center`` when
    no peak exceeds ``min_peak``."""
    T = len(track)
    lo, hi = max(center - radius, 0), min(center + radius, T - 1)
    if hi < lo:
        return float(center)
    i = lo + int(np.argmax(track[lo:hi + 1]))
    if track[i] < min_peak:
        return float(center)
    if 0 < i < T - 1:
        a, b, c = float(track[i - 1]), float(track[i]), float(track[i + 1])
        denom = a - 2 * b + c
        if denom < 0:
            return i + 0.5 * (a - c) / denom
    return float(i)


def split_with_frame_tracks(
    prediction: Dict[str, list],
    tracks: Dict[str, np.ndarray],
    time_delta: float,
    cut_threshold: float = 0.5,
    min_len_s: float = 0.01,
) -> Dict[str, list]:
    """Split decoded segments that the frame head says contain an internal
    boundary: an interior grid position where BOTH the onset and offset event
    tracks exceed ``cut_threshold`` (two vocalizations merged by the decoder —
    the dominant structural failure of weak seq2seq models, DEVNOTES.md).
    Both halves keep the original cluster."""
    onsets = list(map(float, prediction.get("onset", [])))
    offsets = list(map(float, prediction.get("offset", [])))
    clusters = list(prediction.get("cluster", ["" for _ in onsets]))
    if not onsets:
        return prediction
    onset_t, offset_t = tracks["onset"], tracks["offset"]
    q = float(tracks["quantum"])
    T = len(onset_t)

    new_on, new_off, new_cl = [], [], []
    for on, off, cl in zip(onsets, offsets, clusters):
        a = int(np.round((on - time_delta) / q))
        b = int(np.round((off + time_delta) / q))
        cuts = [i for i in range(max(a + 1, 1), min(b, T))
                if onset_t[i] >= cut_threshold and offset_t[i] >= cut_threshold]
        pieces, prev = [], on
        for c in cuts:
            t_cut_off = c * q - time_delta   # blur-corrected offset of left piece
            t_cut_on = c * q + time_delta    # blur-corrected onset of right piece
            if t_cut_off - prev >= min_len_s and off - t_cut_on >= min_len_s:
                pieces.append((prev, t_cut_off))
                prev = t_cut_on
        pieces.append((prev, off))
        for p_on, p_off in pieces:
            new_on.append(p_on)
            new_off.append(p_off)
            new_cl.append(cl)
    out = dict(prediction)
    out["onset"], out["offset"], out["cluster"] = new_on, new_off, new_cl
    return out


def refine_with_frame_tracks(
    prediction: Dict[str, list],
    tracks: Dict[str, np.ndarray],
    time_delta: float,
    search_ms: float = 20.0,
    min_peak: float = 0.1,
) -> Dict[str, list]:
    """Snap each decoded onset to the best frame-head onset-event peak and
    each offset to the best offset-event peak within ``±search_ms``
    (sub-quantum via parabolic interpolation). The learned counterpart of
    :func:`refine_prediction`; boundaries move at most the search width, and
    a boundary with no nearby peak stays put."""
    onsets = list(map(float, prediction.get("onset", [])))
    offsets = list(map(float, prediction.get("offset", [])))
    if not onsets:
        return prediction
    onset_t, offset_t = tracks["onset"], tracks["offset"]
    q = float(tracks["quantum"])
    T = len(onset_t)
    radius = max(int(np.round(search_ms / 1000.0 / q)), 1)

    def snap(track, center):
        """Peak position, or None when no peak exceeds min_peak in the
        window — the caller then keeps the ORIGINAL (unquantized) boundary,
        honoring the "stays put" contract (the grid-rounded fallback would
        drift off-grid boundaries by up to quantum/2)."""
        lo, hi = max(center - radius, 0), min(center + radius, T - 1)
        if hi < lo or float(track[lo:hi + 1].max()) < min_peak:
            return None
        return frame_peak_pos(track, center, radius, min_peak)

    new_on, new_off = [], []
    for on, off in zip(onsets, offsets):
        a = int(np.round((on - time_delta) / q))
        b = int(np.round((off + time_delta) / q))
        p_on = snap(onset_t, a)
        p_off = snap(offset_t, b)
        on2 = on if p_on is None else p_on * q + time_delta
        off2 = off if p_off is None else p_off * q - time_delta
        if on2 >= off2:   # refinement collapsed the segment: keep original
            on2, off2 = on, off
        new_on.append(on2)
        new_off.append(off2)
    out = dict(prediction)
    out["onset"], out["offset"] = new_on, new_off
    return out


def filter_with_frame_tracks(
    prediction: Dict[str, list],
    tracks: Dict[str, np.ndarray],
    time_delta: float,
    min_vocal: float = 0.5,
) -> Dict[str, list]:
    """Drop decoded segments whose mean frame-head vocal probability over
    their (label-space) span falls below ``min_vocal`` — a precision filter
    against decoder hallucinations the head sees as silence."""
    onsets = list(map(float, prediction.get("onset", [])))
    offsets = list(map(float, prediction.get("offset", [])))
    clusters = list(prediction.get("cluster", ["" for _ in onsets]))
    if not onsets:
        return prediction
    vocal = tracks["vocal"]
    q = float(tracks["quantum"])
    T = len(vocal)

    keep = []
    for i, (on, off) in enumerate(zip(onsets, offsets)):
        a = int(np.clip(np.round((on - time_delta) / q), 0, T - 1))
        b = int(np.clip(np.round((off + time_delta) / q), 0, T))
        b = max(b, a + 1)   # zero-length span: judge the single cell
        if float(vocal[a:b].mean()) >= min_vocal:
            keep.append(i)
    out = dict(prediction)
    out["onset"] = [onsets[i] for i in keep]
    out["offset"] = [offsets[i] for i in keep]
    out["cluster"] = [clusters[i] for i in keep]
    return out


def apply_frame_postprocess(
    prediction: Dict[str, list],
    tracks: Dict[str, np.ndarray],
    time_delta: float,
    frame_split: Optional[float] = None,
    frame_refine_ms: Optional[float] = None,
    frame_filter: Optional[float] = None,
    min_len_s: float = 0.01,
) -> Dict[str, list]:
    """Frame-head post-processing chain (filter -> split -> refine), mirroring
    :func:`apply_postprocess` for the learned tracks. ``frame_filter`` is the
    minimum mean vocal probability a decoded segment must reach to survive,
    ``frame_split`` the event cut threshold, ``frame_refine_ms`` the snap
    search half-width in ms (0/None disables each). The filter runs first so
    hallucinated segments never reach the boundary stages."""
    if frame_filter:
        prediction = filter_with_frame_tracks(prediction, tracks, time_delta,
                                              min_vocal=float(frame_filter))
    if frame_split:
        prediction = split_with_frame_tracks(prediction, tracks, time_delta,
                                             cut_threshold=float(frame_split),
                                             min_len_s=min_len_s)
    if frame_refine_ms:
        prediction = refine_with_frame_tracks(prediction, tracks, time_delta,
                                              search_ms=float(frame_refine_ms))
    return prediction


def segments_from_tracks(
    tracks: Dict[str, np.ndarray],
    duration: float,
    time_delta: float,
    inverse_codebook: Dict[int, str],
    vocal_threshold: float = 0.5,
    cut_threshold: float = 0.5,
    boundary_snap: int = 2,
    min_segment_length: float = 0.01,
    precision_bits: int = 3,
    gap_cut: int = 0,
) -> Dict[str, list]:
    """Pure tracks -> segments conversion for the frame-VAD mode
    (``Segmenter.segment_from_frames``): threshold the vocal track into runs,
    cut runs where both event tracks fire, snap boundaries to event peaks
    (parabolic sub-quantum), FFT-blur correct, majority-vote the cluster.

    ``gap_cut`` (quanta) generalizes the cut to short PAUSES the vocal track
    never dips through: an offset event at ``i`` paired with the first onset
    event in ``(i, i + gap_cut]`` splits the run into ``[a, i]`` + ``[j, b]``
    even though the implied gap is below ``min_segment_length``'s floor —
    the merged-adjacent-spans failure mode of densely-annotated corpora.
    0 keeps the same-position-only cut (both events at one quantum).

    Factored out of the Segmenter so that thresholds can be fitted offline
    on tracks computed once per file.
    """
    vocal, onset_t, offset_t = tracks["vocal"], tracks["onset"], tracks["offset"]
    quantum, cluster_ids = float(tracks["quantum"]), tracks["cluster"]
    T = len(vocal)

    active = vocal > vocal_threshold
    runs = []
    start = None
    for i in range(T):
        if active[i] and start is None:
            start = i
        elif not active[i] and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, T))

    cut_runs = []
    for a, b in runs:
        prev = a
        i = a + 1
        while i < b:
            if offset_t[i] >= cut_threshold:
                j = next((i + g for g in range(int(gap_cut) + 1)
                          if i + g < b and onset_t[i + g] >= cut_threshold),
                         None)
                if j is not None and i > prev:
                    cut_runs.append((prev, i))
                    prev = j
                    i = j + 1
                    continue
            i += 1
        cut_runs.append((prev, b))

    onsets, offsets, clusters = [], [], []
    for a, b in cut_runs:
        on_pos = frame_peak_pos(onset_t, a, boundary_snap)
        off_pos = frame_peak_pos(offset_t, b, boundary_snap)
        on = on_pos * quantum + time_delta
        off = off_pos * quantum - time_delta
        if on > off:
            mid = (on_pos + off_pos) / 2 * quantum
            on = off = mid
        on = float(np.clip(on, 0.0, duration))
        off = float(np.clip(off, 0.0, duration))
        if off - on < min_segment_length:
            continue
        ids = cluster_ids[a:b]
        ids = ids[ids >= 0]
        if len(ids):
            cid = int(np.bincount(ids).argmax())
            name = inverse_codebook.get(cid, "Vocal")
        else:
            name = "Vocal"
        onsets.append(float(np.round(on, precision_bits)))
        offsets.append(float(np.round(off, precision_bits)))
        clusters.append(name)
    return {"onset": onsets, "offset": offsets, "cluster": clusters}


FRAME_MODE_KEYS = ("frame_vocal_threshold", "frame_cut_threshold",
                   "frame_boundary_snap", "frame_gap_cut")


def fit_frame_mode(
    tracks_list,
    labels,
    durations,
    time_deltas,
    inverse_codebook,
    vocal_threshold=(0.3, 0.4, 0.5, 0.6),
    cut_threshold=(0.3, 0.5, 0.7),
    boundary_snap=(2, 4, 8),
    gap_cut=(0, 2, 5, 10),
    min_segment_lengths=None,
):
    """Grid-fit the frame-VAD thresholds on a labeled set (intended: the
    TRAINING files; tracks precomputed once per file). Selection: micro
    segment F1, tie-broken by frame F1 then by proximity to the defaults.

    Returns ``(best_params, table)`` with ``best_params`` keyed by
    ``FRAME_MODE_KEYS`` (only values differing from the defaults included;
    empty dict = defaults already optimal).
    """
    from itertools import product

    tols, tpfs = _scoring_resolutions(labels)
    if min_segment_lengths is None:
        min_segment_lengths = [lab.get("spec_time_step", 0.0025) * 2
                               for lab in labels]

    defaults = (0.5, 0.5, 2, 0)
    best, best_key, table = None, None, {}
    for vt, ct, bs, gc in product(vocal_threshold, cut_threshold,
                                  boundary_snap, gap_cut):
        preds = [
            segments_from_tracks(tr, dur, td, inverse_codebook,
                                 vocal_threshold=vt, cut_threshold=ct,
                                 boundary_snap=bs, min_segment_length=msl,
                                 gap_cut=gc)
            for tr, dur, td, msl in zip(tracks_list, durations, time_deltas,
                                        min_segment_lengths)
        ]
        seg_f1, fr_f1 = micro_f1(preds, labels, tols, tpfs)
        name = f"vt_{vt:g}+ct_{ct:g}+snap_{bs:g}+gap_{gc:g}"
        table[name] = {"segment_F1": round(seg_f1, 4),
                       "frame_F1": round(fr_f1, 4)}
        closeness = -(abs(vt - defaults[0]) + abs(ct - defaults[1])
                      + abs(bs - defaults[2]) / 10.0 + gc / 100.0)
        key = (round(seg_f1, 4), round(fr_f1, 4), closeness)
        if best_key is None or key > best_key:
            best_key, best = key, (vt, ct, bs, gc)

    params = {k: v for k, v in zip(FRAME_MODE_KEYS, best)
              if v != dict(zip(FRAME_MODE_KEYS, defaults))[k]}
    return params, table
