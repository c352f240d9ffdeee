"""The frame-VAD mode's host tail in plain Python and NumPy: from the frame
head's per-window outputs of one recording to its table of segments.

Written from the mode's published description (the repository's README and
``Segmenter.segment_from_frames``' contract): the trial-0 windows' vocal /
onset / offset probabilities and cluster ids are laid end to end on the
decoder's time base (a quantum of two spectrogram columns) and cut to the
recording's length; the vocal track is thresholded into runs; a run is cut
where an offset event and an onset event (both at or over the cut
threshold) fire at one quantum, or the onset within ``gap_cut`` quanta after
the offset; each boundary snaps to the highest event peak within
``boundary_snap`` quanta (parabolic sub-quantum position, kept at the run's
edge where no peak reaches 0.1), the onset moves later and the offset
earlier by half an FFT window; a segment whose ends cross collapses to its
midpoint; ends are clipped to the recording, segments shorter than the
minimum dropped, the cluster is the majority of the run's cluster ids, and
times are rounded to the checkpoint's precision."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .frontend import n_fft_for_sr

QUANTUM_COLUMNS = 2
MIN_PEAK = 0.1


def tracks(probs: np.ndarray, cluster: np.ndarray, duration_s: float,
           spec_time_step: float) -> dict:
    """Per-window outputs [N, S, 3] and [N, S] -> the recording's tracks."""
    quantum = spec_time_step * QUANTUM_COLUMNS
    n = int(math.ceil(duration_s / quantum)) if duration_s else 0
    p = np.asarray(probs).reshape(-1, 3)[:n]
    return {"vocal": p[:, 0], "onset": p[:, 1], "offset": p[:, 2],
            "cluster": np.asarray(cluster).reshape(-1)[:n],
            "quantum": quantum}


def _peak(track: np.ndarray, centre: int, radius: int) -> float:
    n = len(track)
    lo, hi = max(centre - radius, 0), min(centre + radius, n - 1)
    if hi < lo:
        return float(centre)
    best = lo + int(np.argmax(track[lo:hi + 1]))
    if track[best] < MIN_PEAK:
        return float(centre)
    if 0 < best < n - 1:
        a, b, c = (float(track[best - 1]), float(track[best]),
                   float(track[best + 1]))
        curve = a - 2 * b + c
        if curve < 0:
            return best + 0.5 * (a - c) / curve
    return float(best)


def _runs(active: np.ndarray) -> List[tuple]:
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], active.astype(np.int8), [0]])))
    return [(int(a), int(b)) for a, b in zip(edges[::2], edges[1::2])]


def _cut(runs, onset, offset, threshold: float, gap: int) -> List[tuple]:
    out = []
    for a, b in runs:
        prev, i = a, a + 1
        while i < b:
            if offset[i] >= threshold:
                j = next((i + g for g in range(gap + 1)
                          if i + g < b and onset[i + g] >= threshold), None)
                if j is not None and i > prev:
                    out.append((prev, i))
                    prev, i = j, j + 1
                    continue
            i += 1
        out.append((prev, b))
    return out


def table(tr: dict, duration_s: float, sr: int, names: Dict[int, str],
          vocal_threshold: float, cut_threshold: float, boundary_snap: int,
          gap_cut: int, min_segment_length: float,
          precision_bits: int) -> Dict[str, list]:
    """The recording's segments: {"onset", "offset", "cluster"}."""
    delta = n_fft_for_sr(sr) / 2.0 / sr
    q = tr["quantum"]
    runs = _cut(_runs(tr["vocal"] > vocal_threshold), tr["onset"],
                tr["offset"], cut_threshold, int(gap_cut))
    out = {"onset": [], "offset": [], "cluster": []}
    for a, b in runs:
        p_on = _peak(tr["onset"], a, boundary_snap)
        p_off = _peak(tr["offset"], b, boundary_snap)
        on, off = p_on * q + delta, p_off * q - delta
        if on > off:
            on = off = (p_on + p_off) / 2 * q
        on = min(max(on, 0.0), duration_s)
        off = min(max(off, 0.0), duration_s)
        if off - on < min_segment_length:
            continue
        ids = tr["cluster"][a:b]
        ids = ids[ids >= 0]
        name = names.get(int(np.bincount(ids).argmax()), "Vocal") \
            if len(ids) else "Vocal"
        out["onset"].append(float(np.round(on, precision_bits)))
        out["offset"].append(float(np.round(off, precision_bits)))
        out["cluster"].append(name)
    return out
