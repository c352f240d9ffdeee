"""Multi-trial consolidation of window-level predictions.

Replicates the reference's two consolidation strategies (reference model.py:284-394):

  * clustering: DBSCAN over pairwise distance ``(|Δonset| + |Δoffset|) / 2``
    between segments pooled across trials, majority cluster name, mean boundaries.
    The DBSCAN here is a small self-contained implementation (the reference calls
    sklearn) with identical semantics for this metric: inclusive eps neighborhoods,
    ``min_samples`` counting the point itself, border points attached to the first
    core cluster that reaches them in scan order.
  * voting: frame-wise rasterization of each trial, per-frame majority vote
    (ties -> smallest cluster id, scipy ``mode`` semantics), run-length re-extraction.

These run on at most a few hundred segments per audio file, so they stay host-side
numpy (a device round-trip would cost more than the computation).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def merge_window_boundaries(window_segment_lists: List[List[List]]) -> List[List]:
    """Concatenate per-window segment lists for one trial, merging a segment pair
    that abuts exactly at a window boundary with the same cluster
    (reference model.py:234-248)."""
    merged: List[List] = []
    for segs in window_segment_lists:
        if (
            merged
            and segs
            and merged[-1][1] == segs[0][0]
            and merged[-1][2] == segs[0][2]
        ):
            merged[-1][1] = segs[0][1]
            segs = segs[1:]
        merged += segs
    return merged


def _dbscan(dist: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN over a precomputed distance matrix -> labels (-1 = noise)."""
    n = dist.shape[0]
    neighbors = dist <= eps
    core = neighbors.sum(axis=1) >= min_samples
    labels = np.full(n, -1, dtype=np.int64)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS over density-reachable points from this core point.
        labels[i] = cluster
        frontier = [i]
        while frontier:
            p = frontier.pop()
            if not core[p]:
                continue
            for q in np.nonzero(neighbors[p])[0]:
                if labels[q] == -1:
                    labels[q] = cluster
                    frontier.append(q)
        cluster += 1
    return labels


def consolidate_by_clustering(
    trials: List[Dict[str, list]], eps: float, min_samples: int,
    stats: Optional[dict] = None,
) -> Dict[str, list]:
    """DBSCAN consolidation (reference model.py:291-337).

    ``stats`` (optional dict, filled in place) reports cross-trial
    agreement: ``n_input`` segments across all trials, ``n_noise`` discarded
    as DBSCAN noise (segments other trials did not reproduce within eps),
    and ``n_clusters`` surviving. A high noise fraction is the
    recall-collapse mode of weak models under the reference's production
    num_trials=3 default (RESULTS.md) — callers can warn on it."""
    onsets, offsets, clusters = [], [], []
    for trial in trials:
        onsets += list(trial["onset"])
        offsets += list(trial["offset"])
        clusters += list(trial["cluster"])
    if stats is not None:
        stats.update(n_input=len(onsets), n_noise=0, n_clusters=0)
    if not onsets:
        return {"onset": [], "offset": [], "cluster": []}

    pts = np.stack([np.asarray(onsets, dtype=np.float64),
                    np.asarray(offsets, dtype=np.float64)], axis=1)
    dist = (
        np.abs(pts[:, None, 0] - pts[None, :, 0])
        + np.abs(pts[:, None, 1] - pts[None, :, 1])
    ) / 2.0
    labels = _dbscan(dist, eps, min_samples)

    merged = []
    for label in sorted(set(labels.tolist())):
        if label == -1:
            continue
        idx = np.nonzero(labels == label)[0]
        # Majority cluster name; ties broken by first appearance (dict order +
        # stable sort, matching reference model.py:319-323).
        counts: Dict[str, int] = {}
        for k in idx:
            counts[clusters[k]] = counts.get(clusters[k], 0) + 1
        name = sorted(counts.items(), key=lambda x: -x[1])[0][0]
        merged.append(
            {
                "onset": float(np.mean(pts[idx, 0])),
                "offset": float(np.mean(pts[idx, 1])),
                "cluster": name,
            }
        )
    merged.sort(key=lambda x: x["onset"])
    if stats is not None:
        stats["n_noise"] = int(np.sum(labels == -1))
        stats["n_clusters"] = len(merged)
    return {
        "onset": [m["onset"] for m in merged],
        "offset": [m["offset"] for m in merged],
        "cluster": [m["cluster"] for m in merged],
    }


def consolidate_by_voting(
    trials: List[Dict[str, list]],
    time_per_frame: float,
    cluster_codebook: Dict[str, int],
) -> Dict[str, list]:
    """Frame-majority consolidation (reference model.py:339-394)."""
    from scipy.stats import mode

    all_ts: List[float] = []
    for trial in trials:
        all_ts += list(trial["onset"])
        all_ts += list(trial["offset"])
    if len(all_ts) == 0 or len(all_ts) % 2 != 0:
        return {"onset": [], "offset": [], "cluster": []}

    min_time = float(np.min(all_ts))
    max_time = float(np.max(all_ts))
    num_frames = int(np.round((max_time - min_time) / time_per_frame))

    frames = []
    for trial in trials:
        fw = np.full(num_frames, -1.0)
        for onset, offset, cluster in zip(
            trial["onset"], trial["offset"], trial["cluster"]
        ):
            a = int(np.round((onset - min_time) / time_per_frame))
            b = int(np.round((offset - min_time) / time_per_frame))
            fw[a:b] = cluster_codebook[cluster]
        frames.append(fw)

    voted = mode(np.asarray(frames), axis=0).mode
    voted = np.asarray(voted).reshape(-1)
    right = np.concatenate([voted, [-1.0]])
    left = np.concatenate([[-1.0], voted])
    events = np.nonzero(right - left != 0)[0]

    inverse = {v: k for k, v in cluster_codebook.items()}
    onsets, offsets, clusters = [], [], []
    for idx in range(len(events) - 1):
        a, b = events[idx], events[idx + 1]
        cid = int(np.round(np.mean(voted[a:b])))
        if cid == -1:
            continue
        onsets.append(a * time_per_frame + min_time)
        offsets.append(b * time_per_frame + min_time)
        clusters.append(inverse[cid])
    return {"onset": onsets, "offset": offsets, "cluster": clusters}
