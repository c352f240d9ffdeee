"""Segment-wise and frame-wise scoring (a copy of
``whisperseg_tpu/scoring.py``): greedy first-match with removal, inclusive
tolerance, frame rasterization with round-half-to-even. These are the
definitions every published WhisperSeg F1 is computed with.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def compute_syllable_score(
    prediction_list, label_list, tolerance: float
) -> Tuple[int, int, int]:
    """Greedy segment matching (reference model.py:474-491).

    A prediction matches the first remaining label with |Δonset| <= tol,
    |Δoffset| <= tol and equal cluster; matched labels are removed.
    Returns (TP, #pred, #label). ``label_list`` is consumed.
    """
    n_pred = len(prediction_list)
    n_label = len(label_list)
    tp = 0
    remaining = list(label_list)
    for p_on, p_off, p_cl in prediction_list:
        for i, (l_on, l_off, l_cl) in enumerate(remaining):
            if (
                abs(p_on - l_on) <= tolerance
                and abs(p_off - l_off) <= tolerance
                and p_cl == l_cl
            ):
                tp += 1
                remaining.pop(i)
                break
    return tp, n_pred, n_label


def _prf(tp: float, p_pred: float, p_label: float):
    precision = tp / max(p_pred, 1e-12)
    recall = tp / max(p_label, 1e-12)
    f1 = 2 / (1 / max(precision, 1e-12) + 1 / max(recall, 1e-12))
    return precision, recall, f1


def segment_score(
    prediction: Dict[str, list],
    label: Dict[str, list],
    target_cluster: Optional[str] = None,
    tolerance: float = 0.01,
):
    """Segment-wise TP/precision/recall/F1 (reference model.py:493-516)."""
    pred_list = [
        [prediction["onset"][i], prediction["offset"][i], str(prediction["cluster"][i])]
        for i in range(len(prediction["onset"]))
        if target_cluster is None or str(target_cluster) == str(prediction["cluster"][i])
    ]
    label_list = [
        [label["onset"][i], label["offset"][i], str(label["cluster"][i])]
        for i in range(len(label["onset"]))
        if target_cluster is None or str(target_cluster) == str(label["cluster"][i])
    ]
    tp, p_pred, p_label = compute_syllable_score(pred_list, label_list, tolerance)
    precision, recall, f1 = _prf(tp, p_pred, p_label)
    return tp, p_pred, p_label, precision, recall, f1


def frame_score(
    prediction: Dict[str, list],
    label: Dict[str, list],
    target_cluster: Optional[str] = None,
    time_per_frame_for_scoring: float = 0.001,
):
    """Frame-wise TP/precision/recall/F1 (reference model.py:518-569)."""
    pred_clusters = list(map(str, prediction["cluster"]))
    label_clusters = list(map(str, label["cluster"]))

    mapper: Dict[str, int] = {}
    # target_cluster always gets an id, even when neither side of a file
    # contains it — that file then contributes zeros instead of a KeyError
    # aborting the whole corpus evaluation (the reference crashes here,
    # model.py:544; graceful superset)
    extra = [] if target_cluster is None else [str(target_cluster)]
    for c in pred_clusters + label_clusters + extra:
        if c not in mapper:
            mapper[c] = len(mapper)

    all_ts = (
        list(prediction["onset"]) + list(prediction["offset"])
        + list(label["onset"]) + list(label["offset"])
    )
    max_time = float(np.max(all_ts)) if all_ts else 1.0
    num_frames = int(np.round(max_time / time_per_frame_for_scoring)) + 1

    def rasterize(onsets, offsets, clusters):
        fw = np.full(num_frames, -1.0)
        for i in range(len(onsets)):
            a = int(np.round(onsets[i] / time_per_frame_for_scoring))
            b = int(np.round(offsets[i] / time_per_frame_for_scoring))
            fw[a:b] = mapper[clusters[i]]
        return fw

    fw_pred = rasterize(prediction["onset"], prediction["offset"], pred_clusters)
    fw_label = rasterize(label["onset"], label["offset"], label_clusters)

    if target_cluster is None:
        tp = int(np.logical_and(fw_label != -1, fw_pred == fw_label).sum())
        p_pred = int((fw_pred != -1).sum())
        p_label = int((fw_label != -1).sum())
    else:
        cid = mapper[str(target_cluster)]
        tp = int(np.logical_and(fw_label == cid, fw_pred == fw_label).sum())
        p_pred = int((fw_pred == cid).sum())
        p_label = int((fw_label == cid).sum())

    precision, recall, f1 = _prf(tp, p_pred, p_label)
    return tp, p_pred, p_label, precision, recall, f1
