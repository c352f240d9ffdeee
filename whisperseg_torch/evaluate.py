"""Corpus evaluation (the port of ``whisperseg_tpu/evaluate.py``): numpy
scoring over ``Segmenter.segment``. ``run_training`` runs :func:`evaluate`
as its validation."""

from __future__ import annotations

from typing import Optional

from .scoring import _prf


def evaluate(audio_list, label_list, segmenter, batch_size, max_length,
             num_trials, num_beams: int = 4, target_cluster: Optional[str] = None,
             verbose: bool = True, refine_boundaries_ms=None,
             split_merged_db=None, merge_gap_ms=None, frame_mode: bool = False,
             frame_split=None, frame_refine_ms=None, frame_filter=None,
             label_tolerance: bool = False):
    """Micro-averaged segment-wise and frame-wise P/R/F1 over a corpus, as
    ``[tp, n_pred, n_label, precision, recall, f1]`` under "segment_wise" and
    "frame_wise". Scores use the segmenter's default tolerances;
    ``label_tolerance=True`` honours the labels' ``tolerance`` /
    ``time_per_frame_for_scoring`` instead. ``verbose`` prints progress."""
    if frame_mode:
        raise NotImplementedError(
            "frame-VAD evaluation is not ported yet: ROADMAP.md Queue A item 7 "
            "(frame-VAD mode)")
    seg_tp = seg_pred = seg_label = 0
    fr_tp = fr_pred = fr_label = 0
    for n, (audio, label) in enumerate(zip(audio_list, label_list), 1):
        prediction = segmenter.segment(
            audio,
            sr=label["sr"],
            min_frequency=label.get("min_frequency", None),
            spec_time_step=label.get("spec_time_step", None),
            max_length=max_length,
            batch_size=batch_size,
            num_trials=num_trials,
            num_beams=num_beams,
            refine_boundaries_ms=refine_boundaries_ms,
            split_merged_db=split_merged_db,
            merge_gap_ms=merge_gap_ms,
            frame_split=frame_split,
            frame_refine_ms=frame_refine_ms,
            frame_filter=frame_filter,
        )
        tol = label.get("tolerance") if label_tolerance else None
        tpf = label.get("time_per_frame_for_scoring") if label_tolerance else None
        tp, p_pred, p_label = segmenter.segment_score(
            prediction, label, target_cluster=target_cluster, tolerance=tol)[:3]
        seg_tp, seg_pred, seg_label = seg_tp + tp, seg_pred + p_pred, seg_label + p_label
        tp, p_pred, p_label = segmenter.frame_score(
            prediction, label, target_cluster=target_cluster,
            time_per_frame_for_scoring=tpf)[:3]
        fr_tp, fr_pred, fr_label = fr_tp + tp, fr_pred + p_pred, fr_label + p_label
        if verbose:
            print(f"evaluate: {n}/{len(audio_list)} files", flush=True)

    def prf(tp, pred, label):
        return [tp, pred, label, *_prf(tp, pred, label)]

    return {"segment_wise": prf(seg_tp, seg_pred, seg_label),
            "frame_wise": prf(fr_tp, fr_pred, fr_label)}

