"""Corpus evaluation (the port of ``whisperseg_tpu/evaluate.py``): numpy
scoring over ``Segmenter.segment`` or, in frame mode,
``Segmenter.segment_from_frames``. ``run_training`` runs :func:`evaluate`
as its validation."""

from __future__ import annotations

from typing import Optional

from .audio.io import load_audio
from .data import get_audio_and_label_paths, read_label
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
    ``time_per_frame_for_scoring`` instead. ``verbose`` prints progress.
    ``frame_mode=True`` segments with the decoder-free frame-VAD path; its
    thresholds come from the checkpoint unless a label sets
    ``frame_vocal_threshold`` / ``frame_cut_threshold`` /
    ``frame_boundary_snap`` / ``frame_gap_cut``."""
    seg_tp = seg_pred = seg_label = 0
    fr_tp = fr_pred = fr_label = 0
    for n, (audio, label) in enumerate(zip(audio_list, label_list), 1):
        if frame_mode:
            prediction = segmenter.segment_from_frames(
                audio,
                sr=label["sr"],
                min_frequency=label.get("min_frequency", None),
                spec_time_step=label.get("spec_time_step", None),
                batch_size=batch_size,
                vocal_threshold=label.get("frame_vocal_threshold", None),
                cut_threshold=label.get("frame_cut_threshold", None),
                boundary_snap=label.get("frame_boundary_snap", None),
                gap_cut=label.get("frame_gap_cut", None),
            )
        else:
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


def evaluate_dataset(dataset_folder: str, model_path: str, num_trials: int,
                     max_length: Optional[int] = None, num_beams: int = 4,
                     batch_size: int = 8, inference_dtype: str = "bfloat16",
                     refine_boundaries_ms=None, split_merged_db=None,
                     merge_gap_ms=None, frame_mode: bool = False,
                     frame_split=None, frame_refine_ms=None, frame_filter=None,
                     ignore_cluster: bool = False,
                     frame_vocal_threshold=None, frame_cut_threshold=None,
                     frame_boundary_snap=None, frame_gap_cut=None,
                     label_tolerance: bool = False, segmenter=None,
                     device=None, verbose: bool = True):
    """Scores of a folder of audio files and their labels, as
    ``{"segment_wise_scores": {...}, "frame_wise_scores": {...}}``.

    ``ignore_cluster=True`` flattens label clusters to "Vocal", for a VAD
    model scored against clustered labels. A given ``segmenter`` is used as
    it is (``model_path``, ``inference_dtype`` and ``device`` are then not
    read); otherwise one is loaded on ``device`` (the card by default). The
    explicit frame-mode thresholds override the labels' and the
    checkpoint's."""
    from .segmenter import Segmenter

    audio_list, label_list = [], []
    for audio_path, label_path in zip(
            *get_audio_and_label_paths(dataset_folder)):
        label = read_label(label_path, ignore_cluster=ignore_cluster)
        audio, sr = load_audio(audio_path, sr=label.get("sr", None))
        label["sr"] = sr
        for key, val in (("frame_vocal_threshold", frame_vocal_threshold),
                         ("frame_cut_threshold", frame_cut_threshold),
                         ("frame_boundary_snap", frame_boundary_snap),
                         ("frame_gap_cut", frame_gap_cut)):
            if val is not None:
                label[key] = val
        audio_list.append(audio)
        label_list.append(label)

    if segmenter is None:
        segmenter = Segmenter.from_pretrained(
            model_path, inference_dtype=inference_dtype, device=device)
    res = evaluate(audio_list, label_list, segmenter, batch_size, max_length,
                   num_trials, num_beams, target_cluster=None, verbose=verbose,
                   refine_boundaries_ms=refine_boundaries_ms,
                   split_merged_db=split_merged_db, merge_gap_ms=merge_gap_ms,
                   frame_mode=frame_mode, frame_split=frame_split,
                   frame_refine_ms=frame_refine_ms, frame_filter=frame_filter,
                   label_tolerance=label_tolerance)

    def expand(row):
        return {"N-true-positive": row[0],
                "N-positive-in-prediction": row[1],
                "N-positive-in-ground-truth": row[2],
                "precision": row[3], "recall": row[4], "F1": row[5]}

    return {"segment_wise_scores": expand(res["segment_wise"]),
            "frame_wise_scores": expand(res["frame_wise"])}
