"""The public segmentation API (the port of ``whisperseg_tpu/segmenter.py``).

``Segmenter.segment(audio, sr, ...)`` runs the same pipeline as the JAX
package, on the card by default:

  1. multi-trial sliding windows with a per-trial shifted zero left-pad;
  2. per batch of windows: log-mel features, the encoder, the frame head on
     the same encoder output, and greedy or beam decoding;
  3. token parse -> per-trial window-boundary merge -> clamp/sort/min-length
     filter, then DBSCAN or frame-voting consolidation across trials;
  4. FFT-blur correction and duplicate removal;
  5. the checkpoint's post-processing chains (energy, then frame head);
  6. 3-decimal rounding.

``inference_dtype="int8"`` / ``"int4"`` quantize the projection weights in
process (ops/quant.py) and ``segment(..., int8_kv=True)`` keeps the
cross-attention K/V in int8 (ops/cross_attention.py). Options that later
work will bring (sampling, constrained decoding, speculative decoding,
HF-format checkpoints) raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import codec
from .audio.frontend import Frontend
from .checkpoint import cast_params, load_checkpoint
from .consolidation import (consolidate_by_clustering, consolidate_by_voting,
                            merge_window_boundaries)
from .constants import RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP as RATIO
from .constants import fft_time_delta
from .decode import check_decode_options, generate
from .models.config import WhisperConfig
from .models.whisper import encoder_forward, frame_head_forward
from .ops.quant import quantize_params
from .refine import apply_frame_postprocess, apply_postprocess
from .runtime import resolve_device
from .scoring import frame_score, segment_score

_INFERENCE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANT_BITS = {"int8": 8, "int4": 4}


def _blur_correct_and_dedup(final: Dict[str, list],
                            time_delta: float) -> Dict[str, list]:
    """FFT-blur correction with midpoint collapse, then exact-duplicate
    removal after sorting by onset."""
    onsets, offsets = [], []
    for onset, offset in zip(final["onset"], final["offset"]):
        c_on, c_off = onset + time_delta, offset - time_delta
        if c_on > c_off:
            c_on = c_off = (onset + offset) / 2
        onsets.append(c_on)
        offsets.append(c_off)
    final["onset"], final["offset"] = onsets, offsets

    if final["onset"]:
        clean: List[Tuple[float, float, str]] = []
        for onset, offset, cluster in sorted(
            zip(final["onset"], final["offset"], final["cluster"]),
            key=lambda x: x[0],
        ):
            if not clean or (onset, offset, cluster) != clean[-1]:
                clean.append((onset, offset, cluster))
        final["onset"] = [c[0] for c in clean]
        final["offset"] = [c[1] for c in clean]
        final["cluster"] = [c[2] for c in clean]
    return final


def _round_and_rededup(final: Dict[str, list],
                       precision_bits: int) -> Dict[str, list]:
    """Final rounding, then duplicate removal over the full (onset, offset,
    cluster) sort: post-processing can snap two segments to one boundary."""
    final["onset"] = [float(np.round(t, precision_bits)) for t in final["onset"]]
    final["offset"] = [float(np.round(t, precision_bits)) for t in final["offset"]]
    if final["onset"]:
        clean = []
        for row in sorted(zip(final["onset"], final["offset"], final["cluster"])):
            if not clean or row != clean[-1]:
                clean.append(row)
        final["onset"] = [c[0] for c in clean]
        final["offset"] = [c[1] for c in clean]
        final["cluster"] = [c[2] for c in clean]
    return final


def _tracks_from_window_frames(probs: np.ndarray, cluster: np.ndarray,
                               duration_s: float,
                               spec_time_step: float) -> Dict[str, np.ndarray]:
    """Frame-head outputs of the N trial-0 windows of one audio ([N, S, 3],
    [N, S]) -> tracks truncated to the audio's length on the decoder time
    base (quantum = spec_time_step * RATIO)."""
    probs = probs.reshape(-1, 3)
    cluster = cluster.reshape(-1)
    quantum = spec_time_step * RATIO
    n_t = int(np.ceil(duration_s / quantum)) if duration_s else 0
    probs, cluster = probs[:n_t], cluster[:n_t]
    return {"vocal": probs[:, 0], "onset": probs[:, 1],
            "offset": probs[:, 2], "cluster": cluster,
            "quantum": quantum}


class Segmenter:
    """Segmentation front door over a (params, config) pair. Every parameter
    is cast to ``inference_dtype`` (bfloat16 by default) and moved to
    ``device`` (the card by default). ``"int8"`` stores the projection
    weights as per-channel int8 (the counterpart of CTranslate2's
    ``int8_float16``), ``"int4"`` as group-wise packed int4, both quantized
    from the parameters as given (float32 from a checkpoint) with the rest in
    bfloat16. ``None`` keeps ``params`` itself, neither cast nor moved: a
    training run validates on its live float32 weights, which its optimizer
    updates in place (they must already lie on ``device``)."""

    def __init__(self, params, config: WhisperConfig,
                 inference_dtype: Optional[str] = "bfloat16", device=None):
        if inference_dtype in _QUANT_BITS:
            params = quantize_params(params, bits=_QUANT_BITS[inference_dtype])
            dtype = torch.bfloat16
        elif inference_dtype in _INFERENCE_DTYPES:
            dtype = _INFERENCE_DTYPES[inference_dtype]
        elif inference_dtype is not None:
            raise ValueError(f"unsupported inference_dtype {inference_dtype!r}")
        self.device = resolve_device(device)
        self.params = (params if inference_dtype is None
                       else cast_params(params, dtype, self.device))
        self.config = config
        self.total_spec_columns = config.total_spec_columns
        self.cluster_codebook: Dict[str, int] = dict(config.cluster_codebook)
        self.default_segmentation_config: Dict = dict(
            config.default_segmentation_config)
        self.precision_bits = 3

    @classmethod
    def from_pretrained(cls, model_path: str, inference_dtype: str = "bfloat16",
                        device=None) -> "Segmenter":
        """Load a checkpoint directory holding ``params.npz`` +
        ``config.json``."""
        device = resolve_device(device)
        if not os.path.exists(os.path.join(model_path, "params.npz")):
            raise NotImplementedError(
                f"{model_path!r} is not a params.npz checkpoint directory; "
                f"HF-format checkpoints and hub names are not ported yet: "
                f"ROADMAP.md Queue A item 12 (HF import/export)")
        params, config = load_checkpoint(model_path)
        return cls(params, config, inference_dtype=inference_dtype,
                   device=device)

    def set_draft_model(self, model_path: str, spec_k: int = 4):
        raise NotImplementedError(
            "speculative decoding is not ported yet: ROADMAP.md Queue A item "
            "10 (speculative decoding)")

    @property
    def inverse_cluster_codebook(self) -> Dict[int, str]:
        return {v: k for k, v in self.cluster_codebook.items()}

    def update_cluster_codebook(self, cluster_codebook: Dict[str, int]):
        """Replace the cluster codebook, here and in the config."""
        self.cluster_codebook = dict(cluster_codebook)
        self.config.cluster_codebook = dict(cluster_codebook)

    def segment_score(self, prediction, label, target_cluster=None,
                      tolerance=None):
        """Segment-wise scores (scoring.py); the tolerance defaults to four
        spectrogram steps of the checkpoint's default configuration."""
        if tolerance is None:
            tolerance = self.default_segmentation_config.get(
                "spec_time_step", 0.0025) * 4
        return segment_score(prediction, label, target_cluster, tolerance)

    def frame_score(self, prediction, label, target_cluster=None,
                    time_per_frame_for_scoring=None):
        """Frame-wise scores (scoring.py) on frames of at most 1 ms."""
        if time_per_frame_for_scoring is None:
            time_per_frame_for_scoring = min(
                0.001, self.default_segmentation_config.get(
                    "spec_time_step", 0.0025))
        return frame_score(prediction, label, target_cluster,
                           time_per_frame_for_scoring)

    # ------------------------------------------------------------------ slicing

    def slice_audio_windows(
        self, audio: np.ndarray, sr: int, spec_time_step: float, num_trials: int
    ) -> Tuple[np.ndarray, List[Tuple[int, float, float]]]:
        """Multi-trial sliding windows -> (clips [N, clip_samples] float32,
        zero-padded to full length; meta of (trial_id, offset_seconds,
        actual_duration_seconds))."""
        clip_duration = self.total_spec_columns * spec_time_step
        clip_samples = int(clip_duration * sr)
        clips, meta = [], []
        for trial_id in range(num_trials):
            padding_time = (
                np.round(clip_duration * trial_id / num_trials / spec_time_step)
                * spec_time_step
            )
            num_pad = int(padding_time * sr)
            padded = np.concatenate(
                [np.zeros(num_pad, dtype=np.float32), np.asarray(audio, np.float32)]
            )
            # at least one window, even for empty audio
            for pos in range(0, max(len(padded), 1), clip_samples):
                clip = padded[pos:pos + clip_samples]
                full = np.zeros(clip_samples, dtype=np.float32)
                full[: len(clip)] = clip
                clips.append(full)
                meta.append((trial_id, pos / sr - padding_time, len(clip) / sr))
        return np.stack(clips), meta

    # --------------------------------------------------------------- generation

    @torch.no_grad()
    def _generate_tokens(self, clips: np.ndarray, frontend: Frontend,
                         batch_size: int, max_length: int, num_beams: int,
                         length_penalty: float,
                         status_monitor: Optional[dict] = None,
                         collect_frames: bool = False,
                         int8_kv: bool = False):
        """Frontend -> encoder -> decode over fixed-size batches (the last one
        zero-padded, so every batch has one shape and the padded rows step
        the decode loop exactly as in the JAX package).

        Returns the token lists, or with ``collect_frames=True``
        ``(token_lists, probs [N, S, 3], cluster [N, S])`` with the frame
        tracks from the same encoder pass as the decode."""
        cfg = self.config
        n = clips.shape[0]
        out: List[List[int]] = []
        probs_parts, cl_parts = [], []
        for pos in range(0, n, batch_size):
            chunk = clips[pos:pos + batch_size]
            real = chunk.shape[0]
            if real < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - real,) + chunk.shape[1:],
                                     chunk.dtype)])
            x = torch.from_numpy(chunk).to(self.device)
            feats = frontend.features_for_clips(x, self.total_spec_columns)
            enc = encoder_forward(self.params, cfg, feats)
            tokens = generate(self.params, cfg, max_length=max_length,
                              num_beams=num_beams,
                              length_penalty=length_penalty,
                              int8_kv=int8_kv, enc_out=enc)
            if collect_frames:
                logits = frame_head_forward(self.params, cfg, enc)
                probs = torch.sigmoid(logits[..., :3])
                if logits.shape[-1] > 3:
                    cl = torch.argmax(logits[..., 3:], dim=-1).to(torch.int32)
                else:
                    cl = torch.full(logits.shape[:2], -1, dtype=torch.int32)
                probs_parts.append(probs[:real].cpu().numpy())
                cl_parts.append(cl[:real].cpu().numpy())
            out += tokens[:real].cpu().tolist()
            if status_monitor is not None:
                status_monitor["progress"] = int(
                    np.round(min(pos + batch_size, n) / n * 100))
        if collect_frames:
            return out, np.concatenate(probs_parts), np.concatenate(cl_parts)
        return out

    # ------------------------------------------------------------------ parsing

    def _parse_generation(
        self,
        token_lists: List[List[int]],
        meta: List[Tuple[int, float, float]],
        min_segment_length: float,
        audio_duration: float,
        spec_time_step: float,
        num_trials: int,
        eps: float,
        time_per_frame_for_voting: float,
        consolidation_method: str,
    ) -> Dict[str, list]:
        inverse = self.inverse_cluster_codebook
        per_trial_windows: Dict[int, List[List[List]]] = {}
        for tokens, (trial_id, offset_time, _dur) in zip(token_lists, meta):
            segs = codec.parse_segments_from_ids(
                tokens, spec_time_step, inverse,
                extra_tokens=self.config.extra_tokens)
            for s in segs:
                s[0] += offset_time
                s[1] += offset_time
            per_trial_windows.setdefault(trial_id, []).append(segs)

        trials_results = []
        for trial_id in per_trial_windows:
            merged = merge_window_boundaries(per_trial_windows[trial_id])
            for s in merged:
                s[0] = max(0.0, s[0])
                s[1] = min(s[1], audio_duration)
            merged.sort(key=lambda s: s[0])
            merged = [s for s in merged if s[1] - s[0] >= min_segment_length]
            trials_results.append({
                "onset": [s[0] for s in merged],
                "offset": [s[1] for s in merged],
                "cluster": [s[2] for s in merged],
            })

        if num_trials == 1:
            final = trials_results[0]
        elif consolidation_method == "clustering":
            min_samples = max(2, int(np.ceil(num_trials * 0.5)))
            stats = {}
            final = consolidate_by_clustering(trials_results, eps, min_samples,
                                              stats=stats)
            noise = (stats["n_noise"] / stats["n_input"]
                     if stats["n_input"] else 0.0)
            if stats["n_input"] >= 2 * num_trials and noise > 0.5:
                warnings.warn(
                    f"multi-trial consolidation discarded "
                    f"{stats['n_noise']}/{stats['n_input']} segments "
                    f"({noise:.0%}) as cross-trial "
                    f"disagreement — the model's predictions are unstable "
                    f"under window shifts; num_trials=1 will likely have "
                    f"much better recall", stacklevel=2)
        else:
            final = consolidate_by_voting(
                trials_results, time_per_frame_for_voting, self.cluster_codebook)

        final["onset"] = [float(np.round(t, self.precision_bits))
                          for t in final["onset"]]
        final["offset"] = [float(np.round(t, self.precision_bits))
                           for t in final["offset"]]
        return final

    # --------------------------------------------------------------- public API

    def segment(
        self,
        audio: np.ndarray,
        sr: int,
        min_frequency: Optional[float] = None,
        spec_time_step: Optional[float] = None,
        min_segment_length: Optional[float] = None,
        eps: Optional[float] = None,
        time_per_frame_for_voting: Optional[float] = None,
        consolidation_method: str = "clustering",
        max_length: Optional[int] = None,
        batch_size: int = 4,
        num_trials: int = 1,
        num_beams: int = 4,
        top_k: int = 1,
        top_p: float = 1.0,
        length_penalty: float = 1.0,
        status_monitor: Optional[dict] = None,
        seed: int = 0,
        constrained: bool = False,
        int8_kv: bool = False,
        refine_boundaries_ms: Optional[float] = None,
        split_merged_db: Optional[float] = None,
        merge_gap_ms: Optional[float] = None,
        frame_split: Optional[float] = None,
        frame_refine_ms: Optional[float] = None,
        frame_filter: Optional[float] = None,
    ) -> Dict[str, list]:
        """Segment one audio array -> {"onset": [...], "offset": [...],
        "cluster": [...]}. Defaults: explicit argument > the checkpoint's
        default_segmentation_config > literal. ``seed`` only matters to
        sampling, which is not ported yet."""
        check_decode_options(top_k, top_p, constrained)
        dsc = self.default_segmentation_config
        if min_frequency is None:
            min_frequency = dsc.get("min_frequency", 0)
        if spec_time_step is None:
            spec_time_step = dsc.get("spec_time_step", 0.0025)
        if merge_gap_ms is None:
            merge_gap_ms = dsc.get("merge_gap_ms", 0)
        if split_merged_db is None:
            split_merged_db = dsc.get("split_merged_db", 0)
        if refine_boundaries_ms is None:
            refine_boundaries_ms = dsc.get("refine_boundaries_ms", 0)
        if frame_split is None:
            frame_split = dsc.get("frame_split", 0)
        if frame_refine_ms is None:
            frame_refine_ms = dsc.get("frame_refine_ms", 0)
        if frame_filter is None:
            frame_filter = dsc.get("frame_filter", 0)
        if min_segment_length is None:
            min_segment_length = spec_time_step * RATIO
        if eps is None:
            eps = spec_time_step * RATIO * 4
        if time_per_frame_for_voting is None:
            time_per_frame_for_voting = spec_time_step
        if max_length is None:
            max_length = int(dsc.get("max_length", 448))

        audio = np.asarray(audio, dtype=np.float32)
        clips, meta = self.slice_audio_windows(audio, sr, spec_time_step,
                                               num_trials)
        need_frames = bool((frame_split or frame_refine_ms or frame_filter)
                           and "frame_head" in self.params)
        frontend = Frontend(sr, spec_time_step, min_frequency)
        gen = self._generate_tokens(clips, frontend, batch_size, max_length,
                                    num_beams, length_penalty, status_monitor,
                                    collect_frames=need_frames,
                                    int8_kv=int8_kv)
        if need_frames:
            token_lists, all_probs, all_cl = gen
            n0 = sum(1 for m in meta if m[0] == 0)  # trial-0 window count
            tracks = _tracks_from_window_frames(
                all_probs[:n0], all_cl[:n0], len(audio) / sr, spec_time_step)
        else:
            token_lists = gen

        final = self._parse_generation(
            token_lists, meta, min_segment_length, len(audio) / sr,
            spec_time_step, num_trials, eps, time_per_frame_for_voting,
            consolidation_method)
        time_delta = fft_time_delta(sr)
        final = _blur_correct_and_dedup(final, time_delta)
        final = apply_postprocess(
            final, audio, sr, merge_gap_ms=merge_gap_ms,
            split_merged_db=split_merged_db,
            refine_boundaries_ms=refine_boundaries_ms,
            min_len_s=min_segment_length)
        if need_frames:
            final = apply_frame_postprocess(
                final, tracks, time_delta, frame_split=frame_split,
                frame_refine_ms=frame_refine_ms, frame_filter=frame_filter,
                min_len_s=min_segment_length)
        return _round_and_rededup(final, self.precision_bits)
