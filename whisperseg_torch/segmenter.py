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
cross-attention K/V in int8 (ops/cross_attention.py). ``top_k`` / ``top_p``
sample and ``constrained`` masks the transcript grammar (decode.py).

Besides ``segment()``: ``segment_from_frames()``, the decoder-free frame-VAD
mode (features, encoder and frame head, then ``refine.segments_from_tracks``);
``segment_streaming()``, which reads a WAV file in chunks at bounded memory
(audio/stream.py) and gives ``segment()``'s table; and ``warmup()``, which
builds the kernels and runs one batch of each path before a service takes
requests. ``set_draft_model()`` turns on greedy speculative decoding
(decode.generate_speculative) for the requests it applies to.
``from_pretrained`` reads our checkpoints and HF-format ones
(models/convert_hf.py).

``Segmenter(..., mesh=make_mesh(...))`` (parallel/mesh.py) puts a copy of
the weights on each device of the mesh's data axis, splits each padded
batch by rows over them, decodes each part on its own device (one host
thread a device) and puts the rows back in order; sampling noise is drawn
for the whole batch and cut by rows, so tables equal ``mesh=None``'s.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
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
from .decode import generate, generate_speculative, gumbel_noise, samples
from .hub import download_model
from .models.config import WhisperConfig
from .models.convert_hf import import_hf_checkpoint
from .models.whisper import encoder_forward, frame_head_forward
from .ops import _build
from .ops.quant import quantize_params
from .refine import (apply_frame_postprocess, apply_postprocess,
                     merge_small_gaps, segments_from_tracks)
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


def _frame_outputs(params, cfg: WhisperConfig, enc: torch.Tensor):
    """Encoder states -> (probs [B, S, 3] float32, the vocal / onset / offset
    sigmoids, and cluster ids [B, S] int32, -1 without a cluster channel)."""
    logits = frame_head_forward(params, cfg, enc)
    probs = torch.sigmoid(logits[..., :3])
    if logits.shape[-1] > 3:
        cl = torch.argmax(logits[..., 3:], dim=-1).to(torch.int32)
    else:
        cl = torch.full(logits.shape[:2], -1, dtype=torch.int32)
    return probs, cl


def _pad_rows(chunk: np.ndarray, rows: int) -> np.ndarray:
    """Zero rows appended up to ``rows``: every batch of a call has one shape,
    and padded rows step the decode loop as in the JAX package."""
    if chunk.shape[0] >= rows:
        return chunk
    return np.concatenate(
        [chunk, np.zeros((rows - chunk.shape[0],) + chunk.shape[1:],
                         chunk.dtype)])


class _RowNoise:
    """Sampling noise for a batch split by rows: each step's noise is drawn
    once for the whole batch, from ``draw`` in step order, and each part
    takes its rows of it (:meth:`part`)."""

    def __init__(self, draw, rows: int, device):
        self.draw, self.rows, self.device = draw, rows, device
        self.steps: List[torch.Tensor] = []
        self.lock = threading.Lock()

    def part(self, start: int, stop: int):
        count = itertools.count()

        def draw(shape, device):
            k = next(count)
            with self.lock:
                while len(self.steps) <= k:
                    self.steps.append(self.draw(
                        (self.rows,) + tuple(shape[1:]), self.device))
                step = self.steps[k]
            return step[start:stop].to(device)
        return draw


def _bf16_draft(params: dict, device) -> dict:
    """A draft model's tree on ``device`` with its float32 leaves in
    bfloat16, as the JAX package casts a draft."""
    return {k: _bf16_draft(v, device) if isinstance(v, dict) else v.to(
        device=device,
        dtype=torch.bfloat16 if v.dtype == torch.float32 else None)
        for k, v in params.items()}


class Segmenter:
    """Segmentation front door over a (params, config) pair. Every parameter
    is cast to ``inference_dtype`` (bfloat16 by default) and moved to
    ``device`` (the card by default). ``"int8"`` stores the projection
    weights as per-channel int8 (the counterpart of CTranslate2's
    ``int8_float16``), ``"int4"`` as group-wise packed int4, both quantized
    from the parameters as given (float32 from a checkpoint) with the rest in
    bfloat16. ``None`` keeps ``params`` itself, neither cast nor moved: a
    training run validates on its live float32 weights, which its optimizer
    updates in place (they must already lie on ``device``).

    ``mesh`` (parallel/mesh.py) replaces ``device``: the weights are copied
    to every device of its data axis (``self.device`` is the first) and
    each batch is split by rows over them."""

    def __init__(self, params, config: WhisperConfig,
                 inference_dtype: Optional[str] = "bfloat16", device=None,
                 mesh=None):
        if inference_dtype in _QUANT_BITS:
            params = quantize_params(params, bits=_QUANT_BITS[inference_dtype])
            dtype = torch.bfloat16
        elif inference_dtype in _INFERENCE_DTYPES:
            dtype = _INFERENCE_DTYPES[inference_dtype]
        elif inference_dtype is not None:
            raise ValueError(f"unsupported inference_dtype {inference_dtype!r}")
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both")
            # one replica for each device of the data axis
            self._mesh_devices = [mesh.devices[i, 0]
                                  for i in range(mesh.devices.shape[0])]
            device = self._mesh_devices[0]
        self.device = resolve_device(device)
        self.params = (params if inference_dtype is None
                       else cast_params(params, dtype, self.device))
        self.config = config
        self.total_spec_columns = config.total_spec_columns
        self.cluster_codebook: Dict[str, int] = dict(config.cluster_codebook)
        self.default_segmentation_config: Dict = dict(
            config.default_segmentation_config)
        self.precision_bits = 3
        # frame_probs runs on the caller's thread: one frame computation at a
        # time, so that concurrent frame-mode requests do not each hold their
        # own device batches
        self._frame_lock = threading.Lock()
        # the consolidation stats of each thread's last segment()
        self._consolidation_tls = threading.local()

    @classmethod
    def from_pretrained(cls, model_path: str, inference_dtype: str = "bfloat16",
                        device=None, mesh=None) -> "Segmenter":
        """Load a checkpoint directory, ours (``params.npz`` +
        ``config.json``) or a HuggingFace one (``model.safetensors`` or
        ``pytorch_model.bin`` + tokenizer files, imported by
        models/convert_hf.py), or a built-in or cached model by name
        (hub.download_model). ``mesh`` is as for the constructor."""
        device = resolve_device(device) if mesh is None else device
        resolved = (model_path if os.path.isdir(model_path)
                    else download_model(model_path))
        if os.path.exists(os.path.join(resolved, "params.npz")):
            params, config = load_checkpoint(resolved)
        else:
            params, config = import_hf_checkpoint(resolved,
                                                  total_spec_columns=None)
        return cls(params, config, inference_dtype=inference_dtype,
                   device=device, mesh=mesh)

    def set_draft_model(self, model_path: str, spec_k: int = 4):
        """Turn on greedy speculative decoding: a small draft checkpoint of
        the same vocabulary (e.g. a tiny fine-tune of the same data)
        proposes ``spec_k`` tokens a step and this model verifies them in
        one forward. The output is this model's greedy transcript; the speed
        follows the draft's agreement with it. Applies to greedy requests
        only (``num_beams <= 1``, no sampling, unconstrained, no
        ``int8_kv``). The draft's float32 leaves are cast to bfloat16."""
        if not os.environ.get("WS_SPEC_NO_WARN"):
            print("Warning: speculative decoding is not faster than plain "
                  "greedy decoding wherever a draft step costs about as much "
                  "as a target step, as it does when the device waits on the "
                  "host between steps: on an NVIDIA H100 80GB HBM3 (700 W), "
                  "the shipped tiny checkpoint drafting for the base one ran "
                  "at 0.36-0.51x of greedy's speed (chip_smoke.py's "
                  "speculative phase). Measure it on your hardware before "
                  "enabling it in production; set WS_SPEC_NO_WARN=1 to "
                  "silence this warning.", file=sys.stderr)
        dparams, dcfg = load_checkpoint(model_path)
        self.draft = (_bf16_draft(dparams, self.device), dcfg)
        self.spec_k = spec_k
        # verify forwards and committed tokens of every speculative batch
        self.spec_stats: dict = {}

    def _use_spec(self, num_beams: int, top_k: int, top_p: float,
                  constrained: bool, int8_kv: bool) -> bool:
        """Whether a request with these options decodes speculatively."""
        return (getattr(self, "draft", None) is not None and num_beams <= 1
                and top_k <= 1 and top_p >= 1.0 and not constrained
                and not int8_kv)

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

    def _encode(self, chunk: np.ndarray, frontend: Frontend) -> torch.Tensor:
        """Clips [B, clip_samples] -> log-mel features -> encoder states."""
        x = torch.from_numpy(chunk).to(self.device)
        feats = frontend.features_for_clips(x, self.total_spec_columns)
        return encoder_forward(self.params, self.config, feats)

    def _replica(self, device: torch.device):
        """(params, draft) on ``device``: a mesh's copies, made once for
        the current weights and draft."""
        draft = getattr(self, "draft", None)
        if device == self.device:
            return self.params, draft
        of = (id(self.params), id(draft))
        if getattr(self, "_replicas_of", None) != of:
            self._replicas, self._replicas_of = {}, of
        if device not in self._replicas:
            self._replicas[device] = (
                cast_params(self.params, None, device),
                None if draft is None else (cast_params(draft[0], None, device),
                                            draft[1]))
        return self._replicas[device]

    @torch.no_grad()
    def _decode_batch(self, chunk: np.ndarray, frontend: Frontend,
                      max_length: int, num_beams: int, length_penalty: float,
                      int8_kv: bool = False, top_k: int = 1,
                      top_p: float = 1.0, constrained: bool = False,
                      noise=None, collect_frames: bool = False):
        """One device batch of clips [B, clip_samples]: frontend -> encoder ->
        decode. Returns tokens [B, max_length] on the device, with
        ``collect_frames=True`` also the frame head's (probs, cluster) from
        the same encoder pass. On a mesh the rows are split over its data
        devices, each part decoded on its own thread, and the results put
        back together on ``self.device``."""
        args = (frontend, max_length, num_beams, length_penalty, int8_kv,
                top_k, top_p, constrained)
        if self.mesh is None:
            return self._decode_rows(chunk, self.device, *args, noise,
                                     collect_frames,
                                     getattr(self, "spec_stats", None))
        devices = self._mesh_devices
        rows = chunk.shape[0]
        if rows % len(devices):
            raise ValueError(f"a batch of {rows} rows does not divide over "
                             f"the mesh's {len(devices)} data devices")
        per = rows // len(devices)
        for device in devices:  # the copies, made here, not on the threads
            self._replica(device)
        row_noise = None if noise is None else _RowNoise(noise, rows,
                                                         self.device)
        stats = [{} for _ in devices]

        def part(i):
            return self._decode_rows(
                chunk[i * per:(i + 1) * per], devices[i], *args,
                None if row_noise is None else row_noise.part(
                    i * per, (i + 1) * per),
                collect_frames, stats[i])

        with ThreadPoolExecutor(len(devices)) as pool:
            outs = list(pool.map(part, range(len(devices))))
        sink = getattr(self, "spec_stats", None)
        if sink is not None:
            for st in stats:
                for k, v in st.items():
                    sink[k] = sink.get(k, 0) + v
        if collect_frames:
            return tuple(torch.cat([o[j].to(self.device) for o in outs])
                         for j in range(3))
        return torch.cat([o.to(self.device) for o in outs])

    def _decode_rows(self, chunk: np.ndarray, device, frontend: Frontend,
                     max_length: int, num_beams: int, length_penalty: float,
                     int8_kv: bool, top_k: int, top_p: float,
                     constrained: bool, noise, collect_frames: bool,
                     stats: Optional[dict]):
        """:meth:`_decode_batch` on ``device`` with its copy of the
        weights."""
        cfg = self.config
        params, draft = self._replica(device)
        with torch.no_grad():
            x = torch.from_numpy(chunk).to(device)
            feats = frontend.features_for_clips(x, self.total_spec_columns)
            enc = encoder_forward(params, cfg, feats)
            if self._use_spec(num_beams, top_k, top_p, constrained, int8_kv):
                dparams, dcfg = draft
                tokens = generate_speculative(
                    params, cfg, dparams, dcfg, feats, max_length=max_length,
                    spec_k=self.spec_k, enc_out=enc, stats=stats)
            else:
                tokens = generate(params, cfg, max_length=max_length,
                                  num_beams=num_beams, top_k=top_k,
                                  top_p=top_p, length_penalty=length_penalty,
                                  constrained=constrained, int8_kv=int8_kv,
                                  enc_out=enc, noise=noise)
            if collect_frames:
                return (tokens, *_frame_outputs(params, cfg, enc))
            return tokens

    def _sampling_noise(self, seed: int, top_k: int, top_p: float):
        """Gumbel noise from one generator seeded with ``seed`` on the
        device, drawn anew for every batch and step; None when greedy."""
        if not samples(top_k, top_p):
            return None
        return gumbel_noise(
            torch.Generator(device=self.device).manual_seed(int(seed)))

    def _generate_tokens(self, clips: np.ndarray, frontend: Frontend,
                         batch_size: int, max_length: int, num_beams: int,
                         length_penalty: float,
                         status_monitor: Optional[dict] = None,
                         collect_frames: bool = False,
                         int8_kv: bool = False, top_k: int = 1,
                         top_p: float = 1.0, seed: int = 0,
                         constrained: bool = False):
        """Frontend -> encoder -> decode over fixed-size batches (the last one
        zero-padded).

        Returns the token lists, or with ``collect_frames=True``
        ``(token_lists, probs [N, S, 3], cluster [N, S])`` with the frame
        tracks from the same encoder pass as the decode."""
        n = clips.shape[0]
        out: List[List[int]] = []
        probs_parts, cl_parts = [], []
        noise = self._sampling_noise(seed, top_k, top_p)
        for pos in range(0, n, batch_size):
            chunk = clips[pos:pos + batch_size]
            real = chunk.shape[0]
            result = self._decode_batch(
                _pad_rows(chunk, batch_size), frontend, max_length, num_beams,
                length_penalty, int8_kv, top_k, top_p, constrained, noise,
                collect_frames)
            if collect_frames:
                tokens, probs, cl = result
                probs_parts.append(probs[:real].cpu().numpy())
                cl_parts.append(cl[:real].cpu().numpy())
            else:
                tokens = result
            out += tokens[:real].cpu().tolist()
            if status_monitor is not None:
                status_monitor["progress"] = int(
                    np.round(min(pos + batch_size, n) / n * 100))
        if collect_frames:
            return out, np.concatenate(probs_parts), np.concatenate(cl_parts)
        return out

    def warmup(self, sr: int, spec_time_step: Optional[float] = None,
               min_frequency: Optional[float] = None, batch_size: int = 8,
               max_length: Optional[int] = None, num_beams: int = 4,
               top_k: int = 1):
        """Build the kernels (on the card) and run one batch of the default
        seq2seq configuration and, with a frame head, one frame batch, so that
        the first request pays for neither. Call at service start-up."""
        dsc = self.default_segmentation_config
        if spec_time_step is None:
            spec_time_step = dsc.get("spec_time_step", 0.0025)
        if min_frequency is None:
            min_frequency = dsc.get("min_frequency", 0)
        if max_length is None:
            max_length = int(dsc.get("max_length", 448))
        if self.device.type == "cuda":
            _build.build_all()
        clip_samples = int(self.total_spec_columns * spec_time_step * sr)
        clips = np.zeros((batch_size, clip_samples), dtype=np.float32)
        frontend = Frontend(sr, spec_time_step, min_frequency)
        self._generate_tokens(clips, frontend, batch_size, max_length,
                              num_beams, 1.0, top_k=top_k)
        if "frame_head" in self.params:
            self.frame_probs(np.zeros(clip_samples, np.float32), sr,
                             spec_time_step=spec_time_step,
                             min_frequency=min_frequency,
                             batch_size=batch_size)

    # --------------------------------------------------------------- frame head

    @torch.no_grad()
    def _frame_fn(self, chunk: np.ndarray, frontend: Frontend):
        """One device batch of clips -> features -> encoder -> frame head,
        with no decoder: (probs [B, S, 3], cluster [B, S]) as numpy."""
        probs, cl = _frame_outputs(self.params, self.config,
                                   self._encode(chunk, frontend))
        return probs.cpu().numpy(), cl.cpu().numpy()

    def _require_frame_head(self):
        if "frame_head" not in self.params:
            raise ValueError(
                "this model has no frame head; train with --frame_head")

    def frame_probs(self, audio, sr: int,
                    spec_time_step: Optional[float] = None,
                    min_frequency: Optional[float] = None,
                    batch_size: int = 8) -> Dict[str, np.ndarray]:
        """Frame-head probabilities of a whole audio on the decoder's time
        base: ``vocal`` / ``onset`` / ``offset`` float32 [T] and ``cluster``
        int32 [T] (-1 without a cluster channel), T = ceil(duration /
        quantum), and the scalar ``quantum`` = ``spec_time_step * RATIO``
        seconds. Needs a model trained with a frame head."""
        self._require_frame_head()
        dsc = self.default_segmentation_config
        if min_frequency is None:
            min_frequency = dsc.get("min_frequency", 0)
        if spec_time_step is None:
            spec_time_step = dsc.get("spec_time_step", 0.0025)
        audio = np.asarray(audio, dtype=np.float32)
        clips, _meta = self.slice_audio_windows(audio, sr, spec_time_step, 1)
        frontend = Frontend(sr, spec_time_step, min_frequency)
        probs_parts, cl_parts = [], []
        with self._frame_lock:
            for pos in range(0, clips.shape[0], batch_size):
                chunk = clips[pos:pos + batch_size]
                p, c = self._frame_fn(_pad_rows(chunk, batch_size), frontend)
                probs_parts.append(p[:chunk.shape[0]])
                cl_parts.append(c[:chunk.shape[0]])
        return _tracks_from_window_frames(
            np.concatenate(probs_parts), np.concatenate(cl_parts),
            len(audio) / sr if len(audio) else 0.0, spec_time_step)

    def _frame_mode_defaults(self, vocal_threshold, cut_threshold,
                             boundary_snap, gap_cut):
        """Explicit argument > the checkpoint's fitted value > literal."""
        dsc = self.default_segmentation_config
        if vocal_threshold is None:
            vocal_threshold = dsc.get("frame_vocal_threshold", 0.5)
        if cut_threshold is None:
            cut_threshold = dsc.get("frame_cut_threshold", 0.5)
        if boundary_snap is None:
            boundary_snap = int(dsc.get("frame_boundary_snap", 2))
        if gap_cut is None:
            gap_cut = int(dsc.get("frame_gap_cut", 0))
        return dict(vocal_threshold=vocal_threshold,
                    cut_threshold=cut_threshold, boundary_snap=boundary_snap,
                    gap_cut=gap_cut)

    def segment_from_frames(self, audio, sr: int,
                            spec_time_step: Optional[float] = None,
                            min_frequency: Optional[float] = None,
                            batch_size: int = 8,
                            vocal_threshold: Optional[float] = None,
                            cut_threshold: Optional[float] = None,
                            boundary_snap: Optional[int] = None,
                            min_segment_length: Optional[float] = None,
                            gap_cut: Optional[int] = None) -> Dict[str, list]:
        """Decoder-free segmentation from the frame head (the frame-VAD mode):
        one encoder pass per window, then ``refine.segments_from_tracks``
        (threshold the vocal track into runs, cut runs where both event
        tracks fire, snap boundaries to event peaks, FFT-blur correction).
        The thresholds default to the checkpoint's fitted
        ``frame_vocal_threshold`` / ``frame_cut_threshold`` /
        ``frame_boundary_snap`` / ``frame_gap_cut``, else 0.5 / 0.5 / 2 /
        0."""
        dsc = self.default_segmentation_config
        if min_frequency is None:
            min_frequency = dsc.get("min_frequency", 0)
        if spec_time_step is None:
            spec_time_step = dsc.get("spec_time_step", 0.0025)
        if min_segment_length is None:
            min_segment_length = spec_time_step * RATIO
        knobs = self._frame_mode_defaults(vocal_threshold, cut_threshold,
                                          boundary_snap, gap_cut)
        tracks = self.frame_probs(audio, sr, spec_time_step=spec_time_step,
                                  min_frequency=min_frequency,
                                  batch_size=batch_size)
        return segments_from_tracks(
            tracks, len(np.asarray(audio)) / sr, fft_time_delta(sr),
            self.inverse_cluster_codebook,
            min_segment_length=min_segment_length,
            precision_bits=self.precision_bits, **knobs)

    # ---------------------------------------------------------------- streaming

    def _stream_frame_tracks(self, stream, spec_time_step: float,
                             min_frequency: float, batch_size: int,
                             status_monitor: Optional[dict] = None):
        """:meth:`frame_probs` over an AudioStream, in one pass at O(chunk)
        memory. Returns the tracks and the stream's sample count."""
        self._require_frame_head()
        sr = stream.sr
        clip_samples = int(self.total_spec_columns * spec_time_step * sr)
        frontend = Frontend(sr, spec_time_step, min_frequency)
        probs_parts, cl_parts = [], []
        pend: List[np.ndarray] = []
        total_samples = 0
        n_windows = 0

        def flush(force=False):
            while len(pend) >= batch_size or (force and pend):
                take = pend[:batch_size]
                del pend[:batch_size]
                p, c = self._frame_fn(_pad_rows(np.stack(take), batch_size),
                                      frontend)
                probs_parts.append(p[:len(take)])
                cl_parts.append(c[:len(take)])

        with self._frame_lock:
            carry = np.zeros(0, np.float32)
            for chunk in stream:
                total_samples += len(chunk)
                buf = np.concatenate([carry, chunk]) if len(carry) else chunk
                nwin = len(buf) // clip_samples
                for k in range(nwin):
                    pend.append(buf[k * clip_samples:(k + 1) * clip_samples])
                n_windows += nwin
                carry = buf[nwin * clip_samples:].copy()
                flush()
                if status_monitor is not None and stream.duration:
                    status_monitor["progress"] = int(np.round(min(
                        total_samples / sr / stream.duration, 1.0) * 100))
            if len(carry) or n_windows == 0:
                tail = np.zeros(clip_samples, np.float32)
                tail[:len(carry)] = carry
                pend.append(tail)
            flush(force=True)
        return _tracks_from_window_frames(
            np.concatenate(probs_parts), np.concatenate(cl_parts),
            total_samples / sr, spec_time_step), total_samples

    def segment_streaming(
        self,
        path: str,
        sr: Optional[int] = None,
        *,
        chunk_seconds: float = 60.0,
        channel_id: Optional[int] = None,
        frame_mode: bool = False,
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
        vocal_threshold: Optional[float] = None,
        cut_threshold: Optional[float] = None,
        boundary_snap: Optional[int] = None,
        gap_cut: Optional[int] = None,
        merge_gap_ms: Optional[float] = None,
        frame_split: Optional[float] = None,
        frame_refine_ms: Optional[float] = None,
        frame_filter: Optional[float] = None,
    ) -> Dict[str, list]:
        """Segment a WAV file of any length at bounded memory.

        The file is read in ``chunk_seconds`` chunks (audio/stream.py, exact
        chunked resampling), and only per-trial carry buffers of at most one
        window each are kept, so peak memory is O(chunk + batch windows). The
        table equals ``segment(load_audio(path))``'s for greedy and beam
        decoding; sampling draws from ``seed`` plus the index of each flushed
        batch. ``sr=None`` means the checkpoint's ``sr``, else the file's own.
        ``frame_mode=True`` runs :meth:`segment_from_frames`'s path. Of the
        post-processing, ``merge_gap_ms`` and the frame-head chain run; the
        energy knobs (``split_merged_db`` / ``refine_boundaries_ms``) need
        the whole audio and are skipped, with a warning when the checkpoint
        enables them."""
        from .audio.stream import AudioStream

        dsc = self.default_segmentation_config
        if min_frequency is None:
            min_frequency = dsc.get("min_frequency", 0)
        if spec_time_step is None:
            spec_time_step = dsc.get("spec_time_step", 0.0025)
        if min_segment_length is None:
            min_segment_length = spec_time_step * RATIO
        if sr is None:
            sr = dsc.get("sr")

        stream = AudioStream(path, sr=sr, chunk_seconds=chunk_seconds,
                             channel_id=channel_id)
        try:
            sr = stream.sr
            time_delta = fft_time_delta(sr)
            if frame_mode:
                knobs = self._frame_mode_defaults(
                    vocal_threshold, cut_threshold, boundary_snap, gap_cut)
                tracks, total_samples = self._stream_frame_tracks(
                    stream, spec_time_step, min_frequency, batch_size,
                    status_monitor)
                return segments_from_tracks(
                    tracks, total_samples / sr, time_delta,
                    self.inverse_cluster_codebook,
                    min_segment_length=min_segment_length,
                    precision_bits=self.precision_bits, **knobs)

            if merge_gap_ms is None:
                merge_gap_ms = dsc.get("merge_gap_ms", 0)
            if frame_split is None:
                frame_split = dsc.get("frame_split", 0)
            if frame_refine_ms is None:
                frame_refine_ms = dsc.get("frame_refine_ms", 0)
            if frame_filter is None:
                frame_filter = dsc.get("frame_filter", 0)
            if eps is None:
                eps = spec_time_step * RATIO * 4
            if time_per_frame_for_voting is None:
                time_per_frame_for_voting = spec_time_step
            if max_length is None:
                max_length = int(dsc.get("max_length", 448))
            if dsc.get("split_merged_db") or dsc.get("refine_boundaries_ms"):
                print("Warning: the checkpoint's fitted split_merged_db/"
                      "refine_boundaries_ms post-processing needs random access "
                      "to the raw audio and is skipped in streaming mode; use "
                      "segment() if it matters more than memory.",
                      file=sys.stderr)

            clip_duration = self.total_spec_columns * spec_time_step
            clip_samples = int(clip_duration * sr)
            frontend = Frontend(sr, spec_time_step, min_frequency)

            # per-trial carry buffers, seeded with the trial's shifted zero
            # left-pad: the streaming counterpart of slice_audio_windows, with
            # the same windows and meta
            pad_time, carries, win_count = [], [], []
            for trial_id in range(num_trials):
                p = (np.round(clip_duration * trial_id / num_trials
                              / spec_time_step) * spec_time_step)
                pad_time.append(p)
                carries.append(np.zeros(int(p * sr), np.float32))
                win_count.append(0)

            token_lists: List[List[int]] = []
            meta: List[Tuple[int, float, float]] = []
            pend_clips: List[np.ndarray] = []
            pend_meta: List[Tuple[int, float, float]] = []
            total_samples = 0
            flush_idx = 0
            # the fitted frame post-processing takes its tracks from the
            # decode pass's own encoder run over the trial-0 windows; a
            # speculative decode reads them in a second pass over the file,
            # as the JAX package does
            need_frames = bool((frame_split or frame_refine_ms or frame_filter)
                               and "frame_head" in self.params)
            fuse_frames = need_frames and not self._use_spec(
                num_beams, top_k, top_p, constrained, int8_kv)
            probs0_parts: List[np.ndarray] = []
            cl0_parts: List[np.ndarray] = []

            def flush(force=False):
                nonlocal flush_idx
                while len(pend_clips) >= batch_size or (force and pend_clips):
                    take = pend_clips[:batch_size]
                    del pend_clips[:batch_size]
                    gen = self._generate_tokens(
                        np.stack(take), frontend, batch_size, max_length,
                        num_beams, length_penalty, collect_frames=fuse_frames,
                        int8_kv=int8_kv, top_k=top_k, top_p=top_p,
                        seed=seed + flush_idx, constrained=constrained)
                    take_meta = pend_meta[:len(take)]
                    if fuse_frames:
                        tokens, probs, cl = gen
                        # trial-0 rows arrive in time order across flushes
                        rows = [i for i, m in enumerate(take_meta)
                                if m[0] == 0]
                        if rows:
                            probs0_parts.append(probs[rows])
                            cl0_parts.append(cl[rows])
                    else:
                        tokens = gen
                    token_lists.extend(tokens)
                    meta.extend(take_meta)
                    del pend_meta[:len(take)]
                    flush_idx += 1

            for chunk in stream:
                total_samples += len(chunk)
                for t in range(num_trials):
                    buf = (np.concatenate([carries[t], chunk])
                           if len(carries[t]) else chunk)
                    nwin = len(buf) // clip_samples
                    for k in range(nwin):
                        pend_clips.append(
                            buf[k * clip_samples:(k + 1) * clip_samples])
                        pend_meta.append(
                            (t, win_count[t] * clip_samples / sr - pad_time[t],
                             clip_samples / sr))
                        win_count[t] += 1
                    carries[t] = buf[nwin * clip_samples:].copy()
                flush()
                if status_monitor is not None and stream.duration:
                    status_monitor["progress"] = int(np.round(min(
                        total_samples / sr / stream.duration, 1.0) * 100))

            # each trial's trailing partial window; a trial with no window at
            # all (empty audio) still gets one
            for t in range(num_trials):
                if len(carries[t]) or win_count[t] == 0:
                    tail = np.zeros(clip_samples, np.float32)
                    tail[:len(carries[t])] = carries[t]
                    pend_clips.append(tail)
                    pend_meta.append(
                        (t, win_count[t] * clip_samples / sr - pad_time[t],
                         len(carries[t]) / sr))
            flush(force=True)

            audio_duration = total_samples / sr
            final = self._parse_generation(
                token_lists, meta, min_segment_length, audio_duration,
                spec_time_step, num_trials, eps, time_per_frame_for_voting,
                consolidation_method)
            final = _blur_correct_and_dedup(final, time_delta)
            if merge_gap_ms:
                final = merge_small_gaps(final, gap_s=merge_gap_ms / 1000.0)
            if need_frames:
                if fuse_frames:
                    tracks = _tracks_from_window_frames(
                        np.concatenate(probs0_parts),
                        np.concatenate(cl0_parts), audio_duration,
                        spec_time_step)
                else:
                    tracks, _ = self._stream_frame_tracks(
                        stream, spec_time_step, min_frequency, batch_size)
                final = apply_frame_postprocess(
                    final, tracks, time_delta, frame_split=frame_split,
                    frame_refine_ms=frame_refine_ms, frame_filter=frame_filter,
                    min_len_s=min_segment_length)
            return _round_and_rededup(final, self.precision_bits)
        finally:
            stream.close()

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

        tls = self._consolidation_tls
        tls.stats = None
        if num_trials == 1:
            final = trials_results[0]
        elif consolidation_method == "clustering":
            min_samples = max(2, int(np.ceil(num_trials * 0.5)))
            stats = {}
            final = consolidate_by_clustering(trials_results, eps, min_samples,
                                              stats=stats)
            stats["noise_fraction"] = (stats["n_noise"] / stats["n_input"]
                                       if stats["n_input"] else 0.0)
            stats["low_agreement"] = (stats["n_input"] >= 2 * num_trials
                                      and stats["noise_fraction"] > 0.5)
            tls.stats = stats
            if stats["low_agreement"]:
                warnings.warn(
                    f"multi-trial consolidation discarded "
                    f"{stats['n_noise']}/{stats['n_input']} segments "
                    f"({stats['noise_fraction']:.0%}) as cross-trial "
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

    @property
    def last_consolidation_stats(self) -> Optional[dict]:
        """Cross-trial agreement stats of this thread's last ``segment()``
        with ``num_trials > 1`` and clustering consolidation (None
        otherwise): ``n_input`` / ``n_noise`` / ``n_clusters`` /
        ``noise_fraction`` / ``low_agreement``. Thread-local, so concurrent
        service requests each read their own."""
        return getattr(self._consolidation_tls, "stats", None)

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
        default_segmentation_config > literal. ``top_k`` / ``top_p`` sample
        (greedy path, ``num_beams=1``) from a generator seeded with ``seed``;
        ``constrained`` masks the transcript grammar."""
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
        # the frame post-processing takes its tracks from the decode's own
        # encoder pass over the trial-0 windows; a speculative decode reads
        # them in a second pass (frame_probs), as the JAX package does
        need_frames = bool((frame_split or frame_refine_ms or frame_filter)
                           and "frame_head" in self.params)
        fuse_frames = need_frames and not self._use_spec(
            num_beams, top_k, top_p, constrained, int8_kv)
        frontend = Frontend(sr, spec_time_step, min_frequency)
        gen = self._generate_tokens(clips, frontend, batch_size, max_length,
                                    num_beams, length_penalty, status_monitor,
                                    collect_frames=fuse_frames,
                                    int8_kv=int8_kv, top_k=top_k, top_p=top_p,
                                    seed=seed, constrained=constrained)
        if fuse_frames:
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
            if not fuse_frames:
                tracks = self.frame_probs(
                    audio, sr, spec_time_step=spec_time_step,
                    min_frequency=min_frequency, batch_size=batch_size)
            final = apply_frame_postprocess(
                final, tracks, time_delta, frame_split=frame_split,
                frame_refine_ms=frame_refine_ms, frame_filter=frame_filter,
                min_len_s=min_segment_length)
        return _round_and_rededup(final, self.precision_bits)
