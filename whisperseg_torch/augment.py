"""Splice-synthesis data augmentation for segmentation training (a numpy
copy of ``whisperseg_tpu/augment.py``: under the same generator it gives the
same audio and labels, bit for bit).

It makes new training files by splicing real annotated syllables onto real
background beds cut from the same corpus, with gaps drawn from the corpus's
own gap distribution, so every synthetic boundary is exact:

* syllables are cut at the (FFT-blur-widened) label boundaries the data
  pipeline uses, with a ~2 ms raised-cosine fade against splice clicks;
* background beds join inter-segment spans of the real files with short
  crossfades;
* gaps are resampled from the real ones with a broadening jitter, plus an
  occasional long pause;
* amplitude jitter (uniform in dB) and a mild linear-interpolation time
  stretch (+-5 %) vary the syllables.

The trainer's ``synth_augment`` adds such files after the validation split,
so validation stays real data.
"""
from __future__ import annotations

from copy import deepcopy
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["synthesize_training_files"]


def _config_key(label: dict) -> tuple:
    return (label.get("sr"), label.get("spec_time_step"), label.get("min_frequency", 0))


def _fade(wave: np.ndarray, n: int) -> np.ndarray:
    """Raised-cosine fade-in/out over n samples (copy; input untouched)."""
    out = np.array(wave, dtype=np.float32, copy=True)
    n = min(n, len(out) // 2)
    if n > 0:
        ramp = 0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, n, dtype=np.float32))
        out[:n] *= ramp
        out[-n:] *= ramp[::-1]
    return out


def _harvest(audio_list, label_list, group_idx, min_noise_s=0.03, max_noise_s=1.0):
    """Collect syllable waveforms, noise spans, and gap samples for one config group."""
    syllables: List[Tuple[np.ndarray, str, int]] = []
    noise: List[np.ndarray] = []
    gaps: List[float] = []
    for i in group_idx:
        audio = np.asarray(audio_list[i], dtype=np.float32)
        label = label_list[i]
        sr = label["sr"]
        onset = np.asarray(label["onset"], dtype=np.float64)
        offset = np.asarray(label["offset"], dtype=np.float64)
        order = np.argsort(onset)
        onset, offset = onset[order], offset[order]
        clusters = [label["cluster"][j] for j in order]
        cluster_ids = np.asarray(label["cluster_id"])[order]
        for on, off, cl, cid in zip(onset, offset, clusters, cluster_ids):
            s, e = int(round(on * sr)), int(round(off * sr))
            if 0 <= s < e <= len(audio) and e - s >= 16:
                syllables.append((audio[s:e], cl, int(cid)))
        # inter-segment background spans (plus leading/trailing margins)
        bounds = [0.0] + [t for pair in zip(onset, offset) for t in pair] + [len(audio) / sr]
        quiet = list(zip(bounds[0::2], bounds[1::2]))  # [ (0,on0), (off0,on1), ... ]
        for q0, q1 in quiet:
            if q1 - q0 >= min_noise_s:
                s = int(round(q0 * sr))
                e = min(int(round(q1 * sr)), s + int(max_noise_s * sr))
                if e - s >= int(min_noise_s * sr):
                    noise.append(audio[s:e])
        gaps.extend(np.clip(onset[1:] - offset[:-1], 0.0, 2.0).tolist())
    return syllables, noise, [g for g in gaps if g > 0]


def _noise_bed(noise: List[np.ndarray], n_samples: int, sr: int,
               rng: np.random.Generator) -> np.ndarray:
    """Concatenate random noise snippets with short crossfades into a bed."""
    if not noise:
        return np.zeros(n_samples, dtype=np.float32)
    xf = max(1, int(0.005 * sr))
    bed = np.zeros(n_samples + xf, dtype=np.float32)
    pos = 0
    while pos < n_samples:
        snip = noise[int(rng.integers(len(noise)))]
        snip = _fade(snip * float(rng.uniform(0.8, 1.2)), xf)
        end = min(pos + len(snip), len(bed))
        bed[pos:end] += snip[: end - pos]
        pos = end - xf  # overlap-add crossfade
        if len(snip) <= xf:
            pos += xf  # degenerate snippet; avoid stalling
    return bed[:n_samples]


def _stretch(wave: np.ndarray, factor: float) -> np.ndarray:
    """Linear-interpolation time stretch (mild factors only; shifts pitch)."""
    n_out = max(16, int(round(len(wave) * factor)))
    x_out = np.linspace(0.0, len(wave) - 1.0, n_out)
    return np.interp(x_out, np.arange(len(wave)), wave).astype(np.float32)


def synthesize_training_files(
    audio_list: Sequence[np.ndarray],
    label_list: Sequence[dict],
    num_files: int,
    total_spec_columns: int = 1000,
    seconds_per_file: Optional[float] = None,
    time_stretch: float = 0.05,
    amp_db: float = 6.0,
    rng: Optional[np.random.Generator] = None,
):
    """Synthesize ``num_files`` new (audio, label) training pairs.

    Inputs are the post-``load_data`` lists (labels carry ``sr``,
    ``spec_time_step``, ``cluster_id`` etc. and FFT-blur-widened boundaries).
    Files are grouped by (sr, spec_time_step, min_frequency); synthesis
    happens within a group so every synthetic file is config-consistent, and
    groups get synthetic files proportional to their real file count.

    Returns ``(synth_audio_list, synth_label_list)``; labels are deep copies
    of a group template with fresh onset/offset/cluster arrays, so they flow
    through slicing/VocalSegDataset exactly like real files.
    """
    if rng is None:
        rng = np.random.default_rng(int(np.random.randint(0, 2**31 - 1)))
    groups: dict = {}
    for i, label in enumerate(label_list):
        groups.setdefault(_config_key(label), []).append(i)

    out_audio, out_label = [], []
    group_items = sorted(groups.items(), key=lambda kv: -len(kv[1]))
    for gi, (key, idxs) in enumerate(group_items):
        share = int(round(num_files * len(idxs) / len(label_list)))
        if gi == 0:
            share = max(share, num_files - sum(
                int(round(num_files * len(v) / len(label_list)))
                for k, v in group_items[1:]))
        if share <= 0:
            continue
        syllables, noise, gaps = _harvest(audio_list, label_list, idxs)
        if not syllables:
            continue
        template = label_list[idxs[0]]
        sr = template["sr"]
        step = template.get("spec_time_step", 0.0025)
        clip_dur = total_spec_columns * step
        dur = seconds_per_file or max(5.0, 2.0 * clip_dur)
        n_samples = int(dur * sr)
        fade_n = max(1, int(0.002 * sr))

        for _ in range(share):
            bed = _noise_bed(noise, n_samples, sr, rng)
            onsets, offsets, clusters, cluster_ids = [], [], [], []
            cursor = int(_draw_gap(gaps, rng) * sr)
            while True:
                wave, cl, cid = syllables[int(rng.integers(len(syllables)))]
                if time_stretch > 0:
                    wave = _stretch(wave, float(rng.uniform(1 - time_stretch,
                                                            1 + time_stretch)))
                wave = _fade(wave * float(10.0 ** (rng.uniform(-amp_db, amp_db / 2)
                                                   / 20.0)), fade_n)
                if cursor + len(wave) >= n_samples - fade_n:
                    break
                bed[cursor:cursor + len(wave)] += wave
                onsets.append(cursor / sr)
                offsets.append((cursor + len(wave)) / sr)
                clusters.append(cl)
                cluster_ids.append(cid)
                gap = _draw_gap(gaps, rng) * float(rng.uniform(0.7, 1.4))
                if rng.uniform() < 0.1:
                    gap *= 5.0  # occasional long pause: teach silence spans
                cursor += len(wave) + max(1, int(gap * sr))
            if not onsets:
                continue
            label = deepcopy(template)
            label.update({
                "onset": np.asarray(onsets, dtype=np.float64),
                "offset": np.asarray(offsets, dtype=np.float64),
                "cluster": clusters,
                "cluster_id": np.asarray(cluster_ids, dtype=np.int64),
            })
            out_audio.append(bed)
            out_label.append(label)
    return out_audio, out_label


def _draw_gap(gaps: List[float], rng: np.random.Generator) -> float:
    if gaps:
        return float(gaps[int(rng.integers(len(gaps)))])
    return float(rng.exponential(0.05))
