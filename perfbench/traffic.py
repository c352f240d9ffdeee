"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and makes that mix's audio from the seed.

``tone_bursts`` is a frozen copy of ``whisperseg_torch/synthetic.py``'s
function of that name (harmonic bursts on a quiet noise floor), so that the
program may change and the yardstick may not. Every recording is made from
a seed derived from the run's seed; the sizes of a mix are the same for
every seed and only their order and content change with it."""

from __future__ import annotations

import io
import json
import os
import wave
from typing import List

import numpy as np


def derived(seed: int, *stream: int) -> int:
    """A 31-bit seed for one stream of a run, from the run's seed (any
    non-negative integer, also beyond 32 bits)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *stream])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def tone_bursts(seed: int, sr: int = 32000, duration: float = 5.0,
                with_segments: bool = False):
    """Bursts of 60-200 ms, each a five-harmonic stack on a 0.5-1.2 kHz
    fundamental under a rounded envelope, 100-350 ms apart, on a noise floor.
    Copied from ``whisperseg_torch/synthetic.py::tone_bursts``."""
    rng = np.random.RandomState(seed)
    n = int(sr * duration)
    t = np.arange(n) / sr
    y = 0.003 * rng.randn(n)
    pos = 0.15
    onsets, offsets = [], []
    while pos < duration - 0.3:
        length = rng.uniform(0.06, 0.2)
        a, b = int(pos * sr), int((pos + length) * sr)
        tt = t[a:b] - pos
        env = np.clip(np.sin(np.pi * tt / length), 0.0, 1.0) ** 0.5
        f0 = rng.uniform(500, 1200)
        stack = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 6))
        y[a:b] += 0.4 * env * stack
        onsets.append(pos)
        offsets.append(pos + length)
        pos += length + rng.uniform(0.1, 0.35)
    y = y.astype(np.float32)
    return (y, onsets, offsets) if with_segments else y


def pcm16(y) -> np.ndarray:
    """Float audio in [-1, 1] as 16-bit PCM, as a WAV writer rounds it."""
    y = np.asarray(y, dtype=np.float32)
    return np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(np.asarray(pcm, "<i2").tobytes())
    return buf.getvalue()


def recording(seed: int, index: int, sr: int, seconds: float) -> np.ndarray:
    """Recording ``index`` of a run as 16-bit PCM: what a user's file holds.
    The program and the reference both read these samples."""
    return pcm16(tone_bursts(derived(seed, 1, index), sr=sr, duration=seconds))


def write_labelled_files(folder: str, mix: dict, seed: int) -> List[str]:
    """A fine-tuning folder of ``files`` tone-burst recordings of
    ``file_s`` seconds: 16-bit WAV files, each with a JSON label (one
    cluster, "Vocal") that states ``sr``, ``spec_time_step`` and
    ``min_frequency``. After ``whisperseg_torch/synthetic.py::
    write_tone_dataset``. Returns the stems."""
    os.makedirs(folder, exist_ok=True)
    stems = []
    for i in range(int(mix["files"])):
        y, on, off = tone_bursts(derived(seed, 3, i), sr=mix["sr"],
                                 duration=mix["file_s"], with_segments=True)
        stem = os.path.join(folder, f"tones_{i}")
        with open(stem + ".wav", "wb") as f:
            f.write(wav_bytes(pcm16(y), mix["sr"]))
        with open(stem + ".json", "w") as f:
            json.dump({"onset": [round(t, 4) for t in on],
                       "offset": [round(t, 4) for t in off],
                       "cluster": ["Vocal"] * len(on), "sr": mix["sr"],
                       "spec_time_step": mix["spec_time_step"],
                       "min_frequency": mix["min_frequency"]}, f)
        stems.append(stem)
    return stems
