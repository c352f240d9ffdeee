"""Seeded synthetic audio: harmonic tone bursts on a quiet noise floor.

The repository ships no audio, so the parity tests and the chip smoke run make
their input here, from a seed, with numpy alone.
"""

from __future__ import annotations

import json
import os

import numpy as np


def tone_bursts(seed: int, sr: int = 32000, duration: float = 5.0,
                with_segments: bool = False):
    """Bursts of 60-200 ms, each a five-harmonic stack on a 0.5-1.2 kHz
    fundamental under a rounded envelope, 100-350 ms apart. Returns float32
    audio of ``duration`` seconds; with ``with_segments`` also the bursts'
    (onsets, offsets) in seconds."""
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


def write_tone_dataset(folder: str, n_files: int, seed: int = 0,
                       sr: int = 32000, duration: float = 10.0,
                       spec_time_step: float = 0.0025) -> str:
    """A training folder of ``n_files`` tone-burst recordings: 16-bit WAV
    files with JSON labels (one cluster, "Vocal") that state ``sr``,
    ``spec_time_step`` and ``min_frequency``."""
    from .audio.io import save_wav

    os.makedirs(folder, exist_ok=True)
    for i in range(n_files):
        y, onsets, offsets = tone_bursts(seed + i, sr=sr, duration=duration,
                                         with_segments=True)
        save_wav(os.path.join(folder, f"tones_{i}.wav"), y, sr)
        with open(os.path.join(folder, f"tones_{i}.json"), "w") as f:
            json.dump({"onset": [round(t, 4) for t in onsets],
                       "offset": [round(t, 4) for t in offsets],
                       "cluster": ["Vocal"] * len(onsets), "sr": sr,
                       "spec_time_step": spec_time_step, "min_frequency": 0}, f)
    return folder
