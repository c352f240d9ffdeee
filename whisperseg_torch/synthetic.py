"""Seeded synthetic requests: harmonic tone bursts on a quiet noise floor.

The repository ships no audio, so the parity tests and the chip smoke run make
their input here, from a seed, with numpy alone.
"""

from __future__ import annotations

import numpy as np


def tone_bursts(seed: int, sr: int = 32000, duration: float = 5.0) -> np.ndarray:
    """Bursts of 60-200 ms, each a five-harmonic stack on a 0.5-1.2 kHz
    fundamental under a rounded envelope, 100-350 ms apart. Returns float32
    audio of ``duration`` seconds."""
    rng = np.random.RandomState(seed)
    n = int(sr * duration)
    t = np.arange(n) / sr
    y = 0.003 * rng.randn(n)
    pos = 0.15
    while pos < duration - 0.3:
        length = rng.uniform(0.06, 0.2)
        a, b = int(pos * sr), int((pos + length) * sr)
        tt = t[a:b] - pos
        env = np.clip(np.sin(np.pi * tt / length), 0.0, 1.0) ** 0.5
        f0 = rng.uniform(500, 1200)
        stack = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 6))
        y[a:b] += 0.4 * env * stack
        pos += length + rng.uniform(0.1, 0.35)
    return y.astype(np.float32)
