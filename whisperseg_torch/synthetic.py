"""Seeded synthetic audio: harmonic tone bursts on a quiet noise floor, the
files a user uploads (16-bit WAV, FLAC, a crafted MP3 stream, a zipped
training set with CSV labels).

The repository ships no audio, so the parity tests and the chip smoke run make
their input here, from a seed, with numpy alone.
"""

from __future__ import annotations

import io
import json
import os
import wave
import zipfile

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


def pcm16(y) -> np.ndarray:
    """Float audio in [-1, 1] as 16-bit PCM, rounded as ``save_wav`` rounds."""
    y = np.asarray(y, dtype=np.float32)
    return np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")


def audio_bytes(y, sr: int = 32000, fmt: str = "wav") -> bytes:
    """Mono float audio as the bytes of a 16-bit ``"wav"`` or ``"flac"``
    file (``audio/flac.py::encode_flac``); both decode to the same samples."""
    pcm = pcm16(y)
    if fmt == "flac":
        from .audio.flac import encode_flac

        return encode_flac(pcm, sr)
    if fmt != "wav":
        raise ValueError(f"fmt must be 'wav' or 'flac', got {fmt!r}")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def crafted_mp3(seed: int, duration: float = 2.0, sr: int = 32000) -> bytes:
    """A mono MPEG-1 Layer III stream of about ``duration`` seconds written
    bit by bit (``audio/mp3_craft.py``, not an encoder; ``sr`` is 32000,
    44100 or 48000): runs of 2-6 granules whose spectra hold random +-1
    lines below about 4 kHz (Huffman table B's quadruples), between runs of
    silent granules."""
    from .audio.mp3_craft import Granule, craft_stream

    rng = np.random.RandomState(seed)
    n_granules = int(np.ceil(duration * sr / 576))
    granules, on = [], False
    while len(granules) < n_granules:
        run = rng.randint(2, 7)
        for _ in range(min(run, n_granules - len(granules))):
            if not on:
                granules.append(Granule())
                continue
            quads = rng.choice([-1, 0, 1], size=(40, 4), p=[0.1, 0.8, 0.1])
            bits = []
            for q in quads:
                # table B: the complement of the nonzero mask, then a sign
                # bit (1 = negative) for each nonzero value
                mask = sum(1 << (3 - i) for i, v in enumerate(q) if v)
                bits.append(format(~mask & 0xF, "04b"))
                bits += ["1" if v < 0 else "0" for v in q if v]
            granules.append(Granule(main_bits="".join(bits), global_gain=190))
        on = not on
    return craft_stream(granules, sr=sr)


def tone_dataset_zip(n_files: int, seed: int = 0, sr: int = 32000,
                     duration: float = 10.0, fmt: str = "flac") -> bytes:
    """A zip of ``n_files`` tone-burst recordings (``fmt``: "flac" or
    "wav") with CSV labels (onset, offset, cluster "Vocal"), as a user
    uploads a training set to the backend."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for i in range(n_files):
            y, onsets, offsets = tone_bursts(seed + i, sr=sr,
                                             duration=duration,
                                             with_segments=True)
            zf.writestr(f"tones_{i}.{fmt}", audio_bytes(y, sr, fmt))
            rows = "".join(f"{a:.4f},{b:.4f},Vocal\n"
                           for a, b in zip(onsets, offsets))
            zf.writestr(f"tones_{i}.csv", "onset,offset,cluster\n" + rows)
    return buf.getvalue()
