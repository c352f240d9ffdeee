"""Log-mel features of WhisperSeg's windows in float64 NumPy.

Written from the published recipe of the HuggingFace ``WhisperFeatureExtractor``
as WhisperSeg calls it (reference ``audio_utils.py``): periodic Hann window,
centred STFT (reflect pad by n_fft/2, frame length n_fft), slaney mel
filterbank with slaney area normalisation, ``log10(max(mel, 1e-10))``, the last
frame dropped, a per-window floor at ``max - 8``, ``(x + 4) / 4``, then cut or
padded with the window's minimum to the model's column count. The n_fft table
is WhisperSeg's (reference ``audio_utils.py:32-43``)."""

from __future__ import annotations

import functools

import numpy as np

NUM_MEL_BINS = 80


def n_fft_for_sr(sr: int) -> int:
    if sr <= 32000:
        return 512
    if sr <= 80000:
        return 1024
    if sr <= 150000:
        return 2048
    if sr <= 300000:
        return 4096
    return 8192


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq * 3.0 / 200.0
    log_step = np.log(6.4) / 27.0
    return np.where(freq >= 1000.0,
                    15.0 + np.log(np.maximum(freq, 1000.0) / 1000.0) / log_step,
                    mels)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(mels >= 15.0,
                    1000.0 * np.exp(log_step * (np.maximum(mels, 15.0) - 15.0)),
                    mels * 200.0 / 3.0)


@functools.lru_cache(maxsize=None)
def mel_filters(sr: int, min_frequency: float) -> np.ndarray:
    """(1 + n_fft // 2, 80) slaney filterbank, triangles in Hz."""
    n_bins = 1 + n_fft_for_sr(sr) // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_points = np.linspace(_hz_to_mel(min_frequency), _hz_to_mel(sr // 2),
                             NUM_MEL_BINS + 2)
    edges = _mel_to_hz(mel_points)
    slopes = edges[:, None] - fft_freqs[None, :]
    widths = np.diff(edges)
    down = -slopes[:-2] / widths[:-1, None]
    up = slopes[2:] / widths[1:, None]
    weights = np.maximum(0.0, np.minimum(down, up))
    weights *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return weights.T.copy()


def window_features(clip: np.ndarray, sr: int, spec_time_step: float,
                    min_frequency: float, columns: int) -> np.ndarray:
    """One window's samples -> float32 features [80, columns]."""
    n_fft, hop = n_fft_for_sr(sr), int(spec_time_step * sr)
    pad = n_fft // 2
    x = np.pad(np.asarray(clip, np.float64), (pad, pad), mode="reflect")
    frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    hann = np.hanning(n_fft + 1)[:-1]
    power = np.abs(np.fft.rfft(x[idx] * hann, axis=-1)) ** 2
    mel = np.maximum(power @ mel_filters(sr, float(min_frequency)), 1e-10)
    log_spec = np.log10(mel).T[:, :-1]
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    feats = (log_spec + 4.0) / 4.0
    if feats.shape[1] >= columns:
        return feats[:, :columns].astype(np.float32)
    fill = np.full((NUM_MEL_BINS, columns - feats.shape[1]), feats.min())
    return np.concatenate([feats, fill], axis=1).astype(np.float32)


def pcm16_to_float(pcm: np.ndarray) -> np.ndarray:
    """16-bit PCM samples -> float32 in [-1, 1), as a WAV reader scales them."""
    return np.asarray(pcm, np.int16).astype(np.float32) / 32768.0


def sliding_windows(audio: np.ndarray, sr: int, spec_time_step: float,
                    columns: int, num_trials: int):
    """WhisperSeg's multi-trial windows (reference ``model.py``): trial t
    shifts the audio right by ``round(clip * t / num_trials / step) * step``
    seconds of zeros, then cuts whole clips of ``columns * step`` seconds,
    the last one zero-padded. Returns the windows [N, clip_samples] in
    trial-major order."""
    clip = columns * spec_time_step
    n = int(clip * sr)
    out = []
    for trial in range(num_trials):
        pad_s = np.round(clip * trial / num_trials / spec_time_step) \
            * spec_time_step
        padded = np.concatenate([np.zeros(int(pad_s * sr), np.float32),
                                 np.asarray(audio, np.float32)])
        for pos in range(0, max(len(padded), 1), n):
            piece = np.zeros(n, np.float32)
            part = padded[pos:pos + n]
            piece[:len(part)] = part
            out.append(piece)
    return np.stack(out)
