"""Slaney-scale, slaney-normalized mel filterbank.

Reimplements (from the published formulas) the filterbank the reference builds via
``transformers.audio_utils.mel_filter_bank(norm="slaney", mel_scale="slaney")``
(reference audio_utils.py:68-76). Tested for exact agreement with the HF function.
"""

from __future__ import annotations

import numpy as np

_MIN_LOG_HZ = 1000.0
_LIN_SLOPE = 200.0 / 3.0  # hz per mel in the linear region
_MIN_LOG_MEL = _MIN_LOG_HZ / _LIN_SLOPE  # = 15.0
_LOG_STEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _LIN_SLOPE
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOG_STEP,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freq = _LIN_SLOPE * mels
    log_region = mels >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOG_STEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freq,
    )
    return freq


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """Triangular filterbank of shape (num_frequency_bins, num_mel_filters),
    slaney mel scale + slaney area normalization."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)

    mel_min = hz_to_mel_slaney(min_frequency)
    mel_max = hz_to_mel_slaney(max_frequency)
    mel_points = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hz_slaney(mel_points)

    # Triangles computed in Hz space (matches HF's triangularize_in_mel_space=False).
    fdiff = np.diff(filter_freqs)
    ramps = filter_freqs.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    down = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    up = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(down, up))  # (num_mel_filters, num_freq_bins)

    # Slaney-style area normalization.
    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    weights *= enorm.reshape(-1, 1)

    return weights.T.copy()
