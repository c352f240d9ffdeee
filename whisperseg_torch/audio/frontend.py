"""Log-mel spectrogram frontend (the port of ``whisperseg_tpu/audio/frontend.py``).

The numerics of the reference feature extraction: periodic hann window,
centred STFT (reflect pad by n_fft/2) with ``frame_length = n_fft``, slaney
mel filterbank, ``log10(max(mel, 1e-10))``, the last STFT frame dropped, a
per-clip ``max - 8`` floor and ``(x + 4) / 4`` scaling.

  * :meth:`Frontend.log_mel_numpy` - the float64 numpy oracle.
  * :meth:`Frontend.log_mel_batch` - the batched float32 path: framing as a
    strided view, ``torch.fft.rfft``, then the fused power -> mel -> log10
    kernel (ops/logmel.py) reading the FFT output in place and summing each
    mel column over its band of bins.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import NUM_MEL_BINS, n_fft_for_sr
from ..ops.logmel import mel_bands, melproject_reim
from ..runtime import resolve_device
from .mel import mel_filter_bank


def periodic_hann(n: int) -> np.ndarray:
    """Periodic hann window of length n."""
    return np.hanning(n + 1)[:-1]


@dataclass(frozen=True)
class Frontend:
    """Feature-extraction geometry for one (sr, spec_time_step, band):
    ``hop = int(spec_time_step * sr)``, ``n_fft = n_fft_for_sr(sr)``, band
    defaults [0, sr // 2]."""

    sr: int
    spec_time_step: float
    min_frequency: float = 0.0
    max_frequency: Optional[float] = None
    hop_length: int = field(init=False)
    n_fft: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "hop_length", int(self.spec_time_step * self.sr))
        object.__setattr__(self, "n_fft", n_fft_for_sr(self.sr))
        if self.max_frequency is None:
            object.__setattr__(self, "max_frequency", self.sr // 2)

    @functools.cached_property
    def mel_filters(self) -> np.ndarray:
        """(1 + n_fft//2, 80) float64 slaney filterbank."""
        return mel_filter_bank(
            num_frequency_bins=1 + self.n_fft // 2,
            num_mel_filters=NUM_MEL_BINS,
            min_frequency=float(self.min_frequency),
            max_frequency=float(self.max_frequency),
            sampling_rate=self.sr,
        )

    @functools.cached_property
    def window(self) -> np.ndarray:
        return periodic_hann(self.n_fft)

    def num_columns(self, num_samples: int) -> int:
        """Spectrogram columns of a ``num_samples`` waveform."""
        return num_samples // self.hop_length

    # ------------------------------------------------------------ numpy oracle

    def log_mel_numpy(self, waveform: np.ndarray) -> np.ndarray:
        """Exact float64 replication of the HF numpy pipeline -> (80, N // hop)."""
        n_fft, hop = self.n_fft, self.hop_length
        pad = n_fft // 2
        x = np.pad(waveform.astype(np.float64), (pad, pad), mode="reflect")
        num_frames = 1 + (len(x) - n_fft) // hop
        idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        frames = x[idx] * self.window.astype(np.float64)[None, :]
        # HF stores the FFT result as complex64 before taking |.|^2.
        spec = np.fft.rfft(frames, axis=-1).astype(np.complex64)
        power = np.abs(spec, dtype=np.float64) ** 2
        melspec = np.maximum(1e-10, power @ self.mel_filters)  # (frames, 80)
        log_spec = np.log10(melspec).T.astype(np.float32)  # (80, frames)
        log_spec = log_spec[:, :-1]  # drop last frame
        log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
        return ((log_spec + 4.0) / 4.0).astype(np.float32)

    # ----------------------------------------------------------- torch batched

    def _device_tensors(self, device: torch.device):
        """(window, mel matrix, its bands) on ``device``, made once."""
        cache = self.__dict__.setdefault("_tensors", {})
        if device not in cache:
            mel = torch.tensor(self.mel_filters, dtype=torch.float32, device=device)
            cache[device] = (
                torch.tensor(self.window, dtype=torch.float32, device=device),
                mel, mel_bands(mel))
        return cache[device]

    def spectrum(self, clips: torch.Tensor):
        """(B, N) float32 waveforms -> the real and imaginary planes of the
        windowed STFT as [B, n_fft // 2 + 1, N // hop] views of one
        ``torch.fft.rfft`` output (bins minor in memory), the float32 mel
        matrix and its bands on the clips' device: the inputs of the mel
        kernel."""
        window, mel, bands = self._device_tensors(clips.device)
        pad = self.n_fft // 2
        x = F.pad(clips[:, None, :], (pad, pad), mode="reflect")[:, 0]
        # frames as a strided view; the last one is dropped before the FFT
        frames = x.unfold(-1, self.n_fft, self.hop_length)[:, :-1] * window
        ri = torch.view_as_real(torch.fft.rfft(frames, dim=-1))  # [B, F, K, 2]
        return ri[..., 0].transpose(1, 2), ri[..., 1].transpose(1, 2), mel, bands

    def log_mel_batch(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, N) float32 waveforms -> (B, 80, N // hop) features, on the
        clips' device."""
        log_spec = melproject_reim(*self.spectrum(clips))
        max_val = log_spec.amax(dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, max_val - 8.0)
        return (log_spec + 4.0) / 4.0

    def features_for_clips(self, clips, total_spec_columns: int,
                           device=None) -> torch.Tensor:
        """(B, N) fixed-length clips -> (B, 80, total_spec_columns), truncating
        or right-padding with each clip's minimum. A tensor is processed on
        its own device; a numpy array goes to ``device`` (the card unless
        the CPU is asked for)."""
        if not isinstance(clips, torch.Tensor):
            clips = torch.as_tensor(clips, dtype=torch.float32,
                                    device=resolve_device(device))
        clips = clips.float()
        feats = self.log_mel_batch(clips)
        cols = feats.shape[-1]
        if cols >= total_spec_columns:
            return feats[:, :, :total_spec_columns]
        pad_value = feats.amin(dim=(1, 2), keepdim=True)
        return torch.cat(
            [feats, pad_value.expand(-1, feats.shape[1], total_spec_columns - cols)],
            dim=-1)
