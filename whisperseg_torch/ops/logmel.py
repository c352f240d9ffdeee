"""Fused power -> mel projection -> log10 (kernel ``csrc/melproject.cu``).

The port of ``whisperseg_tpu/ops/logmel_pallas.py::melproject_pallas``. The
DFT that feeds it stays outside the kernel, as in the JAX package
(audio/frontend.py uses ``torch.fft.rfft``). The kernel sums each mel
column over its band of bins only (:func:`mel_bands`), which gives the dense
sum bit for bit; :func:`melproject_banded_reference` is the plain model of
that sum. On a CUDA tensor the wrappers launch the kernel or raise; the
plain PyTorch version runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

# Kernel launches made by the wrappers below (read and reset by callers that
# check which path ran).
launches = 0


def melproject_reference(re: torch.Tensor, im: torch.Tensor,
                         mel: torch.Tensor) -> torch.Tensor:
    """Plain version: re/im [B, K >= n_freq, F], mel [n_freq, n_mel] ->
    log10(max(mel^T (re^2 + im^2), 1e-10)) as [B, n_mel, F], all float32
    (full-precision products: no TF32)."""
    n_freq = mel.shape[0]
    re = re[:, :n_freq].float()
    im = im[:, :n_freq].float()
    power = re * re + im * im
    melspec = torch.einsum("bkf,km->bmf", power, mel.float())
    return torch.log10(torch.clamp_min(melspec, 1e-10))


class MelBands(NamedTuple):
    """What the kernel reads of a mel matrix [n_freq, n_mel]: ``rows``, int32
    [n_mel, 2], each column's first and one-past-last nonzero row ([0, 0)
    for a column of zeros), and ``weights``, the matrix transposed
    [n_mel, n_freq] and contiguous, so that a band's weights are adjacent."""
    rows: torch.Tensor
    weights: torch.Tensor


def mel_bands(mel: torch.Tensor) -> MelBands:
    """The band table of a mel matrix, made on its device without a host
    sync."""
    n_freq = mel.shape[0]
    nonzero = mel != 0
    idx = torch.arange(n_freq, dtype=torch.int32, device=mel.device)[:, None]
    hi = torch.where(nonzero, idx + 1, 0).amax(dim=0)
    lo = torch.minimum(torch.where(nonzero, idx, n_freq).amin(dim=0), hi)
    return MelBands(torch.stack([lo, hi], dim=1).to(torch.int32).contiguous(),
                    mel.float().t().contiguous())


def melproject_banded_reference(re: torch.Tensor, im: torch.Tensor,
                                mel: torch.Tensor,
                                bands: MelBands) -> torch.Tensor:
    """Plain model of the kernel's banded sum: column m of the projection
    sums only the bins of ``bands.rows[m]``, with the weights of
    ``bands.weights``. Equals :func:`melproject_reference` whenever the
    bands cover every nonzero of the matrix."""
    n_freq = mel.shape[0]
    re = re[:, :n_freq].float()
    im = im[:, :n_freq].float()
    power = re * re + im * im
    cols = [torch.einsum("bkf,k->bf", power[:, lo:hi], bands.weights[m, lo:hi])
            for m, (lo, hi) in enumerate(bands.rows.tolist())]
    return torch.log10(torch.clamp_min(torch.stack(cols, dim=1), 1e-10))


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# base, sb, sk, sf, im_off, weights, rows, out, batch, n_frames, n_freq,
# n_mel, stream
ARGTYPES = [_PTR, _I64, _I64, _I64, _I64, _PTR, _PTR, _PTR, _I32, _I32, _I32,
            _I32, _PTR]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("melproject").ws_melproject
    fn.argtypes = ARGTYPES
    fn.restype = _I32
    return fn


def melproject_reim(re: torch.Tensor, im: torch.Tensor, mel: torch.Tensor,
                    bands: Optional[MelBands] = None) -> torch.Tensor:
    """re/im: float32 [B, K, F] views that share strides (K >= n_freq; any
    layout, e.g. the two halves of the TPU kernel's [B, 2*f_pad, F] input, or
    the real and imaginary planes of ``torch.fft.rfft``'s [B, F, n_freq]
    output seen through ``view_as_real(...).transpose``); mel: float32
    [n_freq, n_mel], n_mel <= 128; bands: ``mel``'s band table, whose rows
    cover every nonzero of each column (:func:`mel_bands` of ``mel`` when
    None; pass it to skip that pass). Returns float32 [B, n_mel, F]."""
    global launches
    if re.dtype != torch.float32 or im.dtype != torch.float32 \
            or mel.dtype != torch.float32:
        raise TypeError("melproject takes float32 spectra and mel matrix")
    if re.dim() != 3 or re.shape != im.shape or re.stride() != im.stride():
        raise ValueError("re and im must be [B, K, F] views with equal strides")
    if mel.dim() != 2 or mel.shape[0] > re.shape[1] or mel.shape[1] > 128:
        raise ValueError(f"mel {tuple(mel.shape)} does not fit spectra "
                         f"{tuple(re.shape)} (n_freq <= K, n_mel <= 128)")
    if not (re.device == im.device == mel.device):
        raise ValueError("re, im and mel must be on one device")
    if re.device.type == "cpu":
        return melproject_reference(re, im, mel)
    if re.device.type != "cuda":
        raise ValueError(f"melproject: unsupported device {re.device}")
    if not mel.is_contiguous():
        raise ValueError("melproject: mel must be contiguous")
    b, _, f = re.shape
    n_freq, n_mel = mel.shape
    if bands is None:
        bands = mel_bands(mel)
    rows, weights = bands
    if rows.dtype != torch.int32 or tuple(rows.shape) != (n_mel, 2) \
            or weights.dtype != torch.float32 \
            or tuple(weights.shape) != (n_mel, n_freq) \
            or any(t.device != mel.device or not t.is_contiguous()
                   for t in (rows, weights)):
        raise ValueError(f"melproject: bands must hold contiguous int32 rows "
                         f"[{n_mel}, 2] and float32 weights [{n_mel}, "
                         f"{n_freq}] on the matrix's device")
    offset = im.data_ptr() - re.data_ptr()
    if offset % 4:
        raise ValueError("melproject: im must sit a whole float away from re")
    out = torch.empty((b, n_mel, f), dtype=torch.float32, device=re.device)
    err = _kernel()(re.data_ptr(), re.stride(0), re.stride(1), re.stride(2),
                    offset // 4, weights.data_ptr(), rows.data_ptr(),
                    out.data_ptr(), b, f, n_freq,
                    n_mel, torch.cuda.current_stream(re.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"melproject kernel launch failed: CUDA error {err}")
    with _build.count_lock:
        launches += 1
    return out


def melproject(reim: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's signature: reim [B, 2 * f_pad, F] (real rows, then
    imaginary rows) and mel [n_freq, n_mel] -> [B, n_mel, F]."""
    f_pad = reim.shape[1] // 2
    return melproject_reim(reim[:, :f_pad], reim[:, f_pad:], mel)
