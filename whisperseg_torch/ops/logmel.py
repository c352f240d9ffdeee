"""Fused power -> mel projection -> log10 (kernel ``csrc/melproject.cu``).

The port of ``whisperseg_tpu/ops/logmel_pallas.py::melproject_pallas``. The
DFT that feeds it stays outside the kernel, as in the JAX package
(audio/frontend.py uses ``torch.fft.rfft``). On a CUDA tensor the wrappers
launch the kernel or raise; the plain PyTorch version runs only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("melproject").ws_melproject
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def melproject_reim(re: torch.Tensor, im: torch.Tensor,
                    mel: torch.Tensor) -> torch.Tensor:
    """re/im: float32 [B, K, F] views that share strides (K >= n_freq; any
    layout, e.g. the two halves of the TPU kernel's [B, 2*f_pad, F] input, or
    the real and imaginary planes of ``torch.fft.rfft``'s [B, F, n_freq]
    output seen through ``view_as_real(...).transpose``); mel: float32
    [n_freq, n_mel], n_mel <= 128. Returns float32 [B, n_mel, F]."""
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
    offset = im.data_ptr() - re.data_ptr()
    if offset % 4:
        raise ValueError("melproject: im must sit a whole float away from re")
    out = torch.empty((b, n_mel, f), dtype=torch.float32, device=re.device)
    err = _kernel()(re.data_ptr(), re.stride(0), re.stride(1), re.stride(2),
                    offset // 4, mel.data_ptr(), out.data_ptr(), b, f, n_freq,
                    n_mel, torch.cuda.current_stream(re.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"melproject kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def melproject(reim: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's signature: reim [B, 2 * f_pad, F] (real rows, then
    imaginary rows) and mel [n_freq, n_mel] -> [B, n_mel, F]."""
    f_pad = reim.shape[1] // 2
    return melproject_reim(reim[:, :f_pad], reim[:, f_pad:], mel)
