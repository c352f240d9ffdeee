"""Put the JAX package on its TPU kernel paths while it runs on the CPU, for
the tests that hold the PyTorch port against it.

On the CPU the JAX package routes around its Pallas kernels and, in the
quantized products, around the bf16 roundings its TPU path makes. The port
has one set of numerics, the TPU's. ``jax_kernel_path()`` makes the JAX
package take that path without editing it: every ``pl.pallas_call`` runs in
interpret mode, ``ops/quant.py`` and ``models/whisper.py`` see a ``jax``
whose ``default_backend()`` says ``"tpu"``, and the encoder takes its
head-major attention kernel. The path is chosen when a program is traced, so
JAX's caches are cleared on the way in and out.
"""

import contextlib
import os

import jax
import pytest
from jax.experimental import pallas as pl

from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.ops import attention as jatt
from whisperseg_tpu.ops import quant as jq


class _TpuJax:
    """``jax`` with ``default_backend() == "tpu"``; all else passes through."""

    def __init__(self, real):
        self._real = real

    def default_backend(self):
        return "tpu"

    def __getattr__(self, name):
        return getattr(self._real, name)


@contextlib.contextmanager
def jax_kernel_path():
    """Yields the list of Pallas kernels traced inside the block, each as
    the name of the file that defines it (``quant.py``, ...)."""
    traced = []
    orig = pl.pallas_call

    def interpreted(kernel, *args, **kwargs):
        traced.append(os.path.basename(kernel.__code__.co_filename))
        kwargs["interpret"] = True
        return orig(kernel, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", interpreted)
    mp.setattr(jq, "jax", _TpuJax(jax))
    mp.setattr(jw, "jax", _TpuJax(jax))
    mp.setattr(jatt, "fused_available", lambda *a: True)
    mp.setattr(jatt, "FORCE_INTERPRET", True)
    jax.clear_caches()
    try:
        yield traced
    finally:
        mp.undo()
        jax.clear_caches()
