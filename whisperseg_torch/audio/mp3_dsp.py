"""MPEG-1/2 Layer III decoder DSP primitives (pure numpy).

The port's copy of ``whisperseg_tpu/audio/mp3_dsp.py``;
it imports neither jax nor that package.

The hybrid filterbank halves of the decoder: 18/6-point IMDCT with the four
window types, frequency inversion, and the 32-band polyphase synthesis
filterbank. Kept free of bitstream concerns so the oracle-extraction script
(scripts/mp3_oracle_extract.py) can drive them directly when solving for the
synthesis window coefficients against libmpg123.

Conventions (internally consistent; the extracted window table is solved
UNDER these conventions, so they need no external agreement):

* IMDCT (long): s[n] = sum_k X[k] cos(pi/(2*36) * (2n + 1 + 36/2) * (2k+1)),
  n in [0, 36), windowed by one of the 4 block-type windows, overlap-added
  18/18.
* Synthesis: per granule time-step, V[0:64] = N @ S with
  N[i,k] = cos((16+i)(2k+1) pi / 64) pushed into a 1024-sample FIFO; the
  512-tap window D is applied over 16 half-overlapped reads (the classic
  dist10 u-vector assembly) and 32 PCM samples emerge.

The 512 window coefficients are ISO 11172-3 Table B.3 data — in this repo
they are RECOVERED from the system libmpg123 by linear system identification
(scripts/mp3_oracle_extract.py) and stored in
whisperseg_tpu/audio/mp3_tables.py; the recovery residual doubles as the
correctness proof.
"""

from __future__ import annotations

import numpy as np

# ------------------------------------------------------------- antialias

# ISO 11172-3 Table B.9 butterfly coefficients. Confirmed against libmpg123
# behaviorally: with these in the model, the synthesis-window system
# identification residual drops from 1.5e-1 to 3.6e-7
# (scripts/mp3_oracle_extract.py stage 1).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                -0.0037])
CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
CA = _CI * CS


def antialias(xr: np.ndarray, n_borders: int = 31) -> np.ndarray:
    """Butterfly the 8 lines either side of each subband border (in place).

    n_borders: 31 for long blocks, 1 for mixed, 0 for short (caller decides,
    ISO 11172-3 2.4.3.4.8)."""
    for sb in range(n_borders):
        lo = xr[sb * 18 + 10: sb * 18 + 18][::-1].copy()  # lines 17-i
        hi = xr[(sb + 1) * 18: (sb + 1) * 18 + 8].copy()
        xr[sb * 18 + 10: sb * 18 + 18] = (lo * CS - hi * CA)[::-1]
        xr[(sb + 1) * 18: (sb + 1) * 18 + 8] = hi * CS + lo * CA
    return xr


# ---------------------------------------------------------------- IMDCT

_IMDCT36 = None
_IMDCT12 = None


def _imdct_matrices():
    global _IMDCT36, _IMDCT12
    if _IMDCT36 is None:
        n, k = np.meshgrid(np.arange(36), np.arange(18), indexing="ij")
        _IMDCT36 = np.cos(np.pi / 72.0 * (2 * n + 1 + 18) * (2 * k + 1))
        n, k = np.meshgrid(np.arange(12), np.arange(6), indexing="ij")
        _IMDCT12 = np.cos(np.pi / 24.0 * (2 * n + 1 + 6) * (2 * k + 1))
    return _IMDCT36, _IMDCT12


def _windows():
    n = np.arange(36)
    w = {}
    w[0] = np.sin(np.pi / 36.0 * (n + 0.5))
    w1 = np.empty(36)
    w1[:18] = np.sin(np.pi / 36.0 * (n[:18] + 0.5))
    w1[18:24] = 1.0
    w1[24:30] = np.sin(np.pi / 12.0 * (n[24:30] - 18 + 0.5))
    w1[30:] = 0.0
    w[1] = w1
    w3 = np.empty(36)
    w3[:6] = 0.0
    w3[6:12] = np.sin(np.pi / 12.0 * (n[6:12] - 6 + 0.5))
    w3[12:18] = 1.0
    w3[18:] = np.sin(np.pi / 36.0 * (n[18:] + 0.5))
    w[3] = w3
    w[2] = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))  # short, 12-point
    return w


_WIN = None


def imdct_granule(xr_sb: np.ndarray, block_type: int) -> np.ndarray:
    """One subband's 18 spectral lines -> 36 windowed time samples.

    block_type 2 is the 3-short-window case: three 12-point IMDCTs windowed
    and overlapped at 6-sample offsets into out[6:30] (ISO 11172-3 2.4.3.4.6).
    """
    global _WIN
    if _WIN is None:
        _WIN = _windows()
    m36, m12 = _imdct_matrices()
    if block_type != 2:
        return (m36 @ xr_sb) * _WIN[block_type]
    out = np.zeros(36)
    w = _WIN[2]
    for i in range(3):
        s = (m12 @ xr_sb[i::3]) * w
        out[6 + 6 * i: 18 + 6 * i] += s
    return out


# ------------------------------------------------- polyphase synthesis


class Synth:
    """32-band polyphase synthesis filterbank (one channel).

    window: the 512-tap synthesis window (mp3_tables.SYNTH_WINDOW)."""

    def __init__(self, window: np.ndarray):
        i, k = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
        self._n = np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)
        self._v = np.zeros(1024)
        self._off = 0
        self._d = np.asarray(window, dtype=np.float64)
        assert self._d.shape == (512,)

    def step(self, s: np.ndarray) -> np.ndarray:
        """32 subband samples -> 32 PCM samples."""
        self._off = (self._off - 64) % 1024
        v = self._v
        v[self._off: self._off + 64] = self._n @ s
        u = np.empty(512)
        for i in range(8):
            base = (self._off + i * 128) % 1024
            u[i * 64: i * 64 + 32] = v[base: base + 32]
            base2 = (base + 96) % 1024
            u[i * 64 + 32: i * 64 + 64] = v[base2: base2 + 32]
        w = u * self._d
        return w.reshape(16, 32).sum(axis=0)

    def collect_u(self, s: np.ndarray) -> np.ndarray:
        """Like step() but returns the 512-long u vector (for the window
        solve: pcm[j] = sum_i u[j + 32 i] * D[j + 32 i])."""
        self._off = (self._off - 64) % 1024
        v = self._v
        v[self._off: self._off + 64] = self._n @ s
        u = np.empty(512)
        for i in range(8):
            base = (self._off + i * 128) % 1024
            u[i * 64: i * 64 + 32] = v[base: base + 32]
            base2 = (base + 96) % 1024
            u[i * 64 + 32: i * 64 + 64] = v[base2: base2 + 32]
        return u
