"""The port's log-mel frontend: the mel-projection kernel's plain version
against the Pallas kernel (interpret mode), the batched features against the
JAX package's, and both against the float64 numpy oracle for every n_fft.
Tolerances are those of tests/test_logmel_pallas.py. Also the band table the
kernel sums over (``ops/logmel.py::mel_bands``) and the plain model of its
banded sum."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend
from whisperseg_tpu.ops.logmel_pallas import melproject_pallas
from whisperseg_torch.audio.frontend import Frontend
from whisperseg_torch.ops import logmel


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_melproject_plain_matches_pallas_interpret(n_fft):
    sr = {512: 32000, 2048: 128000}[n_fft]
    fr = Frontend(sr, 0.0025)
    f_pad = ((n_fft // 2 + 1 + 127) // 128) * 128
    rng = np.random.RandomState(n_fft)
    reim = rng.randn(2, 2 * f_pad, 40).astype(np.float32)
    mel = fr.mel_filters.astype(np.float32)
    want = np.asarray(melproject_pallas(jnp.asarray(reim), jnp.asarray(mel),
                                        n_fft, interpret=True))
    got = logmel.melproject(torch.from_numpy(reim), torch.from_numpy(mel))
    assert got.shape == (2, 80, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("sr,step", [(32000, 0.0025), (16000, 0.01)])
def test_features_match_jax_features(sr, step):
    rng = np.random.RandomState(1)
    clips = (rng.randn(3, int(sr * 0.6)) * 0.2).astype(np.float32)
    clips[2, len(clips[2]) // 2:] = 0.0  # a half-silent clip
    total = Frontend(sr, step).num_columns(clips.shape[1]) + 7  # exercise min-pad
    want = np.asarray(JaxFrontend(sr, step).features_for_clips(clips, total))
    got = Frontend(sr, step).features_for_clips(clips, total, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    short = Frontend(sr, step).features_for_clips(torch.from_numpy(clips),
                                                  total - 20)
    np.testing.assert_allclose(short.numpy(), want[:, :, :total - 20], atol=2e-5)


@pytest.mark.parametrize("sr", [32000, 64000, 128000, 256000, 400000])
def test_features_match_numpy_oracle_every_n_fft(sr):
    fr = Frontend(sr, 0.0025)
    rng = np.random.RandomState(sr % 97)
    clips = (rng.randn(2, int(sr * 0.2)) * 0.2).astype(np.float32)
    got = fr.log_mel_batch(torch.from_numpy(clips)).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], fr.log_mel_numpy(clips[b]), atol=3e-4)


def test_rfft_layout_and_tpu_layout_agree():
    """The frontend hands the kernel the FFT output in place (bins minor);
    the TPU kernel's [B, 2 * f_pad, F] layout (frames minor) must give the
    same projection."""
    fr = Frontend(32000, 0.0025)
    rng = np.random.RandomState(2)
    spec = torch.fft.rfft(torch.from_numpy(rng.randn(2, 30, 512).astype(np.float32)))
    ri = torch.view_as_real(spec)
    mel = torch.tensor(fr.mel_filters, dtype=torch.float32)
    in_place = logmel.melproject_reim(ri[..., 0].transpose(1, 2),
                                      ri[..., 1].transpose(1, 2), mel)
    f_pad = 384
    reim = torch.zeros(2, 2 * f_pad, 30)
    reim[:, :257] = ri[..., 0].transpose(1, 2)
    reim[:, f_pad:f_pad + 257] = ri[..., 1].transpose(1, 2)
    np.testing.assert_allclose(logmel.melproject(reim, mel).numpy(),
                               in_place.numpy(), atol=1e-6)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "config", "segment_config.json")) as _f:
    PRESETS = json.load(_f)
# every preset's filterbank, and every n_fft from 512 to 8192 over the full band
BANKS = ([(name, p["sr"], p["spec_time_step"], p["min_frequency"])
          for name, p in sorted(PRESETS.items())]
         + [(f"sr {sr}", sr, 0.0025, 0) for sr in (32000, 64000, 128000,
                                                   256000, 400000)])


@pytest.mark.parametrize("name,sr,step,fmin", BANKS, ids=[b[0] for b in BANKS])
def test_mel_bands_cover_every_nonzero(name, sr, step, fmin):
    """Each column's band runs from its first to its last nonzero row: every
    nonzero inside it, both ends nonzero; the slaney filterbank's bands
    cover a few percent of the matrix."""
    mel = torch.tensor(Frontend(sr, step, fmin).mel_filters, dtype=torch.float32)
    bands = logmel.mel_bands(mel).rows
    assert bands.dtype == torch.int32 and bands.shape == (80, 2)
    rows = torch.arange(mel.shape[0])[:, None]
    inside = (rows >= bands[:, 0]) & (rows < bands[:, 1])
    assert not (mel != 0)[~inside].any()
    for m, (lo, hi) in enumerate(bands.tolist()):
        assert 0 <= lo < hi <= mel.shape[0]
        assert mel[lo, m] != 0 and mel[hi - 1, m] != 0
    assert inside.float().mean() < 0.05
    if fmin:  # the mouse preset: no band reaches below min_frequency
        assert bands[:, 0].min() >= int(fmin / (sr / 2) * (mel.shape[0] - 1)) - 1


def test_mel_bands_of_dense_and_empty_columns():
    """A dense matrix gives full bands; a column of zeros an empty one; a
    zero inside a band does not cut it."""
    rng = np.random.RandomState(3)
    dense = torch.from_numpy(rng.rand(300, 80).astype(np.float32) + 0.5)
    table = logmel.mel_bands(dense)
    assert torch.equal(table.rows, torch.tensor([[0, 300]] * 80, dtype=torch.int32))
    assert torch.equal(table.weights, dense.t()) and table.weights.is_contiguous()
    sparse = torch.zeros(50, 4)
    sparse[10:20, 1] = 1.0
    sparse[15, 1] = 0.0
    sparse[49, 2] = 2.0
    sparse[0, 3] = 3.0
    assert logmel.mel_bands(sparse).rows.tolist() == [[0, 0], [10, 20], [49, 50], [0, 1]]


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_banded_model_matches_plain_and_pallas(n_fft):
    """The kernel's banded sum on the TPU kernel's layout and on the rfft
    planes: within 2e-5 of the dense plain version and of the interpreted
    Pallas kernel."""
    sr = {512: 32000, 2048: 128000}[n_fft]
    fr = Frontend(sr, 0.0025)
    f_pad = ((n_fft // 2 + 1 + 127) // 128) * 128
    rng = np.random.RandomState(n_fft + 1)
    reim = rng.randn(2, 2 * f_pad, 40).astype(np.float32)
    mel = fr.mel_filters.astype(np.float32)
    want = np.asarray(melproject_pallas(jnp.asarray(reim), jnp.asarray(mel),
                                        n_fft, interpret=True))
    t_reim, t_mel = torch.from_numpy(reim), torch.from_numpy(mel)
    bands = logmel.mel_bands(t_mel)
    got = logmel.melproject_banded_reference(t_reim[:, :f_pad], t_reim[:, f_pad:],
                                             t_mel, bands)
    plain = logmel.melproject_reference(t_reim[:, :f_pad], t_reim[:, f_pad:], t_mel)
    assert got.shape == (2, 80, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5)
    clips = torch.from_numpy((rng.randn(2, sr // 10) * 0.2).astype(np.float32))
    re, im, f_mel, f_bands = fr.spectrum(clips)
    assert all(torch.equal(x, y) for x, y in zip(f_bands, bands))
    np.testing.assert_allclose(
        logmel.melproject_banded_reference(re, im, f_mel, f_bands).numpy(),
        logmel.melproject_reim(re, im, f_mel).numpy(), atol=2e-5)


def test_melproject_rejects_what_the_kernel_cannot_take():
    mel = torch.zeros(257, 80)
    with pytest.raises(TypeError):
        logmel.melproject(torch.zeros(1, 768, 4, dtype=torch.float64), mel)
    with pytest.raises(ValueError):
        logmel.melproject(torch.zeros(1, 256, 4), mel)  # fewer bins than mel rows
    with pytest.raises(ValueError):
        logmel.melproject(torch.zeros(1, 768, 4), torch.zeros(257, 129))
