"""The port's log-mel frontend: the mel-projection kernel's plain version
against the Pallas kernel (interpret mode), the batched features against the
JAX package's, and both against the float64 numpy oracle for every n_fft.
Tolerances are those of tests/test_logmel_pallas.py."""

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


def test_melproject_rejects_what_the_kernel_cannot_take():
    mel = torch.zeros(257, 80)
    with pytest.raises(TypeError):
        logmel.melproject(torch.zeros(1, 768, 4, dtype=torch.float64), mel)
    with pytest.raises(ValueError):
        logmel.melproject(torch.zeros(1, 256, 4), mel)  # fewer bins than mel rows
    with pytest.raises(ValueError):
        logmel.melproject(torch.zeros(1, 768, 4), torch.zeros(257, 129))
