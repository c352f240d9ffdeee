"""Global constants of WhisperSeg (a copy of ``whisperseg_tpu/constants.py``).

Behavioral spec mirrored from the reference implementation:
  - reference utils.py:5   (RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP = 2)
  - reference audio_utils.py:32-43 (sr -> n_fft lookup table)
"""

# One decoded timestamp token <|i|> corresponds to i * spec_time_step * RATIO seconds.
# Whisper's convolutional frontend downsamples time by 2, so decoder positions tick
# at 2 spectrogram columns (reference utils.py:5).
RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP = 2

# Default number of spectrogram columns fed to the encoder (reference train.py:72).
DEFAULT_TOTAL_SPEC_COLUMNS = 1000

# Number of mel filterbank channels (reference audio_utils.py:60).
NUM_MEL_BINS = 80


def n_fft_for_sr(sr: int) -> int:
    """FFT size as a function of the sampling rate (reference audio_utils.py:32-43)."""
    if sr <= 32000:
        return 512
    if sr <= 80000:
        return 1024
    if sr <= 150000:
        return 2048
    if sr <= 300000:
        return 4096
    return 8192


def fft_time_delta(sr: int) -> float:
    """Half of the FFT window length in seconds — the 'FFT blurring' correction
    applied symmetrically on input labels and output predictions
    (reference datautils.py:65, model.py:440-441)."""
    return n_fft_for_sr(sr) / 2.0 / sr
