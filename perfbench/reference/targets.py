"""WhisperSeg's training targets, from a label file and a crop of its audio.

Written from the WhisperSeg training recipe (reference ``datautils.py``,
``utils.py``, ``model.py``): each labelled segment is widened by half an FFT
window on both sides; a file is cut into windows of two clips, one clip
apart, after a one-clip zero pad; a training example is a crop of one clip
from such a window, and its target is the prompt, the species token, then
(onset timestamp, cluster digits, offset timestamp) for every segment that
meets the crop, then end-of-text, shifted by one for teacher forcing. The
compact vocabulary's ids: digits 0-9, pad 10, end-of-text 11, the prompt
12 13 14, species 15-21, timestamps from 23 (one per two spectrogram
columns)."""

from __future__ import annotations

import numpy as np

from .frontend import n_fft_for_sr

PAD, EOT, PROMPT = 10, 11, (12, 13, 14)
SPECIES_UNKNOWN = 20
TIMESTAMP_BASE = 23


def _column(t: float, step: float, columns: int) -> int:
    return min(int(np.round(t / (step * 2))), columns)


def windows(audio: np.ndarray, onsets, offsets, sr: int, step: float,
            columns: int):
    """The file's training windows: [(samples, onsets, offsets)] with the
    segments widened by half an FFT window and cut to each window."""
    delta = n_fft_for_sr(sr) / 2.0 / sr
    dur = len(audio) / sr
    on = np.asarray([max(0, t - delta) for t in onsets])
    off = np.asarray([min(dur, t + delta) for t in offsets])
    keep = (on < dur) & (off > 0) & (on <= off)
    on, off = on[keep], off[keep]
    clip = columns * step
    n = int(np.round(clip * sr))
    padded = np.concatenate([np.zeros(n, dtype=audio.dtype), audio])
    p_on, p_off = on + clip, off + clip
    out = []
    for pos in range(0, len(padded), n):
        piece = padded[pos:pos + 2 * n]
        if len(piece) / sr < 0.1:
            continue
        start, end = pos / sr, (pos + len(piece)) / sr
        inter = (p_on < end) & (p_off > start)
        out.append((piece, np.maximum(p_on[inter], start) - start,
                    np.minimum(p_off[inter], end) - start))
    return out


def crop_target(piece_on, piece_off, crop_start: int, crop_len: int, sr: int,
                step: float, columns: int, max_length: int):
    """(decoder input ids, labels) of the crop ``[crop_start, +crop_len)`` of
    a window whose segments are ``piece_on`` / ``piece_off`` (one cluster,
    id 0)."""
    start = crop_start / sr
    end = start + crop_len / sr
    inter = (piece_on < end) & (piece_off > start)
    on = np.maximum(piece_on[inter], start) - start
    off = np.minimum(piece_off[inter], end) - start
    ids = list(PROMPT) + [SPECIES_UNKNOWN]
    for a, b in zip(on, off):
        ids += [TIMESTAMP_BASE + _column(a, step, columns), 0,
                TIMESTAMP_BASE + _column(b, step, columns)]
    ids = (ids + [EOT])[:max_length + 1]
    inputs, labels = ids[:-1], ids[1:]
    inputs += [PAD] * (max_length - len(inputs))
    labels += [-100] * (max_length - len(labels))
    return np.asarray(inputs, np.int64), np.asarray(labels, np.int64)


def find_crop(piece: np.ndarray, crop: np.ndarray) -> int:
    """Where ``crop`` (``piece[s:s + len(crop)]``, zero-padded where the
    piece ends) starts in ``piece``; -1 where it does not occur."""
    nz = np.flatnonzero(crop)
    if len(nz) == 0:  # a crop of the leading zero pad
        return 0 if not piece[:len(crop)].any() else -1
    j = int(nz[0])
    for pos in np.flatnonzero(piece == crop[j]):
        s = int(pos) - j
        real = min(len(crop), len(piece) - s)
        if (s >= 0 and np.array_equal(piece[s:s + 64], crop[:min(64, real)])
                and np.array_equal(piece[s:s + real], crop[:real])
                and not crop[real:].any()):
            return s
    return -1
