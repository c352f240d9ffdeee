"""Bounded-memory streaming ingest (the port of
``whisperseg_tpu/audio/stream.py``).

:class:`AudioStream` yields fixed-length mono float32 chunks of a file at
a target sampling rate while holding only O(chunk) samples;
``Segmenter.segment_streaming`` consumes it with per-trial carry buffers, so
the whole segmentation pipeline runs at bounded memory over files of any
length.

Chunked resampling is exact: each interior chunk is resampled together with
one second of real signal on each side and its central part is kept. The
polyphase FIR output at a position depends only on the input within the
filter's half-width (``10 * max(up, down)`` taps in the upsampled domain, far
less than one second of input at audio rates), so interior outputs equal
those of resampling the whole file at once. Chunk boundaries fall on whole
input seconds, which makes every slice index exact integer arithmetic under
the resampler's ``ceil(n * up / down)`` output length.

WAV files (PCM 8/16/24/32-bit and IEEE float, plain or
WAVE_FORMAT_EXTENSIBLE) stream off disk. Compressed containers (flac, mp3,
ogg) are decoded whole at their native rate, since their codecs carry state
from frame to frame, and then served in chunks like a WAV file, so that
downstream code has one path; the memory bound holds for the WAV recordings
that long field sessions produce.
"""

from __future__ import annotations

from math import gcd
from typing import Iterator, Optional

import numpy as np

from .formats import sniff_format
from .io import _pcm_to_float, resample


class _WavChunkReader:
    """Random access into the data chunk of a RIFF/WAVE file without loading
    it: parses the header once, then ``read_frames(start, count)`` seeks and
    decodes just that span. Covers the same format tags as
    :func:`whisperseg_torch.audio.io.read_wav` (PCM 1 / IEEE-float 3 /
    extensible 0xFFFE)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        head = self._f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            self._f.close()
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        self._data_offset = None
        self._data_size = 0
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                break
            chunk_id = hdr[:4]
            size = int.from_bytes(hdr[4:8], "little")
            if chunk_id == b"fmt ":
                fmt = self._f.read(size)
            elif chunk_id == b"data":
                self._data_offset = self._f.tell()
                # tolerate a header that over-declares past EOF (truncated file)
                self._f.seek(0, 2)
                self._data_size = min(size, self._f.tell() - self._data_offset)
            else:
                self._f.seek(size, 1)
            if size & 1 and chunk_id != b"data":
                self._f.seek(1, 1)
            if fmt is not None and self._data_offset is not None:
                break
        if fmt is None or self._data_offset is None:
            self._f.close()
            raise ValueError(f"WAV missing fmt/data chunk: {path}")
        self.tag = int.from_bytes(fmt[0:2], "little")
        self.n_channels = max(1, int.from_bytes(fmt[2:4], "little"))
        self.sr = int.from_bytes(fmt[4:8], "little")
        self.bits = int.from_bytes(fmt[14:16], "little")
        if self.tag not in (1, 3, 0xFFFE):
            self._f.close()
            raise ValueError(f"unsupported WAV format tag {self.tag}: {path}")
        if self.tag == 3 and self.bits not in (32, 64):
            self._f.close()
            raise ValueError(f"unsupported float WAV bit depth {self.bits}")
        self._frame_size = self.n_channels * self.bits // 8
        self.n_frames = self._data_size // self._frame_size

    def read_frames(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start+count) -> float32 (count, n_channels)."""
        self._f.seek(self._data_offset + start * self._frame_size)
        data = self._f.read(count * self._frame_size)
        if self.tag == 3:
            dtype = "<f4" if self.bits == 32 else "<f8"
            x = np.frombuffer(data, dtype=dtype).astype(np.float32)
            return x.reshape(-1, self.n_channels)
        return _pcm_to_float(data, self.bits // 8, self.n_channels)

    def close(self):
        self._f.close()


class AudioStream:
    """Iterate a long audio file as mono float32 chunks at a target rate.

    ``sr=None`` keeps the file's native rate. ``chunk_seconds`` is rounded to
    whole seconds (the exact-resampling alignment unit); each yielded chunk
    has ``chunk_seconds * sr`` samples except the last. ``channel_id``
    selects one channel before the mono mix, as
    :func:`whisperseg_torch.audio.io.load_audio` does. Concatenating the
    yielded chunks equals ``load_audio(path, sr=sr,
    channel_id=channel_id)[0]`` exactly.
    """

    def __init__(self, path: str, sr: Optional[int] = None,
                 chunk_seconds: float = 60.0,
                 channel_id: Optional[int] = None):
        self.path = path
        self.channel_id = channel_id
        self.chunk_seconds = max(1, int(round(chunk_seconds)))
        with open(path, "rb") as f:
            head = f.read(16)
        self._fallback_audio: Optional[np.ndarray] = None
        if sniff_format(head) in ("flac", "mp3", "ogg"):
            # stateful codecs: decoded whole, served in chunks (module doc)
            self._fallback_audio, self.native_sr = _load_native(
                path, channel_id)
            self.n_frames = len(self._fallback_audio)
            self._reader = None
        else:
            self._reader = _WavChunkReader(path)
            self.native_sr = self._reader.sr
            self.n_frames = self._reader.n_frames
        self.sr = int(sr) if sr else self.native_sr
        self.duration = self.n_frames / self.native_sr if self.native_sr else 0.0

    # --------------------------------------------------------------- internals

    def _mono(self, frames: np.ndarray) -> np.ndarray:
        """(n, ch) -> (n,) with load_audio's channel-select + mean semantics."""
        if self.channel_id is not None and frames.shape[1] > 1:
            frames = frames[:, self.channel_id:self.channel_id + 1]
        return np.ascontiguousarray(frames.mean(axis=1), dtype=np.float32)

    def _read_input(self, start: int, count: int) -> np.ndarray:
        if self._reader is not None:
            return self._mono(self._reader.read_frames(start, count))
        return self._fallback_audio[start:start + count]

    def __iter__(self) -> Iterator[np.ndarray]:
        n_in = self.n_frames
        native, target = self.native_sr, self.sr
        chunk_in = self.chunk_seconds * native
        if native == target:
            pos = 0
            while pos < n_in:
                n = min(chunk_in, n_in - pos)
                yield self._read_input(pos, n)
                pos += n
            return
        # exact chunked resampling: whole-second chunk boundaries + 1 s of
        # real context on each interior edge (see module docstring)
        g = gcd(native, target)
        up, down = target // g, native // g
        ctx = native  # 1 s >> filter half-width (10*max(up,down)/up inputs)
        pos = 0
        while pos < n_in:
            n = min(chunk_in, n_in - pos)
            a = max(0, pos - ctx)
            b = min(n_in, pos + n + ctx)
            y = resample(self._read_input(a, b - a), native, target)
            out_start = (pos - a) * up // down  # exact: pos-a is 0 or ctx
            if pos + n >= n_in:
                out = y[out_start:]  # right edge == global right edge
            else:
                out = y[out_start: out_start + n * up // down]
            yield np.ascontiguousarray(out, dtype=np.float32)
            pos += n

    def close(self):
        if self._reader is not None:
            self._reader.close()
        self._fallback_audio = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load_native(path: str, channel_id: Optional[int]):
    """The whole file at its native rate, with ``load_audio``'s channel
    semantics."""
    from .io import load_audio

    y, native_sr = load_audio(path, sr=None, mono=True, channel_id=channel_id)
    return np.asarray(y, dtype=np.float32), native_sr
