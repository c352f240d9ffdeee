"""Host-side audio I/O (the port of ``whisperseg_tpu/audio/io.py``).

WAV decoding is the native C++ decoder (``audio/native.py``) when the
library builds, else the stdlib ``wave`` header parser plus numpy (PCM of 8,
16, 24 and 32 bits, and IEEE float, which ``wave`` rejects); resampling is
the native polyphase resampler for mono audio, else
``scipy.signal.resample_poly``. Compressed containers decode through
``audio/formats.py``: FLAC by ``audio/flac.py``, Ogg Vorbis by
``audio/vorbis.py`` (Ogg Opus through the system libopus), MP3 by the Layer
III decoder in ``audio/mp3.py`` (libmpg123 and SDL2_mixer as fallbacks).
The format is told by magic bytes, not by the file's extension, so bytes
from stdin or a request body work too.
"""

from __future__ import annotations

import io
import wave
from math import gcd
from typing import Optional, Tuple

import numpy as np

def _pcm_to_float(data: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    """Raw PCM bytes -> float32 in [-1, 1), shaped (num_frames, n_channels)."""
    if sampwidth == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        as32 = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        as32 = np.where(as32 & 0x800000, as32 - 0x1000000, as32)
        x = as32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported PCM sample width: {sampwidth}")
    return x.reshape(-1, n_channels)


def _read_wav_ieee_float(path_or_bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3) and PCM /
    extensible ones; None when the bytes are not such a WAV."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        return None
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(buf):
        chunk_id = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], "little")
        body = buf[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        return None
    tag = int.from_bytes(fmt[0:2], "little")
    n_channels = int.from_bytes(fmt[2:4], "little")
    sr = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if tag == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        width = bits // 8
        x = np.frombuffer(data[: len(data) // width * width], dtype=dtype)
        return x.astype(np.float32).reshape(-1, n_channels), sr
    if tag in (1, 0xFFFE):  # PCM / extensible
        return _pcm_to_float(data, bits // 8, n_channels), sr
    return None


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode a WAV file (path, bytes, or file-like) -> (float32 (frames, ch), sr).

    Uses the native C++ decoder (native/src/ws_audio.cpp) when built, with this
    numpy implementation as the reference fallback."""
    from . import native

    if native.available():
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        elif hasattr(path_or_bytes, "read"):
            path_or_bytes.seek(0)
            data = path_or_bytes.read()
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        decoded = native.decode_wav(data)
        if decoded is not None:
            return decoded
        path_or_bytes = data  # fall through to the numpy path

    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    elif hasattr(path_or_bytes, "read"):
        src = path_or_bytes
    else:
        src = path_or_bytes
    try:
        with wave.open(src if not isinstance(src, str) else src, "rb") as w:
            sr = w.getframerate()
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            data = w.readframes(w.getnframes())
        return _pcm_to_float(data, sampwidth, n_channels), sr
    except wave.Error:
        if hasattr(src, "seek"):
            src.seek(0)
            src = src.read()
        out = _read_wav_ieee_float(src)
        if out is None:
            raise
        return out


def save_wav(path, y: np.ndarray, sr: int) -> None:
    """Write float audio in [-1, 1], 1-D (mono) or (frames, channels), as a
    16-bit PCM WAV file."""
    y = np.asarray(y, dtype=np.float32)
    if y.ndim == 1:
        y = y[:, None]
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.tobytes())


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase FIR resampling along the first axis (native C++ when built,
    scipy fallback)."""
    if orig_sr == target_sr:
        return y
    from . import native

    if native.available() and y.ndim == 1:
        out = native.resample(y, int(orig_sr), int(target_sr))
        if out is not None:
            return out
    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(y, target_sr // g, orig_sr // g, axis=0).astype(np.float32)


def load_audio(
    path_or_bytes,
    sr: Optional[int] = None,
    mono: bool = True,
    channel_id: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible entry point: returns (float32 1-D or (ch, n), sr).

    ``mono=True`` averages channels (librosa semantics); ``channel_id`` selects one
    channel from a multi-channel file (reference segment_service.py:76-80).

    Accepts wav/flac/mp3/ogg — dispatched on magic bytes (see audio/formats.py).
    """
    from .formats import decode_compressed, sniff_format

    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:16])
    elif hasattr(path_or_bytes, "read"):
        path_or_bytes.seek(0)
        head = path_or_bytes.read(16)
        path_or_bytes.seek(0)
    else:
        with open(path_or_bytes, "rb") as f:
            head = f.read(16)
    fmt = sniff_format(head)
    if fmt in ("flac", "mp3", "ogg"):
        y, native_sr = decode_compressed(path_or_bytes, fmt)
    else:
        y, native_sr = read_wav(path_or_bytes)
    if channel_id is not None and y.shape[1] > 1:
        y = y[:, channel_id:channel_id + 1]
    if mono or y.shape[1] == 1:
        y = y.mean(axis=1)
    else:
        y = y.T  # (channels, samples), librosa layout
    target = int(sr) if sr is not None else native_sr
    if target != native_sr:
        y = resample(y.T if y.ndim == 2 else y, native_sr, target)
        y = y.T if y.ndim == 2 else y
    return np.ascontiguousarray(y, dtype=np.float32), target


def _flac_info_cheap(path: str) -> dict:
    """STREAMINFO from the file head; full read only if the metadata section
    (e.g. embedded artwork) exceeds the head window."""
    from .flac import flac_stream_info

    with open(path, "rb") as f:
        head = f.read(1 << 16)
    try:
        return flac_stream_info(head)
    except ValueError:
        with open(path, "rb") as f:
            return flac_stream_info(f.read())


def get_sampling_rate(path: str) -> int:
    """Header-only sampling-rate probe (reference audio_utils.py:19-22),
    covering wav/flac/mp3/ogg. Dispatches on magic bytes first so non-WAV
    files don't pay a full-file WAV parse attempt."""
    with open(path, "rb") as f:
        magic = f.read(16)
    from .formats import probe_sampling_rate, sniff_format

    fmt = sniff_format(magic)
    if fmt == "flac":
        return _flac_info_cheap(path)["sr"]
    if fmt in ("mp3", "ogg"):
        # mp3 resync may need to skip an arbitrarily large ID3 tag; ogg only
        # needs the first page — one read covers both
        with open(path, "rb") as f:
            return probe_sampling_rate(f.read())
    try:
        with wave.open(path, "rb") as w:
            return w.getframerate()
    except wave.Error:
        out = _read_wav_ieee_float(path)
        if out is not None:
            return out[1]
        with open(path, "rb") as f:
            return probe_sampling_rate(f.read())


def get_audio_duration(path: str) -> float:
    """Header-only duration probe in seconds (reference audio_utils.py:24-30),
    covering wav/flac/mp3/ogg."""
    with open(path, "rb") as f:
        magic = f.read(16)
    from .formats import probe_duration, sniff_format

    fmt = sniff_format(magic)
    if fmt == "flac":
        info = _flac_info_cheap(path)
        return info["total_samples"] / info["sr"] if info["sr"] else 0.0
    if fmt in ("mp3", "ogg"):
        # mp3 walks every frame (VBR-safe) and ogg reads the LAST page's
        # granule — both need the full byte string
        with open(path, "rb") as f:
            return probe_duration(f.read())
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    except wave.Error:
        with open(path, "rb") as f:
            data = f.read()
        out = _read_wav_ieee_float(data)
        if out is not None:
            y, sr = out
            return len(y) / sr
        return probe_duration(data)
