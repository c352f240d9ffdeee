"""Compressed-audio ingest: format sniffing, mp3/ogg/flac decode, header probes.

The port's copy of ``whisperseg_tpu/audio/formats.py``;
it imports neither jax nor that package.

The reference accepts any container librosa reads — mp3 uploads in the GUI
(reference demo.py:78), arbitrary formats in the service and data layer
(reference segment_service.py:76-80, datautils.py:116). This environment has
no librosa/soundfile/ffmpeg, so:

  * FLAC decodes through the from-scratch codec in ``audio/flac.py``
    (pure numpy, no dependencies, bit-exact — see tests/test_audio_formats.py).
  * Ogg Vorbis decodes through the from-scratch decoder in ``audio/vorbis.py``
    (pure numpy, no dependencies, verified against libvorbisfile — see
    tests/test_vorbis.py); non-Vorbis Ogg payloads (e.g. Opus) fall back to
    SDL2_mixer when present.
  * MP3 decodes through the from-scratch Layer III decoder in ``audio/mp3.py``
    (pure numpy; constant tables recovered from libmpg123 by behavioral
    system identification, scripts/mp3_oracle_extract.py; output within
    ~3e-6 of libmpg123 across all rates/modes). The system libmpg123
    (``audio/mpg123.py``, ctypes) and SDL2_mixer (``pygame``) remain as
    fallbacks for profiles it rejects (Layer I/II, free-format bitrate).

Header probes (`sniff_format`, `probe_sampling_rate`, `probe_duration`) are
pure Python and dependency-free for all four formats, replacing the
reference's soundfile/mutagen metadata readers (reference audio_utils.py:19-30).
"""

from __future__ import annotations

import io
import os
import threading
from typing import Optional, Tuple

import numpy as np

# decoding through pygame flips global SDL mixer state; serialize it
_SDL_LOCK = threading.Lock()

_MPEG_SR = {
    3: (44100, 48000, 32000),   # MPEG-1   (version bits 0b11)
    2: (22050, 24000, 16000),   # MPEG-2   (0b10)
    0: (11025, 12000, 8000),    # MPEG-2.5 (0b00)
}
_MPEG_BITRATE_V1_L3 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                       224, 256, 320, 0)
_MPEG_BITRATE_V2_L3 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112,
                       128, 144, 160, 0)
_MPEG_BITRATE_V1_L2 = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                       256, 320, 384, 0)


def sniff_format(data: bytes) -> str:
    """'wav' | 'flac' | 'ogg' | 'mp3' | 'unknown' from magic bytes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"OggS":
        return "ogg"
    if data[:3] == b"ID3":
        return "mp3"
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return "mp3"
    return "unknown"


def _read_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    if hasattr(path_or_bytes, "read"):
        path_or_bytes.seek(0)
        return path_or_bytes.read()
    with open(path_or_bytes, "rb") as f:
        return f.read()


# ------------------------------------------------------------------ mp3 header


def _skip_id3(data: bytes) -> int:
    if data[:3] != b"ID3" or len(data) < 10:
        return 0
    size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
        | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
    return 10 + size


def _parse_mp3_frame(data: bytes, pos: int):
    """Header at pos -> (sr, channels, samples_per_frame, frame_bytes) or None."""
    if pos + 4 > len(data):
        return None
    b0, b1, b2, b3 = data[pos:pos + 4]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version = (b1 >> 3) & 0x3        # 3 = MPEG1, 2 = MPEG2, 0 = MPEG2.5
    layer = (b1 >> 1) & 0x3          # 1 = Layer III
    if version == 1 or layer == 0:
        return None
    br_idx = (b2 >> 4) & 0xF
    sr_idx = (b2 >> 2) & 0x3
    if br_idx in (0, 15) or sr_idx == 3:
        return None
    padding = (b2 >> 1) & 0x1
    mode = (b3 >> 6) & 0x3
    sr = _MPEG_SR[version][sr_idx]
    channels = 1 if mode == 3 else 2
    if layer == 1:  # Layer III
        kbps = (_MPEG_BITRATE_V1_L3 if version == 3
                else _MPEG_BITRATE_V2_L3)[br_idx]
        spf = 1152 if version == 3 else 576
        frame_bytes = spf * kbps * 1000 // 8 // sr + padding
    elif layer == 2:  # Layer II (own bitrate table; MPEG2 L2 shares L3's)
        kbps = (_MPEG_BITRATE_V1_L2 if version == 3
                else _MPEG_BITRATE_V2_L3)[br_idx]
        spf = 1152
        frame_bytes = 144 * kbps * 1000 // sr + padding
    else:  # Layer I
        return None
    if frame_bytes <= 4:
        return None
    return sr, channels, spf, frame_bytes


def mp3_stream_info(data: bytes) -> dict:
    """Scan MPEG audio frames -> {sr, channels, duration} (header-only)."""
    pos = _skip_id3(data)
    # resync: search for the first parsable frame followed by another valid
    # frame header (guards against 0xFF bytes inside tag padding)
    first = None
    scan_limit = min(len(data), pos + 65536)
    while pos < scan_limit:
        f = _parse_mp3_frame(data, pos)
        if f is not None:
            nxt = _parse_mp3_frame(data, pos + f[3])
            if nxt is not None or pos + f[3] >= len(data) - 4:
                first = f
                break
        pos += 1
    if first is None:
        raise ValueError("mp3: no MPEG audio frame found")
    sr, channels, _, _ = first
    # walk all frames to count samples (VBR-safe)
    n_frames = 0
    spf = first[2]
    while pos + 4 <= len(data):
        f = _parse_mp3_frame(data, pos)
        if f is None:
            pos += 1
            continue
        n_frames += 1
        pos += f[3]
    return {"sr": sr, "channels": channels,
            "duration": n_frames * spf / sr}


# ------------------------------------------------------------------ ogg header


def ogg_stream_info(data: bytes) -> dict:
    """Vorbis/Opus identification header + last-page granule -> metadata."""
    if data[:4] != b"OggS":
        raise ValueError("ogg: missing OggS capture pattern")
    # first page payload starts after the 27-byte header + segment table
    nsegs = data[26]
    payload = data[27 + nsegs:27 + nsegs + 64]
    if payload[:7] == b"\x01vorbis":
        channels = payload[11]
        sr = int.from_bytes(payload[12:16], "little")
    elif payload[:8] == b"OpusHead":
        channels = payload[9]
        sr = 48000  # Opus always decodes at 48 kHz
    else:
        raise ValueError("ogg: not a Vorbis/Opus stream")
    # Duration: granule position of the last PAGE = total PCM samples. The
    # 4 bytes "OggS" can also occur inside compressed packet payloads, so
    # validate each rfind candidate as a real page header (version byte 0,
    # header-type flags <= 7, segment table within the buffer) and keep
    # scanning backward until one checks out.
    granule = 0
    last = len(data)
    while True:
        last = data.rfind(b"OggS", 0, last)
        if last < 0:
            break
        if (last + 27 <= len(data) and data[last + 4] == 0
                and data[last + 5] <= 7
                and last + 27 + data[last + 26] <= len(data)):
            granule = int.from_bytes(data[last + 6:last + 14], "little",
                                     signed=True)
            break
    duration = granule / sr if granule > 0 else 0.0
    return {"sr": sr, "channels": channels, "duration": duration}


# -------------------------------------------------------------- pygame decode


def _sdl_available() -> bool:
    try:
        import pygame  # noqa: F401

        return True
    except Exception:
        return False


def decode_with_sdl(data: bytes, fmt: str, sr: int,
                    channels: int) -> np.ndarray:
    """Decode mp3/ogg bytes through SDL2_mixer at the stream's native rate.

    Returns float32 (num_frames, channels). The mixer is (re)initialized at
    exactly (sr, channels) so SDL does not resample or remix behind our back.
    """
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame
    import pygame.sndarray

    with _SDL_LOCK:
        init = pygame.mixer.get_init()
        if init != (sr, -16, channels):
            pygame.mixer.quit()
            pygame.mixer.init(frequency=sr, size=-16, channels=channels)
        sound = pygame.mixer.Sound(io.BytesIO(data))
        arr = pygame.sndarray.array(sound)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr.astype(np.float32) / 32768.0


def decode_compressed(path_or_bytes, fmt: Optional[str] = None
                      ) -> Tuple[np.ndarray, int]:
    """flac/mp3/ogg -> (float32 (num_frames, channels), native sr)."""
    data = _read_bytes(path_or_bytes)
    fmt = fmt or sniff_format(data)
    if fmt == "flac":
        from .flac import decode_flac

        return decode_flac(data)
    if fmt == "ogg":
        from .vorbis import VorbisError, decode_ogg_vorbis

        try:
            pcm, sr = decode_ogg_vorbis(data)
            # lossy float decode can overshoot +-1 (libvorbisfile's float
            # path does too); clip to the pipeline's int16-era invariant
            return np.clip(pcm, -1.0, 1.0), sr
        except VorbisError:
            # non-Vorbis Ogg payload: Ogg Opus demuxes in-repo and decodes
            # through the system libopus (audio/opus.py); anything else
            # (FLAC-in-Ogg, floor type 0, multistream surround Opus) tries
            # the SDL fallback below
            from . import opus

            if opus.looks_like_ogg_opus(data) and opus.available():
                try:
                    return opus.decode_ogg_opus(data)
                except Exception:
                    if not _sdl_available():
                        raise
            elif not _sdl_available():
                raise
    if fmt == "mp3":
        # in-repo Layer III decoder first (validated to ~3e-6 of libmpg123
        # across all rates/modes, tests/test_mp3.py); system libmpg123 and
        # SDL2_mixer remain as fallbacks for anything it rejects (Layer I/II,
        # free-format bitrate)
        from .mp3 import decode_mp3 as decode_mp3_native

        try:
            return decode_mp3_native(data)
        except Exception:
            pass
        from . import mpg123

        if mpg123.available():
            try:
                return mpg123.decode_mp3(data)
            except RuntimeError:
                if not _sdl_available():
                    raise
    if fmt in ("mp3", "ogg"):
        if not _sdl_available():
            raise RuntimeError(
                f"cannot decode {fmt}: no decoder backend available "
                f"(install libmpg123 or pygame/SDL2_mixer for mp3, or "
                f"convert to wav/flac/ogg — all three decode natively)")
        try:
            info = mp3_stream_info(data) if fmt == "mp3" \
                else ogg_stream_info(data)
            sr, channels = info["sr"], info["channels"]
        except ValueError:
            # our header parser covers the common profiles (MPEG Layer II/III,
            # Vorbis/Opus); streams it can't identify (e.g. MPEG Layer I,
            # free-format bitrate) may still decode through SDL2_mixer — fall
            # back to a fixed mixer rate rather than refusing a decodable file
            sr, channels = 44100, 2
        pcm = decode_with_sdl(data, fmt, sr, channels)
        return pcm, sr
    raise ValueError(
        f"unsupported audio format {fmt!r}: supported are wav, flac"
        + (", mp3, ogg" if _sdl_available() else
           " (mp3/ogg additionally need the pygame/SDL2_mixer backend)"))


def probe_sampling_rate(data: bytes) -> int:
    fmt = sniff_format(data)
    if fmt == "flac":
        from .flac import flac_stream_info

        return flac_stream_info(data)["sr"]
    if fmt == "mp3":
        return mp3_stream_info(data)["sr"]
    if fmt == "ogg":
        return ogg_stream_info(data)["sr"]
    raise ValueError(f"cannot probe sampling rate of format {fmt!r}")


def probe_duration(data: bytes) -> float:
    fmt = sniff_format(data)
    if fmt == "flac":
        from .flac import flac_stream_info

        info = flac_stream_info(data)
        return info["total_samples"] / info["sr"] if info["sr"] else 0.0
    if fmt == "mp3":
        return mp3_stream_info(data)["duration"]
    if fmt == "ogg":
        return ogg_stream_info(data)["duration"]
    raise ValueError(f"cannot probe duration of format {fmt!r}")
