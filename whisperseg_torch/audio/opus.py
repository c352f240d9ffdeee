"""Ogg Opus ingest: in-repo Ogg demux + system libopus via ctypes.

The port's copy of ``whisperseg_tpu/audio/opus.py``;
it imports neither jax nor that package.

Opus (RFC 6716) is a hybrid SILK/CELT codec — a from-scratch decoder is out
of scope, but the container no longer needs pygame/SDL2_mixer: pages and
packets parse through the same Ogg layer as the from-scratch Vorbis decoder
(``vorbis._ogg_pages``), and raw packets decode through libopus (present on
any system with Opus support; no Python package needed).

RFC 7845 container semantics handled here: OpusHead (channels, pre-skip,
output gain), 48 kHz canonical decode rate, pre-skip trimming, and final-page
granule trimming. Channel mapping family 0 (mono/stereo) is supported —
multistream surround falls back to SDL.

The test fixture encoder (``_encode_ogg_opus``) wraps libopus packets in
Ogg pages written by this module (including the Ogg CRC), so the demux path
is validated without any external encoder binary.
"""

from __future__ import annotations

import ctypes as C
from typing import List, Optional, Tuple

import numpy as np

from .vorbis import _ogg_pages

_lib: Optional[C.CDLL] = None
_tried = False


def _load() -> Optional[C.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for name in ("libopus.so.0", "libopus.so", "libopus.dylib"):
        try:
            lib = C.CDLL(name)
        except OSError:
            continue
        lib.opus_decoder_create.restype = C.c_void_p
        lib.opus_decoder_create.argtypes = [C.c_int, C.c_int,
                                            C.POINTER(C.c_int)]
        lib.opus_decode_float.argtypes = [C.c_void_p, C.c_char_p, C.c_int,
                                          C.POINTER(C.c_float), C.c_int,
                                          C.c_int]
        lib.opus_decoder_destroy.argtypes = [C.c_void_p]
        lib.opus_encoder_create.restype = C.c_void_p
        lib.opus_encoder_create.argtypes = [C.c_int, C.c_int, C.c_int,
                                            C.POINTER(C.c_int)]
        lib.opus_encode_float.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                                          C.c_int, C.c_char_p, C.c_int]
        lib.opus_encoder_destroy.argtypes = [C.c_void_p]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return _load() is not None


def looks_like_ogg_opus(data: bytes) -> bool:
    if data[:4] != b"OggS":
        return False
    # first page body starts after the 27-byte header + lacing table
    nsegs = data[26] if len(data) > 26 else 0
    body = data[27 + nsegs: 27 + nsegs + 8]
    return body[:8] == b"OpusHead"


def decode_ogg_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Ogg Opus bytes -> (float32 [frames, channels], 48000)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libopus not available")

    target_serial = None
    carry = b""
    carrying = False
    head = None
    n_head_packets = 0
    chunks: List[np.ndarray] = []
    dec = None
    trim_to = None
    try:
        for serial, htype, granule, packets, tail in _ogg_pages(data):
            if target_serial is None:
                if packets and packets[0][:8] == b"OpusHead":
                    target_serial = serial
                else:
                    continue
            if serial != target_serial:
                continue
            if carrying and packets:
                packets[0] = carry + packets[0]
                carry = b""
                carrying = False
            elif carrying and not packets:
                carry += tail
                continue
            for pk in packets:
                if n_head_packets == 0:
                    if pk[:8] != b"OpusHead" or len(pk) < 19:
                        raise ValueError("bad OpusHead")
                    channels = pk[9]
                    pre_skip = int.from_bytes(pk[10:12], "little")
                    gain_q8 = int.from_bytes(pk[16:18], "little",
                                             signed=True)
                    family = pk[18]
                    if family != 0 or channels not in (1, 2):
                        raise ValueError(
                            f"unsupported Opus channel mapping family "
                            f"{family} / {channels} channels")
                    head = (channels, pre_skip, gain_q8)
                    err = C.c_int(0)
                    dec = lib.opus_decoder_create(48000, channels,
                                                  C.byref(err))
                    if err.value or not dec:
                        raise RuntimeError(f"opus_decoder_create "
                                           f"({err.value})")
                    n_head_packets = 1
                elif n_head_packets == 1:
                    # OpusTags — required, skipped
                    n_head_packets = 2
                else:
                    channels = head[0]
                    out = np.empty(5760 * channels, dtype=np.float32)
                    n = lib.opus_decode_float(
                        dec, pk, len(pk),
                        out.ctypes.data_as(C.POINTER(C.c_float)), 5760, 0)
                    if n < 0:
                        raise RuntimeError(f"opus_decode_float ({n})")
                    chunks.append(out[: n * channels]
                                  .reshape(n, channels).copy())
            if tail:
                carry = tail
                carrying = True
            if htype & 0x04 and granule >= 0:
                trim_to = granule
    finally:
        if dec:
            lib.opus_decoder_destroy(dec)

    if head is None:
        raise ValueError("no Ogg Opus stream found")
    channels, pre_skip, gain_q8 = head
    if not chunks:
        return np.zeros((0, channels), np.float32), 48000
    pcm = np.concatenate(chunks, axis=0)
    pcm = pcm[pre_skip:]
    if trim_to is not None:
        total = max(trim_to - pre_skip, 0)
        if total < len(pcm):
            pcm = pcm[:total]
    if gain_q8:
        pcm = pcm * (10.0 ** (gain_q8 / (20.0 * 256.0)))
    return np.clip(pcm, -1.0, 1.0).astype(np.float32), 48000


# ------------------------------------------------------- Ogg page writer

_CRC_TABLE = None


def _ogg_crc(data: bytes) -> int:
    """Ogg CRC32: poly 0x04c11db7, no reflection, init/xorout 0."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = []
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if (r & 0x80000000) \
                    else (r << 1) & 0xFFFFFFFF
            tab.append(r)
        _CRC_TABLE = tab
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


def _ogg_page(serial: int, seq: int, granule: int, packets: List[bytes],
              htype: int = 0) -> bytes:
    lacing = bytearray()
    body = bytearray()
    for pk in packets:
        n = len(pk)
        while n >= 255:
            lacing.append(255)
            n -= 255
        lacing.append(n)
        body += pk
    header = bytearray(b"OggS\x00")
    header.append(htype)
    header += int(granule).to_bytes(8, "little", signed=True)
    header += serial.to_bytes(4, "little")
    header += seq.to_bytes(4, "little")
    header += b"\x00\x00\x00\x00"  # CRC placeholder
    header.append(len(lacing))
    header += lacing
    page = bytes(header) + bytes(body)
    crc = _ogg_crc(page)
    return page[:22] + crc.to_bytes(4, "little") + page[26:]


def _encode_ogg_opus(pcm: np.ndarray, channels: int = 1,
                     bitrate: int = 64000) -> bytes:
    """48 kHz float PCM -> Ogg Opus bytes (test-fixture encoder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libopus not available")
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    err = C.c_int(0)
    enc = lib.opus_encoder_create(48000, channels, 2048,  # OPUS_APPLICATION_AUDIO
                                  C.byref(err))
    if err.value or not enc:
        raise RuntimeError(f"opus_encoder_create ({err.value})")
    try:
        frame = 960  # 20 ms @ 48 kHz
        pre_skip = 312  # libopus default lookahead at 48 kHz
        packets = []
        n = len(pcm)
        # encode pre_skip extra samples so the decoder-side lookahead trim
        # still leaves n samples (RFC 7845 4: granule pos counts pre-skip)
        total = n + pre_skip
        padded = np.zeros(((total + frame - 1) // frame * frame, channels),
                          dtype=np.float32)
        padded[:n] = pcm
        buf = C.create_string_buffer(4000)
        for i in range(0, len(padded), frame):
            chunk = np.ascontiguousarray(padded[i: i + frame])
            m = lib.opus_encode_float(
                enc, chunk.ctypes.data_as(C.POINTER(C.c_float)), frame,
                buf, len(buf))
            if m < 0:
                raise RuntimeError(f"opus_encode_float ({m})")
            packets.append(buf.raw[:m])
    finally:
        lib.opus_encoder_destroy(enc)

    serial = 0x5753  # arbitrary
    head = (b"OpusHead\x01" + bytes([channels])
            + pre_skip.to_bytes(2, "little")
            + (48000).to_bytes(4, "little") + b"\x00\x00\x00")
    tags = b"OpusTags" + (10).to_bytes(4, "little") + b"whisperseg" \
        + (0).to_bytes(4, "little")
    out = _ogg_page(serial, 0, 0, [head], htype=2)  # BOS
    out += _ogg_page(serial, 1, 0, [tags])
    granule = pre_skip
    seq = 2
    for i, pk in enumerate(packets):
        granule += 960
        last = i == len(packets) - 1
        g = (n + pre_skip) if last else granule
        out += _ogg_page(serial, seq, g, [pk],
                         htype=4 if last else 0)
        seq += 1
    return out
