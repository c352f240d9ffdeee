"""MP3 decode through the system libmpg123, driven via ctypes.

The port's copy of ``whisperseg_tpu/audio/mpg123.py``;
it imports neither jax nor that package.

A lighter-weight alternative to the pygame/SDL2_mixer backend for ``.mp3``
ingest (``audio/formats.py``): libmpg123 is a single small C library that is
present on most Linux systems (and ships with SDL2_mixer installs). No
Python package is required. Ogg Vorbis and FLAC decode fully in-repo
(``audio/vorbis.py``, ``audio/flac.py``); MP3 remains the one delegated
format (the reference delegates ALL formats to librosa/audioread,
reference datautils.py:116).

Output is float32 at the stream's native rate with no hidden resampling:
the handle's format table is cleared and pinned to (native rate, float32)
before decode.
"""

from __future__ import annotations

import ctypes as C
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11

_lib: Optional[C.CDLL] = None
_lib_tried = False


def _load() -> Optional[C.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("libmpg123.so.0", "libmpg123.so", "libmpg123.0.dylib",
                 "libmpg123.dylib"):
        try:
            lib = C.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init()
        lib.mpg123_new.restype = C.c_void_p
        lib.mpg123_new.argtypes = [C.c_char_p, C.POINTER(C.c_int)]
        lib.mpg123_open.argtypes = [C.c_void_p, C.c_char_p]
        lib.mpg123_getformat.argtypes = [C.c_void_p, C.POINTER(C.c_long),
                                         C.POINTER(C.c_int),
                                         C.POINTER(C.c_int)]
        lib.mpg123_format_none.argtypes = [C.c_void_p]
        lib.mpg123_format.argtypes = [C.c_void_p, C.c_long, C.c_int, C.c_int]
        lib.mpg123_rates.argtypes = [C.POINTER(C.POINTER(C.c_long)),
                                     C.POINTER(C.c_size_t)]
        lib.mpg123_read.argtypes = [C.c_void_p, C.c_void_p, C.c_size_t,
                                    C.POINTER(C.c_size_t)]
        lib.mpg123_close.argtypes = [C.c_void_p]
        lib.mpg123_delete.argtypes = [C.c_void_p]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return _load() is not None


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> (float32 [frames, channels], native sr)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = C.c_int(0)
    handle = lib.mpg123_new(None, C.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    tmp = tempfile.NamedTemporaryFile(suffix=".mp3", delete=False)
    try:
        tmp.write(data)
        tmp.close()
        # pin float32 output for every supported rate BEFORE open (the
        # format table only applies at stream start); channels arg is the
        # MPG123_MONO|MPG123_STEREO bitmask (3 = both)
        lib.mpg123_format_none(handle)
        rates = C.POINTER(C.c_long)()
        n_rates = C.c_size_t(0)
        lib.mpg123_rates(C.byref(rates), C.byref(n_rates))
        for i in range(n_rates.value):
            lib.mpg123_format(handle, rates[i], 3, _MPG123_ENC_FLOAT_32)
        if lib.mpg123_open(handle, tmp.name.encode()) != _MPG123_OK:
            raise RuntimeError("mpg123_open failed")
        rate = C.c_long(0)
        channels = C.c_int(0)
        encoding = C.c_int(0)
        if lib.mpg123_getformat(handle, C.byref(rate), C.byref(channels),
                                C.byref(encoding)) != _MPG123_OK:
            raise RuntimeError("mpg123_getformat failed")
        sr, ch = int(rate.value), int(channels.value)
        if encoding.value != _MPG123_ENC_FLOAT_32:
            raise RuntimeError(
                f"mpg123 refused float32 output (got encoding "
                f"{encoding.value:#x})")
        chunks = []
        buf = (C.c_char * (1 << 18))()
        done = C.c_size_t(0)
        while True:
            ret = lib.mpg123_read(handle, buf, len(buf), C.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if ret == _MPG123_DONE:
                break
            if ret not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                # mid-stream error after some output: keep what we have
                if chunks:
                    break
                raise RuntimeError(f"mpg123_read failed ({ret})")
        lib.mpg123_close(handle)
        pcm = np.frombuffer(b"".join(chunks), np.float32)
        if ch > 1:
            pcm = pcm.reshape(-1, ch)
        else:
            pcm = pcm.reshape(-1, 1)
        return np.clip(pcm, -1.0, 1.0), sr
    finally:
        lib.mpg123_delete(handle)
        os.unlink(tmp.name)
