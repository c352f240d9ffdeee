"""ctypes bindings of the native audio-ingest library: the C++ WAV and FLAC
decoders and the polyphase resampler in ``native/src/ws_audio.cpp`` and
``native/src/ws_flac.cpp`` (the port of ``whisperseg_tpu/audio/native.py``).

The port builds its own copy of the library with the system C++ compiler
(``$CXX``, default ``g++``, with the flags of ``native/Makefile``) at first
use, into ``whisperseg_torch/_build/libws_audio-<hash>.so`` (git-ignored),
where the hash is that of the sources and the flags, so an edited source
rebuilds and a built one is reused. It neither runs ``make`` nor writes to
``native/build/``. Without a compiler, or with ``WS_NATIVE=0``, every
function returns None and the callers fall back to the numpy decoders in
``audio/io.py`` and ``audio/flac.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(os.path.dirname(_PKG), "native", "src", name)
            for name in ("ws_audio.cpp", "ws_flac.cpp")]
_BUILD_DIR = os.path.join(_PKG, "_build")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _target() -> str:
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for path in _SOURCES:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libws_audio-{digest.hexdigest()[:12]}.so")


def _build(target: str) -> bool:
    """Compile the library into ``target``; False when that fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o", tmp,
           *_SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)  # atomic: a concurrent build never sees half
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def library_path() -> str:
    """Where the library is (or will be) built."""
    return _target()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first call; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("WS_NATIVE", "1") == "0" or not all(
                os.path.exists(p) for p in _SOURCES):
            _lib_failed = True
            return None
        target = _target()
        if not os.path.exists(target) and not _build(target):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(target)
        except OSError:
            _lib_failed = True
            return None
        decode_args = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        for fn in (lib.ws_decode_wav, lib.ws_decode_flac):
            fn.restype = ctypes.c_int
            fn.argtypes = decode_args
        lib.ws_read_wav.restype = ctypes.c_int
        lib.ws_read_wav.argtypes = [ctypes.c_char_p] + decode_args[2:]
        lib.ws_resample.restype = ctypes.c_int64
        lib.ws_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.ws_free.restype = None
        lib.ws_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _take_array(lib, ptr, n) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.ws_free(ptr)
    return arr


def _decode(fn, data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int32()
    n_channels = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = fn(data, len(data), ctypes.byref(out), ctypes.byref(n_frames),
            ctypes.byref(n_channels), ctypes.byref(sr))
    if rc != 0:
        return None
    n = n_frames.value * n_channels.value
    arr = _take_array(_lib, out, n).reshape(n_frames.value, n_channels.value)
    return arr, sr.value


def decode_wav(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """WAV bytes -> (float32 (frames, channels), sr), or None if unavailable."""
    lib = get_lib()
    return None if lib is None else _decode(lib.ws_decode_wav, data)


def decode_flac(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """FLAC bytes -> (float32 (frames, channels), sr), or None if unavailable
    (the caller then uses the pure-Python decoder in ``audio/flac.py``)."""
    lib = get_lib()
    return None if lib is None else _decode(lib.ws_decode_flac, data)


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> Optional[np.ndarray]:
    """Mono float32 polyphase resample, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.ws_resample(y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        len(y), sr_in, sr_out, ctypes.byref(out))
    if n < 0:
        return None
    return _take_array(lib, out, n)
