"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` inside the package (git-ignored), where the
hash is that of the source, so an edited source rebuilds and a built one is
reused. Nothing is compiled when a module is imported: a wrapper calls
:func:`library` at its first launch, and :func:`build_all` starts one ``nvcc``
per source, all at once, for a caller that wants every kernel ready (the chip
smoke run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("melproject", "attention", "qdot", "cross_attention_int8")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_target(name)}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _target(name))  # atomic: a concurrent build never sees half


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every source not built yet, one ``nvcc`` each, in parallel."""
    todo = [n for n in names if not os.path.exists(_target(n))]
    procs = [(n, _start(n)) for n in todo]
    for n, p in procs:
        _finish(n, p)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            if not os.path.exists(_target(name)):
                _finish(name, _start(name))
            _loaded[name] = ctypes.CDLL(_target(name))
        return _loaded[name]
