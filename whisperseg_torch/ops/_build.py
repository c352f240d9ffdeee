"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` inside the package (git-ignored), where the
hash is that of the source and of every ``csrc`` header it includes, so an
edited source or header rebuilds and a built one is reused. Nothing is
compiled when a module is imported: a wrapper calls :func:`library` at its
first launch, and :func:`build_all` starts one ``nvcc`` per source, all at
once, for a caller that wants every kernel ready (the chip smoke run), and
returns each build's compiler output (``-Xptxas -v``: every kernel's
registers, spills and static shared memory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("melproject", "attention", "attention_bwd", "qdot",
           "cross_attention_int8")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

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


def _sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the headers it includes with quotes, directly
    or through another header, each once, in the order they are met."""
    order: List[str] = []

    def visit(path: str) -> None:
        if path in order or not os.path.exists(path):
            return  # a header nvcc finds elsewhere: not part of the sources
        order.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            visit(os.path.join(os.path.dirname(path), inc.decode()))

    visit(os.path.join(CSRC, f"{name}.cu"))
    return order


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_target(name)}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _target(name))  # atomic: a concurrent build never sees half
    return out


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not built yet, one ``nvcc`` each, in parallel;
    returns the compiler output of each source built."""
    todo = [n for n in names if not os.path.exists(_target(n))]
    procs = [(n, _start(n)) for n in todo]
    return {n: _finish(n, p) for n, p in procs}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            if not os.path.exists(_target(name)):
                _finish(name, _start(name))
            _loaded[name] = ctypes.CDLL(_target(name))
        return _loaded[name]
