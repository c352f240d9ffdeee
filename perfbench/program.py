"""The harness's side of the program: it builds the system under test from a
cell's configuration, and its thin subclasses record what the timed path
produced (token lists, frame probabilities) and how long ``segment()``
took, without changing what it computes."""

from __future__ import annotations

import gc
import os
import threading
import time

import numpy as np

from . import weights as wt
from .common import ROOT, program_config


def recording_class(base):
    """``base`` (a Segmenter class) with each ``_generate_tokens`` and
    ``_frame_fn`` result kept under the calling thread's current request
    (``tag``), and each ``segment()`` / ``segment_from_frames()`` timed."""

    class Recording(base):
        def _start_recording(self):
            self.records = {}
            self.inside = {}
            self._tls = threading.local()
            self._rec_lock = threading.Lock()

        def tag(self, key):
            self._tls.key = key

        def _keep(self, kind, value):
            key = getattr(self._tls, "key", None)
            if key is None:
                return
            with self._rec_lock:
                self.records.setdefault(key, {}).setdefault(kind, []).append(
                    value)

        def _generate_tokens(self, clips, *args, **kwargs):
            out = super()._generate_tokens(clips, *args, **kwargs)
            self._keep("tokens", out)
            return out

        def _frame_fn(self, chunk, frontend):
            out = super()._frame_fn(chunk, frontend)
            self._keep("frames", out)
            return out

        def _timed(self, fn, *args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                key = getattr(self._tls, "key", None)
                if key is not None:
                    with self._rec_lock:
                        self.inside[key] = (t0, time.time_ns())

        def segment(self, *args, **kwargs):
            return self._timed(super().segment, *args, **kwargs)

        def segment_from_frames(self, *args, **kwargs):
            return self._timed(super().segment_from_frames, *args, **kwargs)

    return Recording


def build_segmenter(model: dict, seed: int, device, base=None,
                    inference_dtype: str = "bfloat16", **kwargs):
    """The cell's Segmenter (a recording subclass of ``base``): the
    checkpoint the configuration names, or weights drawn from ``seed`` on
    the device in the served type."""
    import torch
    from whisperseg_torch.segmenter import Segmenter

    cls = recording_class(base or Segmenter)
    if model.get("checkpoint"):
        seg = cls.from_pretrained(os.path.join(ROOT, model["checkpoint"]),
                                  inference_dtype=inference_dtype,
                                  device=device, **kwargs)
    else:
        dtype = torch.bfloat16 if inference_dtype == "bfloat16" else torch.float32
        flat = wt.random_weights(model, seed, device, dtype)
        seg = cls(wt.tree(flat), program_config(model),
                  inference_dtype=inference_dtype, device=device, **kwargs)
        del flat
    seg._start_recording()
    return seg


def reference_weights(model: dict, seed: int, device):
    """The same weights, for the reference, in float32 on ``device``."""
    import torch

    if model.get("checkpoint"):
        flat = wt.checkpoint_weights(os.path.join(ROOT, model["checkpoint"]))
        return {k: v.to(device) for k, v in flat.items()}
    served = torch.bfloat16 if model["inference_dtype"] == "bfloat16" \
        else torch.float32
    return {k: v.float() for k, v in
            wt.random_weights(model, seed, device, served).items()}


def host_sample() -> tuple:
    """The process's user and system CPU seconds, its minor page faults,
    its voluntary and involuntary context switches, and the host's stolen
    seconds (``/proc/stat``, 0 where it cannot be read), at one moment."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return (ru.ru_utime, ru.ru_stime, ru.ru_minflt, ru.ru_nvcsw,
            ru.ru_nivcsw, steal)


def host_window(before: tuple, wall: float) -> dict:
    """What the host did while the window ran, from ``host_sample()`` at its
    start: the process's user and system CPU seconds a wall second, its
    minor page faults and context switches, the host's stolen seconds."""
    d = [a - b for a, b in zip(host_sample(), before)]
    wall = max(wall, 1e-9)
    return {"user_per_wall": d[0] / wall, "sys_per_wall": d[1] / wall,
            "minor_faults": d[2], "voluntary_switches": d[3],
            "involuntary_switches": d[4], "steal_s": d[5]}


def back_to_back(ctx, call, pool_size: int, trace_requests: int):
    """``call(i, k)`` for request i on pool recording k, one after another
    in the seed's order of the pool, until the window closes (no request
    starts after it). A traced run traces the first ``trace_requests``.
    Returns (spans [(i, k, start_ns, end_ns)], the trace or None, the
    number traced, the window's seconds)."""
    from . import traffic

    order = np.random.RandomState(traffic.derived(ctx.seed, 4)).permutation(
        pool_size)
    spans, tracer, traced = [], ctx.tracer(), None
    before = host_sample()
    start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - start < ctx.seconds:
        k = int(order[i % pool_size])
        t0 = time.time_ns()
        call(i, k)
        spans.append((i, k, t0, time.time_ns()))
        i += 1
        if tracer is not None and traced is None and i >= trace_requests:
            tracer.stop()
            traced = i
    window = time.perf_counter() - start
    ctx.host = host_window(before, window)
    if tracer is not None and traced is None:   # the window closed first
        tracer.stop()
        traced = i
    return spans, tracer, traced, window


def release() -> None:
    """Give the device memory of the program's dropped state back."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_float(pcm: np.ndarray) -> np.ndarray:
    """16-bit PCM -> float32 as the program's WAV reader scales it."""
    return np.asarray(pcm, np.int16).astype(np.float32) / 32768.0
