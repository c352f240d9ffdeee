#!/usr/bin/env python3
"""Graph times of the port's w8a16 / w4a16 kernels (K3 / K4) on one NVIDIA
GPU, for the checkout at ROOT (default: the directory of this script):

    python3 chip_qdot_times.py [ROOT] [--sweep | --decode]
    python3 chip_qdot_times.py [ROOT] --mel-cross [--save=OUT.pt]
    python3 chip_qdot_times.py --compare=A.pt,B.pt
    python3 chip_qdot_times.py --k5-phases

Each time is the mean of the launches replayed from one CUDA graph (the
device's own time), x float32 as the model gives it:

  * the base model's decode products (M 16 and 48; K x out 512 x 512,
    512 x 2048, 2048 x 512);
  * M 512 (a one-window batch's encoder) at every projection shape of
    every model size, beside the large-M route (dequantize to bf16, then
    one matmul) and beside the same launch with x left in float32 (the
    wrapper rounds it to bf16 first above 64 rows).

``--decode`` times the decode shapes alone. ``--sweep`` times instead, at M 512, the kernel under every launch plan of
a grid (piece size, cluster size, chunk rows) that the checkout's C entry
points accept, and prints the three fastest a shape.

``--mel-cross`` times instead the log-mel projection (K1) at every n_fft
and at the mouse preset (beside its plain version, and the whole frontend
of one batch of 4 windows), and the int8 cross-attention (K5) at the chip
smoke run's cases; ``--save`` keeps their outputs (same inputs, from fixed
seeds, in every checkout), and ``--compare`` prints the largest difference
between two such files, output by output. ``--k5-phases`` builds a copy of
this checkout's int8 cross-attention kernel with the device's clock read by
the first thread of every block at the ends of its phases, and prints the
mean time of each phase at three of the smoke run's cases.

Prints one JSON line ``{"root": ..., "card": ..., "times": [...]}``. To
compare two checkouts, run it on both in turns (a, b, b, a) in one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
SWEEP = "--sweep" in sys.argv[1:]
DECODE_ONLY = "--decode" in sys.argv[1:]
MEL_CROSS = "--mel-cross" in sys.argv[1:]
K5_PHASES = "--k5-phases" in sys.argv[1:]
OPTIONS = dict(a[2:].split("=", 1) for a in sys.argv[1:]
               if a.startswith("--") and "=" in a)
ROOT = os.path.abspath(ARGS[0] if ARGS else os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DECODE = [(512, 512), (512, 2048), (2048, 512)]


def quant_shapes():
    shapes = []
    for d in (384, 512, 768, 1024, 1280):
        shapes += [(d, d), (d, 4 * d), (4 * d, d)]
    return shapes + [(512, 640)]


def graph_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def variant(quant, bits, x, qt, plan, as_bf16):
    """The kernel's launch under ``plan``, x rounded to bf16 first (as the
    wrapper does above 64 rows) or left in float32."""
    storage = qt.values if bits == 8 else qt.packed
    k, out = x.shape[1], storage.shape[1]
    y = torch.empty((x.shape[0], out), dtype=torch.float32, device=x.device)
    fn = quant._kernels()[0 if bits == 8 else 1]
    extra = () if bits == 8 else (qt.scale.shape[0],)

    def call():
        x2 = x.to(torch.bfloat16) if as_bf16 else x
        err = fn(x2.data_ptr(), int(as_bf16), storage.data_ptr(),
                 qt.scale.data_ptr(), y.data_ptr(), x.shape[0], k, out, *extra,
                 *plan.launch_args(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def sweep(quant, bits, gen) -> list:
    """M 512: the kernel's graph time under each plan of the grid."""
    quantize = quant.quantize if bits == 8 else quant.quantize4
    per = 1 if bits == 8 else 2
    out = []
    for k, n in quant_shapes():
        qt = quantize(torch.randn(k, n, generator=gen) * 0.05).to("cuda")
        x = torch.randn(512, k, generator=gen).to("cuda")
        base = quant.qdot_plan(512, k, n, bits)
        found = []
        for k_slice in (64 // per, 128 // per, 256 // per, 512 // per, 640 // per):
            if k_slice > k // per:
                continue
            for cluster in (1, 2, 3, 4, 6, 8):
                if cluster > -(-(k // per) // k_slice):
                    continue
                for m_chunk in (32, 64):
                    plan = base._replace(k_slice=k_slice, cluster=cluster,
                                         m_chunk=m_chunk)
                    try:
                        t = graph_ms(variant(quant, bits, x, qt, plan, True), 10)
                    except RuntimeError:  # a plan the C side refuses
                        continue
                    found.append((t, k_slice, cluster, m_chunk))
        found.sort()
        row = {"bits": bits, "k": k, "n": n,
               "default": graph_ms(lambda: (quant.qdot_w8a16_kernel if bits == 8
                                            else quant.qdot_w4a16_kernel)(x, qt), 10),
               "best": [dict(zip(("ms", "k_slice", "cluster", "m_chunk"), f))
                        for f in found[:3]]}
        print(f"  {row}", flush=True)
        out.append(row)
    return out


MEL_CASES = [  # sr, spec_time_step, min_frequency, seconds a clip (1000 frames)
    (32000, 0.0025, 0, 2.5), (64000, 0.0025, 0, 2.5), (128000, 0.0025, 0, 2.5),
    (256000, 0.0025, 0, 2.5), (400000, 0.0025, 0, 2.5),
    (300000, 0.0005, 35000, 0.5)]  # the mouse preset
CROSS_CASES = [  # name, B, S, H, Hkv, hd
    ("base", 16, 500, 8, 8, 64), ("tiny", 16, 500, 6, 6, 64),
    ("hd128", 16, 500, 4, 4, 128), ("GQA 8/2", 16, 500, 8, 2, 64),
    ("B 1", 1, 500, 8, 8, 64), ("ragged 301", 16, 301, 8, 8, 64)]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mel_cross():
    """(times, outputs) of K1 and K5 in this checkout."""
    import numpy as np

    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.ops import cross_attention as ca
    from whisperseg_torch.ops import logmel
    from whisperseg_torch.synthetic import tone_bursts

    times, outputs = [], {}
    for sr, step, fmin, seconds in MEL_CASES:
        fr = Frontend(sr, step, fmin)
        clips = torch.from_numpy(np.stack([tone_bursts(s, sr=sr, duration=seconds)
                                           for s in range(4)])).to("cuda")
        spectrum = fr.spectrum(clips)  # (re, im, mel[, bands]) as the checkout has it
        re, im, mel = spectrum[:3]
        name = f"melproject n_fft {fr.n_fft} sr {sr} fmin {fmin}"
        outputs[name] = logmel.melproject_reim(*spectrum).cpu()
        row = {"name": name,
               "kernel": graph_ms(lambda: logmel.melproject_reim(*spectrum), 50),
               "plain": graph_ms(lambda: logmel.melproject_reference(re, im, mel), 20),
               "frontend": cuda_ms(lambda: fr.features_for_clips(clips, 1000), 20)}
        times.append(row)
        print(f"  {row}", flush=True)
    for name, b, s, h, hkv, hd in CROSS_CASES:
        gen = torch.Generator(device="cpu").manual_seed(b * s + h * hkv + hd)
        q = torch.randn(b, h * hd, generator=gen).to("cuda")
        k = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to("cuda")
        v = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to("cuda")
        kq, ks, vq, vs, seq = ca.quantize_kv_for_kernel(k, v)
        args = (q, kq[0], ks[0], vq[0], vs[0], hkv, seq, h)
        name = f"cross_attention_int8 {name}"
        outputs[name] = ca.cross_attention_int8(*args).cpu()
        row = {"name": name,
               "kernel": graph_ms(lambda: ca.cross_attention_int8(*args), 50)}
        times.append(row)
        print(f"  {row}", flush=True)
    return times, outputs


# (text the clock read follows, phase that ends there) in
# csrc/cross_attention_int8.cu, in order
K5_MARKS = [
    ("  __syncthreads();\n#pragma unroll\n  for (int u = 0; u < kInFlight; ++u) {\n"
     "    const int i = u * kSlots + slot;\n    vv[u]", "q, K and k_scale loaded"),
    ("  __syncthreads();\n\n  // 2. the cluster's maximum", "scores (and V's loads issued)"),
    ("  mbar_wait(bars);\n", "local max, max exchange"),
    ("  mbar_wait(bars + 1);\n", "exponentials, sum exchange"),
    ("  mbar_wait(bars + 2);\n", "weights, P V, partial outputs sent"),
    ("    p.out[(long long)b * dq + (kh * G + g) * hd + d] = s;\n  }\n", "outputs received and added"),
]


def k5_phase_source(src: str) -> str:
    """csrc/cross_attention_int8.cu with the clock reads put in and a
    pointer to their buffer as the entry point's last argument."""
    src = src.replace("struct Params {", "struct Params {\n  long long* stamps;")
    src = src.replace(
        "template <int LANES>\n__global__",
        "__device__ __forceinline__ long long clock_ns() {\n  long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
        "#define STAMP(k) if (threadIdx.x == 0) p.stamps[((blockIdx.z * gridDim.y + "
        "blockIdx.y) * gridDim.x + blockIdx.x) * 8 + (k)] = clock_ns();\n"
        "template <int LANES>\n__global__")
    src = src.replace("  extern __shared__ float smem[];\n", "  STAMP(0)\n  extern __shared__ float smem[];\n", 1)
    for k, (mark, _) in enumerate(K5_MARKS, start=1):
        if mark not in src:
            raise RuntimeError(f"--k5-phases: the kernel no longer has {mark!r}")
        at = src.index(mark)
        if k in (1, 2):  # after a barrier: the clock read follows the barrier
            at += len("  __syncthreads();\n")
        elif k in (3, 4, 6):
            at += len(mark)
        src = src[:at] + f"  STAMP({k})\n" + src[at:]
    src = src.replace("cudaStream_t stream) {\n  if (batch <= 0",
                      "cudaStream_t stream, long long* stamps) {\n  if (batch <= 0")
    return src.replace("  p.inv_sqrt = inv_sqrt;\n", "  p.inv_sqrt = inv_sqrt;\n  p.stamps = stamps;\n")


def k5_phases() -> list:
    """Mean ns of each phase of the K5 kernel's blocks (a clock read by
    thread 0 of each block), at the base, B 1 and GQA 8/2 cases."""
    import ctypes

    from whisperseg_torch.ops import _build
    from whisperseg_torch.ops import cross_attention as ca

    with open(os.path.join(_build.CSRC, "cross_attention_int8.cu")) as f:
        src = k5_phase_source(f.read())
    path = os.path.join(_build.BUILD_DIR, "k5_phases.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib, path],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).ws_cross_attention_int8
    fn.argtypes = ca.ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for name, b, s, h, hkv, hd in [CROSS_CASES[0], CROSS_CASES[4], CROSS_CASES[3]]:
        gen = torch.Generator(device="cpu").manual_seed(0)
        q = torch.randn(b, h * hd, generator=gen).to("cuda")
        k = torch.randn(1, b, s, hkv, hd, generator=gen).to("cuda")
        v = torch.randn(1, b, s, hkv, hd, generator=gen).to("cuda")
        kq, ks, vq, vs, seq = ca.quantize_kv_for_kernel(k, v)
        plan = ca.cross_attention_plan(b, seq, hkv, h // hkv, hd)
        out = torch.empty_like(q)
        stamps = torch.zeros(plan.blocks * 8, dtype=torch.int64, device="cuda")
        for _ in range(3):  # the last launch's clock reads are kept
            err = fn(q.data_ptr(), kq[0].data_ptr(), ks[0].data_ptr(), vq[0].data_ptr(),
                     vs[0].data_ptr(), out.data_ptr(), b, s, seq, hkv, h // hkv, hd,
                     hd ** -0.5, *plan.launch_args(),
                     torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"--k5-phases: launch failed, CUDA error {err}")
        st = stamps.reshape(plan.blocks, 8)[:, :len(K5_MARKS) + 1].double().cpu()
        steps = (st[:, 1:] - st[:, :-1]).mean(0).tolist()
        row = {"name": f"cross_attention_int8 {name}", "blocks": plan.blocks,
               "block_ns": (st[:, -1] - st[:, 0]).mean().item(),
               "first_to_last_ns": (st[:, -1].max() - st[:, 0].min()).item(),
               "phases_ns": dict(zip([m for _, m in K5_MARKS], steps))}
        print(f"  {row}", flush=True)
        rows.append(row)
    return rows


def compare(a: str, b: str) -> int:
    """Largest |difference| between two files of outputs, output by output."""
    x, y = torch.load(a), torch.load(b)
    for name in x:
        diff = (x[name] - y[name]).abs().max().item() if name in y else None
        print(f"  {name}: max|{os.path.basename(a)} - {os.path.basename(b)}| "
              f"{diff}{' (bit-identical)' if name in y and torch.equal(x[name], y[name]) else ''}",
              flush=True)
    return 0


def main() -> int:
    if "compare" in OPTIONS:
        return compare(*OPTIONS["compare"].split(","))
    if not torch.cuda.is_available():
        print("chip_qdot_times: no CUDA device", file=sys.stderr)
        return 1
    from whisperseg_torch.ops import quant
    from whisperseg_torch.ops.dot import dot_f32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cpu").manual_seed(1)
    if K5_PHASES:
        print(json.dumps({"root": ROOT, "card": card, "times": k5_phases()}))
        return 0
    if MEL_CROSS:
        times, outputs = mel_cross()
        if "save" in OPTIONS:
            torch.save(outputs, OPTIONS["save"])
        print(json.dumps({"root": ROOT, "card": card, "times": times}))
        return 0
    if SWEEP:
        times = sweep(quant, 8, gen) + sweep(quant, 4, gen)
        print(json.dumps({"root": ROOT, "card": card, "times": times}))
        return 0
    times = []
    for bits in (8, 4):
        quantize = quant.quantize if bits == 8 else quant.quantize4
        kernel = quant.qdot_w8a16_kernel if bits == 8 else quant.qdot_w4a16_kernel
        cases = [(m, k, n) for m in (16, 48) for k, n in DECODE]
        if not DECODE_ONLY:
            cases += [(512, k, n) for k, n in quant_shapes()]
        for m, k, n in cases:
            qt = quantize(torch.randn(k, n, generator=gen) * 0.05).to("cuda")
            x = torch.randn(m, k, generator=gen).to("cuda")
            reps = 50 if m < 512 else 20
            row = {"bits": bits, "m": m, "k": k, "n": n,
                   "kernel": graph_ms(lambda: kernel(x, qt), reps)}
            if m == 512:
                row["route"] = graph_ms(lambda: dot_f32(
                    x, quant.dequantize(qt, torch.bfloat16), torch.bfloat16), reps)
                row["x_float32"] = graph_ms(variant(
                    quant, bits, x, qt, quant.qdot_plan(m, k, n, bits), False), reps)
            times.append(row)
            print("  " + " ".join(f"{key} {val:.4f}" if isinstance(val, float)
                                  else f"{key} {val}" for key, val in row.items()),
                  flush=True)
    print(json.dumps({"root": ROOT, "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
