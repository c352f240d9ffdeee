#!/usr/bin/env python3
"""Graph times of the port's w8a16 / w4a16 kernels (K3 / K4) on one NVIDIA
GPU, for the checkout at ROOT (default: the directory of this script):

    python3 chip_qdot_times.py [ROOT] [--sweep | --decode]

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_qdot_times: no CUDA device", file=sys.stderr)
        return 1
    from whisperseg_torch.ops import quant
    from whisperseg_torch.ops.dot import dot_f32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cpu").manual_seed(1)
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
