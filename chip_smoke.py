#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisperseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout. It builds the port's CUDA kernels from
``whisperseg_torch/csrc`` (one ``nvcc`` per source, all started together) and
then runs, in order:

  1. setup: the card's name and power limit, the torch version, the build time,
     the encoder attention's and the quantized products' registers and spills
     (``nvcc -Xptxas -v``), and the per-launch floor (one trivial launch
     replayed from a CUDA graph);
  2. kernels: each kernel against its plain PyTorch version on the card at the
     main path's shapes (the mel kernel also at every n_fft, the encoder
     attention at eight shapes, in bf16 also against the plain model of its
     own walk and bit-identical on a second call, the quantized products at
     every projection shape of every model size and at ragged shapes, each
     called twice and required bit-identical), with the kernel's time (also
     replayed from a CUDA graph), the plain version's, one library call's as
     a yardstick where there is one (and for the encoder attention, SDPA's
     time replayed from a CUDA graph with a boolean and an additive mask,
     and the backend that ran), and the least time the card could take for
     the same work; the quantized products' graph times at the base model's
     decode shapes and their sum over a decoder step beside its bound, and
     at M 512 beside the large-M route (dequantize, then one matmul); the
     encoder attention's two backward kernels (dK/dV, dQ) against the plain
     backward at seven shapes, bit-identical on a second run, with a
     finite-difference spot check; then the device memory still allocated,
     before and after cuBLAS's workspaces (the yardsticks') are freed;
  3. golden: the shipped tiny checkpoint at float32 on the card must give the
     JAX package's segment table (whisperseg_torch/golden_tiny.json);
  4. serve: one ``Segmenter`` on the shipped base checkpoint (bfloat16 as
     shipped, default arguments: beam 4 and the checkpoint's
     post-processing) answers synthetic requests, each table printed as one
     JSON line (``whisperseg_torch/card_tables_bf16.json`` records them);
     every batch must launch the mel kernel once and the attention kernel
     once per encoder layer;
  5. quantized serve: the same checkpoint as ``inference_dtype="int8"``, as
     ``"int4"``, and as ``"int8"`` with ``int8_kv=True`` answers two of those
     requests each; besides the above, every decoder step must launch the
     w8a16 (or w4a16) kernel 8 times per decoder layer, and every
     single-token step the int8 cross-attention kernel once per layer;
  6. profile: one more request, in bfloat16 and then in int8 with
     ``int8_kv``, timed stage by stage, then under ``torch.profiler``: the
     device's busy share and its time by kernel;
  7. train: ``python -m whisperseg_torch.cli.train``'s ``main`` trains the
     base checkpoint at full width (bf16 compute, float32 master weights,
     AdamW, the CLI's default frame head) for 30 steps on a synthetic tone
     dataset, 3 of them profiled; every step must launch the attention
     kernel (writing the row log-sum-exp) and each backward kernel once per
     encoder layer, every batch the
     mel kernel once, and the loss must fall; then 5 steps with dropout and
     remat (the attention kernel twice per layer), and the trained
     checkpoint answers one request.

The last three lines of its output are the kernels' JSON record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. A failed phase
raises, and the script then exits non-zero without them. Without CUDA it
exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 32000
SPEC_TIME_STEP = 0.0025
BATCH = 4                      # Segmenter.segment()'s default batch_size
SP, VALID, HD = 512, 500, 64   # encoder rows padded to 512, 500 of them real

DECODE_ROWS = 16               # batch 4 x beam 4: the rows of a decode step

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s by operand type (bf16 on the tensor cores, float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (serve) seed, seconds of audio and num_trials of each request. The shipped
# base model's trials disagree on most tone bursts (DBSCAN keeps about 1 in 8
# of their segments), so the multi-trial requests use seeds whose consolidated
# tables are not empty in the JAX package's bf16 numerics either:
# ``python tests/test_torch_segmenter.py --bf16-serve`` prints both packages'
# tables for these requests.
REQUESTS = [(100, 2.5, 1), (106, 10.0, 3), (101, 30.0, 1), (100, 30.0, 3)]
QUANT_REQUESTS = REQUESTS[1:3]  # those each quantized mode answers


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls replayed from one CUDA
    graph: the device's own time, with no host dispatch between launches.
    One call before the capture sets up what a library allocates at its
    first call (cuDNN's plans and workspace)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """Least time in ms for ``nbytes`` of device memory traffic and ``flops``
    operations of ``dtype``, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def launch_floor_ms() -> float:
    """Graph time of one trivial launch (an in-place add on one element):
    what any kernel launch costs the device at least."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(1.0), 100)


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})


def sdpa_backend(kernels: list) -> str:
    """Which backend of scaled_dot_product_attention ran, by its kernels'
    names."""
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "memory-efficient"),
                         ("efficient_attention", "memory-efficient")):
        if key in names:
            return f"{backend} ({len(kernels)} kernels)"
    return f"math ({len(kernels)} kernels: matmuls, softmax, elementwise)"


def ptxas_summary(log: str, key: str) -> list:
    """(kernel, registers, spill stores + loads in bytes, static shared
    memory in bytes) of each entry function of an ``nvcc -Xptxas -v`` log
    whose mangled name holds ``key``."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name, spill = entry.group(1), 0
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and name:
            spill = int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name and key in name:
            # <kernel>ILi<n>E[<f | 13__nv_bfloat16>]E: kernel<n[, type]>
            short = re.search(rf"({key}[a-z_]*)ILi(\d+)E(f|13__nv_bfloat16)?E", name)
            kind = {"f": ", float", "13__nv_bfloat16": ", bf16", None: ""}
            label = (f"{short.group(1)}<{short.group(2)}{kind[short.group(3)]}>"
                     if short else name)
            rows.append((label, int(used.group(1)), spill, int(used.group(2) or 0)))
            name = None
    return rows


# ------------------------------------------------------------------ kernels


def check_melproject(device) -> dict:
    """K1 against its plain version for every n_fft (4 clips of 1000 frames,
    on the spectra the frontend feeds it); returns the main path's row
    (32 kHz, n_fft 512)."""
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.ops import logmel
    from whisperseg_torch.synthetic import tone_bursts

    row = None
    for sr in (32000, 64000, 128000, 256000, 400000):
        fr = Frontend(sr, SPEC_TIME_STEP)
        clips = np.stack([tone_bursts(s, sr=sr, duration=2.5) for s in range(BATCH)])
        re, im, mel = fr.spectrum(torch.from_numpy(clips).to(device))
        got = logmel.melproject_reim(re, im, mel)
        want = logmel.melproject_reference(re, im, mel)
        err = (got - want).abs().max().item()
        b, n_freq, frames = re.shape
        n_mel = mel.shape[1]
        ms = cuda_ms(lambda: logmel.melproject_reim(re, im, mel), 50)
        in_graph = graph_ms(lambda: logmel.melproject_reim(re, im, mel), 50)
        plain_ms = cuda_ms(lambda: logmel.melproject_reference(re, im, mel), 20)
        nbytes = 4 * (2 * b * n_freq * frames + n_freq * n_mel + b * n_mel * frames)
        flops = b * frames * n_freq * (3 + 2 * n_mel)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        print(f"  melproject n_fft {fr.n_fft:5d} [{b}, {n_freq}, {frames}]: "
              f"max|err| {err:.2e} (tol 2e-5)  kernel {ms:.4f} ms (graph "
              f"{in_graph:.4f} ms)  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by})",
              flush=True)
        if not err <= 2e-5:
            raise AssertionError(f"melproject n_fft {fr.n_fft}: max|err| {err}")
        if sr == SR:
            row = {"name": "melproject", "route": "cuda",
                   "source": "whisperseg_torch/csrc/melproject.cu",
                   "replaces": "whisperseg_tpu/ops/logmel_pallas.py:66",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   # no single PyTorch call computes power -> mel -> log10
                   "library_ms": None}
    return row


ATTENTION_CASES = [  # name, B, H, Hkv, hd, dtype, valid keys; Sp 512
    ("base bf16", BATCH, 8, 8, HD, torch.bfloat16, VALID),
    ("base f32", BATCH, 8, 8, HD, torch.float32, VALID),
    ("tiny bf16", BATCH, 6, 6, HD, torch.bfloat16, VALID),
    ("GQA 8/2 bf16", BATCH, 8, 2, HD, torch.bfloat16, VALID),
    ("hd128 bf16", BATCH, 4, 4, 128, torch.bfloat16, VALID),
    ("hd128 f32", BATCH, 4, 4, 128, torch.float32, VALID),
    ("B 1 bf16", 1, 8, 8, HD, torch.bfloat16, VALID),
    # a short clip: key tiles 5-7 wholly masked, tile 4 cut at an odd key
    ("301 valid bf16", 2, 8, 2, 128, torch.bfloat16, 301),
]


def check_attention(device) -> list:
    """K2 against its plain version (float32: 2e-5 absolute, lse 1e-5;
    bf16: 2 % of the largest output, lse 1e-2) at the encoder's shapes, with
    and without the row log-sum-exp (the same output, bit for bit); in bf16
    also against the plain model of its own walk
    (``attention_hm_tiled_reference``: 1e-3 of the largest output) and
    bit-identical on a second call. Prints each case's graph time. Returns
    the main path's rows (base model, bf16): K2, and K2's launch that also
    writes the row log-sum-exp (training's, the port of the flash
    forward)."""
    from whisperseg_torch.ops import attention

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for name, b, h, hkv, hd, dtype, valid in ATTENTION_CASES:
        keep = (torch.arange(SP, device=device) < valid)[None, None, None, :]

        def rand(*shape):
            x = torch.randn(*shape, generator=gen) * 0.5
            return x.to(device=device, dtype=dtype)
        q, kt, v = rand(b, h, SP, hd), rand(b, hkv, hd, SP), rand(b, hkv, SP, hd)
        full = attention.fused_attention_head_major(valid, q, kt, v)
        again = attention.fused_attention_head_major(valid, q, kt, v)
        got = full[:, :, :valid].float()
        want, want_lse = attention.attention_hm_reference(valid, q, kt, v,
                                                          with_lse=True)
        want = want[:, :, :valid].float()
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        # training's launch: the same output, bit for bit, and the row
        # log-sum-exp (bf16: p is rounded against the running maximum, so
        # the sum of rounded weights may differ by a few parts in 1e3)
        o_lse, lse = attention.fused_attention_head_major(valid, q, kt, v,
                                                          with_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        if dtype == torch.float32:
            ok, tol = err <= 2e-5 and lse_err <= 1e-5, "2e-5; lse 1e-5"
            walk = ""
        else:
            # the kernel's own order of roundings: the same p and l up to
            # float32 sums taken in another order. That can put an output on
            # the other side of a bf16 rounding boundary (one unit in the
            # last place: up to 2^-7 of it, above 1e-3 of max|out|) or a
            # weight p (2^-8 of that weight, a few 1e-5 of max|out| here). So
            # each output is held within one bf16 ulp of the walk's plus
            # 1e-3 of max|out|, and the row log-sum-exp within 1e-4 (the
            # plain version's, which rounds p against the final max, departs
            # from the walk's by some 5e-4 at these shapes)
            tiled, tiled_lse = attention.attention_hm_tiled_reference(
                valid, q, kt, v, with_lse=True)
            ref = tiled[:, :, :valid].float()
            ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
            gap = (got - ref).abs()
            beyond = (gap - ulp).clamp(min=0).max().item()
            walk_lse = (lse - tiled_lse).abs().max().item()
            same = torch.equal(again, full)
            ok = (err <= 0.02 * top and lse_err <= 1e-2 and beyond <= 1e-3 * top
                  and walk_lse <= 1e-4 and same)
            tol = "2% of max|out|; lse 1e-2"
            walk = (f"; its own walk: {gap.max().item() / top:.1e} of "
                    f"max|out|, beyond one ulp {beyond / top:.1e} (tol 1e-3), "
                    f"{100 * (gap > 0).float().mean().item():.3f} % of outputs "
                    f"differ, lse {walk_lse:.1e} (tol 1e-4); second call "
                    f"{'identical' if same else 'DIFFERS'}")
        ok = ok and torch.equal(o_lse, full)
        # the library's yardstick takes K with contiguous rows (on K as K2
        # takes it, transposed, SDPA falls back to its math path) and the key
        # mask as an additive float mask, which cuDNN's kernel reads; both
        # made before the timed call
        k = kt.transpose(-1, -2)
        k_rows = k.contiguous()
        additive = torch.zeros(SP, dtype=dtype, device=device)
        additive[valid:] = float("-inf")
        additive = additive[None, None, None, :]
        ms = cuda_ms(lambda: attention.fused_attention_head_major(valid, q, kt, v), 50)
        in_graph = graph_ms(lambda: attention.fused_attention_head_major(
            valid, q, kt, v), 50)
        plain_ms = cuda_ms(lambda: attention.attention_hm_reference(valid, q, kt, v), 20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k_rows, v, attn_mask=additive, enable_gqa=h != hkv), 50)
        item = q.element_size()
        nbytes = item * (2 * q.numel() + kt.numel() + v.numel())
        flops = 4 * b * h * SP * valid * hd
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        print(f"  attention {name:14s} [{b}, {h}/{hkv}, {SP}, {hd}] valid "
              f"{valid}: max|err| {err:.2e}, lse {lse_err:.1e} (tol {tol})"
              f"{walk}\n    kernel {ms:.4f} ms (graph {in_graph:.4f} ms)  "
              f"plain {plain_ms:.4f} ms  sdpa (K contiguous, additive mask) "
              f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        if not ok:
            raise AssertionError(f"attention {name}: max|err| {err}, lse "
                                 f"{lse_err}, {walk}, output with lse "
                                 f"identical: {torch.equal(o_lse, full)}")
        if name == "base bf16":
            def launch(with_lse):
                return lambda: attention.fused_attention_head_major(
                    VALID, q, kt, v, with_lse=with_lse)
            lse_ms = cuda_ms(launch(True), 50)
            lse_plain_ms = cuda_ms(lambda: attention.attention_hm_reference(
                VALID, q, kt, v, with_lse=True), 20)
            print(f"    note: training's launch, with the row log-sum-exp: "
                  f"{lse_ms:.4f} ms (plain {lse_plain_ms:.4f} ms); replayed "
                  f"from a CUDA graph: {in_graph:.4f} ms without it, "
                  f"{graph_ms(launch(True), 50):.4f} ms with it", flush=True)
            # the yardstick on the device's own clock: SDPA with the boolean
            # key mask and with an additive float mask, on K as K2 takes it
            # (transposed, so K's rows are strided) and on a contiguous copy,
            # and the backend whose kernels ran
            for k_label, k_in in (("k strided", k), ("k contiguous", k_rows)):
                for label, mask in (("boolean", keep), ("additive float", additive)):
                    def sdpa(mask=mask, k_in=k_in):
                        return F.scaled_dot_product_attention(q, k_in, v,
                                                              attn_mask=mask)
                    print(f"    sdpa, {k_label}, {label} key mask: "
                          f"{graph_ms(sdpa, 50):.4f} ms replayed from a CUDA "
                          f"graph (K2: the line above); backend "
                          f"{sdpa_backend(device_kernels(sdpa))}", flush=True)
            # one library call that also returns the row log-sum-exp:
            # cuDNN's attention forward, as SDPA runs it on contiguous K
            def cudnn_lse():
                return torch.ops.aten._scaled_dot_product_cudnn_attention(
                    q, k_rows, v, additive, True, 0.0, False, False)[:2]
            lib_o, lib_lse = cudnn_lse()
            lib_err = max(
                (lib_o[:, :, :VALID].float() - want).abs().max().item(),
                (lib_lse.reshape(lse.shape) - want_lse)[:, :, :VALID]
                .abs().max().item())
            lse_library_ms = cuda_ms(cudnn_lse, 50)
            print(f"    note: aten._scaled_dot_product_cudnn_attention with the "
                  f"log-sum-exp: {lse_library_ms:.4f} ms ({graph_ms(cudnn_lse, 50):.4f}"
                  f" ms replayed from a CUDA graph); output and log-sum-exp "
                  f"within {lib_err:.1e} of the plain version's", flush=True)
            lse_bound = bound(nbytes + 4 * lse.numel(), flops, dtype)
            rows = [{"name": "attention_hm", "route": "cuda",
                     "source": "whisperseg_torch/csrc/attention.cu",
                     "replaces": "whisperseg_tpu/ops/attention.py:86",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms},
                    {"name": "attention_hm_lse", "route": "cuda",
                     "source": "whisperseg_torch/csrc/attention.cu",
                     "replaces": "jax/experimental/pallas/ops/tpu/"
                                 "flash_attention.py:758",
                     "max_abs_err": max(err, lse_err), "ms": lse_ms,
                     "plain_ms": lse_plain_ms, "bound_ms": lse_bound[0],
                     "bound_by": lse_bound[1], "library_ms": lse_library_ms}]
    return rows


ATTENTION_BWD_CASES = [  # name, B, H, Hkv, hd, dtype, valid keys; Sp 512
    ("base bf16", BATCH, 8, 8, HD, torch.bfloat16, VALID),
    ("base f32", BATCH, 8, 8, HD, torch.float32, VALID),
    ("tiny bf16", BATCH, 6, 6, HD, torch.bfloat16, VALID),
    ("GQA 8/2 bf16", BATCH, 8, 2, HD, torch.bfloat16, VALID),
    ("hd128 bf16", BATCH, 4, 4, 128, torch.bfloat16, VALID),
    ("B 1 bf16", 1, 8, 8, HD, torch.bfloat16, VALID),
    # a short clip: key tiles 5-7 wholly masked, tile 4 cut at an odd key
    ("301 valid bf16", 2, 8, 2, 128, torch.bfloat16, 301),
]


def finite_difference_check(device) -> float:
    """Float32 spot check of the two backward kernels against central
    differences of sum(o * dO) (float64 sums) at B 1, H 2, Sp 128, 100 valid
    keys, for entries of q, K and V, one of them a masked key. Returns the
    largest gap as a share of the largest gradient; raises above 1e-2."""
    from whisperseg_torch.ops import attention as att

    gen = torch.Generator(device="cpu").manual_seed(11)
    sp, valid, eps = 128, 100, 1e-2
    q, kt, v = (torch.randn(*s, generator=gen).mul(0.5).to(device)
                for s in ((1, 2, sp, HD), (1, 2, HD, sp), (1, 2, sp, HD)))
    do = torch.randn(1, 2, sp, HD, generator=gen).to(device)
    do[:, :, valid:] = 0

    def loss(q_, kt_, v_):
        o = att.fused_attention_head_major(valid, q_, kt_, v_)
        return (o.double() * do.double()).sum().item()

    o, lse = att.fused_attention_head_major(valid, q, kt, v, with_lse=True)
    grads = att.attention_hm_backward(valid, q, kt, v, o, do, lse)
    top = max(g.abs().max().item() for g in grads)
    worst = 0.0
    for which, idx in ((0, (0, 0, 5, 3)), (0, (0, 1, 99, 60)), (1, (0, 1, 7, 20)),
                       (1, (0, 0, 3, 110)), (2, (0, 0, 30, 11)), (2, (0, 1, 0, 63))):
        args = [q, kt, v]
        plus, minus = [a.clone() for a in args], [a.clone() for a in args]
        plus[which][idx] += eps
        minus[which][idx] -= eps
        fd = (loss(*plus) - loss(*minus)) / (2 * eps)
        worst = max(worst, abs(fd - grads[which][idx].item()) / top)
    print(f"  finite differences (f32, 6 entries, one a masked key): largest "
          f"gap {worst:.2e} of max|grad| (tol 1e-2)", flush=True)
    if not worst <= 1e-2:
        raise AssertionError(f"finite-difference gap {worst} of max|grad|")
    return worst


def check_attention_backward(device) -> list:
    """The dK/dV and dQ kernels against the plain backward on the same
    inputs (float32: 1e-4 of the largest gradient; bf16: 1e-2), at the
    encoder's shapes with the padded keys' K/V poisoned (their dK and dV must
    be exactly 0) and dO zero on padded rows, as the encoder's slice leaves
    it; two runs must agree bit for bit. Times each kernel, the plain
    backward, and scaled_dot_product_attention's backward (autograd, boolean
    key mask, forward excluded). Returns the main path's rows (base, bf16)."""
    from whisperseg_torch.ops import attention as att

    gen = torch.Generator(device="cpu").manual_seed(3)
    rows = []
    for name, b, h, hkv, hd, dtype, valid in ATTENTION_BWD_CASES:
        keep = (torch.arange(SP, device=device) < valid)[None, None, None, :]
        def rand(*shape):
            x = torch.randn(*shape, generator=gen) * 0.5
            return x.to(device=device, dtype=dtype)
        q, kt, v = rand(b, h, SP, hd), rand(b, hkv, hd, SP), rand(b, hkv, SP, hd)
        kt[..., valid:] = 3e4  # poisoned padded keys
        v[:, :, valid:] = -3e4
        o, lse = att.fused_attention_head_major(valid, q, kt, v, with_lse=True)
        do = rand(b, h, SP, hd)
        do[:, :, valid:] = 0
        delta = att._delta(o, do)
        dkt, dv = att.attention_hm_bwd_dkv(valid, q, kt, v, do, lse, delta)
        dq = att.attention_hm_bwd_dq(valid, q, kt, v, do, lse, delta)
        again = (*att.attention_hm_bwd_dkv(valid, q, kt, v, do, lse, delta),
                 att.attention_hm_bwd_dq(valid, q, kt, v, do, lse, delta))
        want = att._backward_plain(valid, q, kt, v, do, lse, delta)
        abs_errs = [(got.float() - ref.float()).abs().max().item()
                    for got, ref in zip((dq, dkt, dv), want)]
        errs = [e / ref.float().abs().max().item()
                for e, ref in zip(abs_errs, want)]
        padded = max(dkt[..., valid:].abs().max().item(),
                     dv[:, :, valid:].abs().max().item())
        same = all(torch.equal(x, y) for x, y in zip((dkt, dv, dq), again))
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        dkv_ms = cuda_ms(lambda: att.attention_hm_bwd_dkv(valid, q, kt, v, do, lse, delta), 30)
        dq_ms = cuda_ms(lambda: att.attention_hm_bwd_dq(valid, q, kt, v, do, lse, delta), 30)
        whole_ms = cuda_ms(lambda: att.attention_hm_backward(valid, q, kt, v, o, do, lse), 30)
        plain_ms = cuda_ms(lambda: att._backward_plain(valid, q, kt, v, do, lse, delta), 10)
        qs, ks, vs = (t.detach().clone().requires_grad_()
                      for t in (q, kt.transpose(-1, -2).contiguous(), v))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep,
                                             enable_gqa=h != hkv)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), 30)
        item = q.element_size()
        products = 2 * b * h * SP * valid * hd
        ins = item * (q.numel() + kt.numel() + v.numel() + do.numel()) + 8 * lse.numel()
        dkv_bound = bound(ins + item * (kt.numel() + v.numel()), 4 * products, dtype)
        dq_bound = bound(ins + item * q.numel(), 3 * products, dtype)
        whole_bound = bound(item * (2 * q.numel() + 2 * kt.numel() + 2 * v.numel()
                                    + 2 * q.numel()) + 4 * lse.numel(),
                            5 * products, dtype)
        print(f"  attention backward {name:12s} [{b}, {h}/{hkv}, {SP}, {hd}]: "
              f"max|err| dq {errs[0]:.1e} dk {errs[1]:.1e} dv {errs[2]:.1e} of "
              f"max|grad| (tol {tol:g}); padded keys' dK/dV max {padded:g} "
              f"(must be 0); two runs {'identical' if same else 'DIFFER'}\n"
              f"    dkv {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f}, "
              f"{dkv_bound[1]})  dq {dq_ms:.4f} ms (bound {dq_bound[0]:.4f}, "
              f"{dq_bound[1]})  whole backward with D {whole_ms:.4f} ms "
              f"(bound {whole_bound[0]:.4f}, {whole_bound[1]})  plain "
              f"{plain_ms:.4f} ms  sdpa backward {library_ms:.4f} ms",
              flush=True)
        if not (max(errs) <= tol and padded == 0.0 and same):
            raise AssertionError(f"attention backward {name}: errors {errs}, "
                                 f"padded {padded}, identical {same}")
        if name == "base bf16":
            dkv_graph = graph_ms(lambda: att.attention_hm_bwd_dkv(
                valid, q, kt, v, do, lse, delta), 20)
            dq_graph = graph_ms(lambda: att.attention_hm_bwd_dq(
                valid, q, kt, v, do, lse, delta), 20)
            print(f"    note: replayed from a CUDA graph: dkv {dkv_graph:.4f} ms,"
                  f" dq {dq_graph:.4f} ms; share of bound: dkv "
                  f"{100 * dkv_bound[0] / dkv_graph:.1f} %, dq "
                  f"{100 * dq_bound[0] / dq_graph:.1f} % (graph; "
                  f"{100 * dkv_bound[0] / dkv_ms:.1f} %, "
                  f"{100 * dq_bound[0] / dq_ms:.1f} % launched from Python); "
                  f"dkv + dq against the sdpa backward, which covers both "
                  f"kernels' work: {(dkv_ms + dq_ms) / library_ms:.3f}x",
                  flush=True)
            source = "whisperseg_torch/csrc/attention_bwd.cu"
            flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
            rows = [
                {"name": "attention_hm_bwd_dkv", "route": "cuda", "source": source,
                 "replaces": f"{flash}:1121", "max_abs_err": max(abs_errs[1:]),
                 "ms": dkv_ms, "plain_ms": plain_ms, "bound_ms": dkv_bound[0],
                 "bound_by": dkv_bound[1], "library_ms": library_ms},
                {"name": "attention_hm_bwd_dq", "route": "cuda", "source": source,
                 "replaces": f"{flash}:1456", "max_abs_err": abs_errs[0],
                 "ms": dq_ms, "plain_ms": plain_ms, "bound_ms": dq_bound[0],
                 "bound_by": dq_bound[1], "library_ms": library_ms}]
    finite_difference_check(device)
    return rows


def quant_shapes():
    """(K, out) of every quantized projection of every model size (d_model
    384 to 1280, d_ff = 4 d_model), and out = 640, whose tail columns a
    tiled kernel can leave unwritten."""
    shapes = []
    for d in (384, 512, 768, 1024, 1280):
        shapes += [(d, d), (d, 4 * d), (4 * d, d)]
    return shapes + [(512, 640)]


QUANT_ROWS = (1, DECODE_ROWS, 48, 512)  # M: one row, a decode step, the prefill
# (M, K, out) that no model has and the kernels take: K not a multiple of 16,
# out not a multiple of 16, out below one column tile
QUANT_RAGGED = [(5, 384, 96), (2, 100, 40), (1, 64, 6), (7, 130, 33)]
# (K, out, products a decoder layer) of the base model's decoder: q, k, v, o,
# xq, xo; fc1; fc2
DECODE_PRODUCTS = [(512, 512, 6), (512, 2048, 1), (2048, 512, 1)]
DECODER_LAYERS = 6


def qdot_library_call(bits: int, x, qt):
    """(name, call): one PyTorch call computing K3's (K4's) function on the
    same weights, as a yardstick: ``torch._weight_int8pack_mm`` (int8
    [out, K], bf16 scales) or ``torch._weight_int4pack_mm`` (unsigned
    nibbles q + 8 packed by ``_convert_weight_to_int4pack``, bf16 scales with
    zero points 0). Both take x in bf16 and give bf16; their roundings are
    their own."""
    from whisperseg_torch.ops import quant

    xb = x.to(torch.bfloat16)
    if bits == 8:
        w = qt.values.t().contiguous()
        scale = qt.scale[0].to(torch.bfloat16)
        return "_weight_int8pack_mm", lambda: torch._weight_int8pack_mm(xb, w, scale)
    k, groups = 2 * qt.packed.shape[0], qt.scale.shape[0]
    u = (quant._nibbles(qt.packed).to(torch.int32) + 8).t().contiguous()
    packed = torch._convert_weight_to_int4pack(
        (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    zeros = torch.stack([qt.scale, torch.zeros_like(qt.scale)], dim=-1)
    zeros = zeros.to(torch.bfloat16).contiguous()
    return "_weight_int4pack_mm", lambda: torch._weight_int4pack_mm(
        xb, packed, k // groups, zeros)


def check_qdot(device, bits: int, floor_ms: float) -> dict:
    """K3 (bits 8) or K4 (bits 4) against its plain version at every
    projection shape and M = 1, 16 (a decode step), 48 (the prefill) and
    512, and at the ragged shapes. Kernel and plain version round alike and
    differ in the order of a float32 sum: held to 1e-3 of the largest
    output; a second call must give the same bits. Then the graph times of
    the base model's decode products at M 16 and 48 and their sum over a
    decoder step, beside its bound and the per-launch floor. Returns the main
    path's row (base model, one decode step: M 16, K 512, out 512)."""
    from whisperseg_torch.ops import quant
    from whisperseg_torch.ops.dot import dot_f32

    if bits == 8:
        name, quantize = "qdot_w8a16", quant.quantize
        kernel, plain = quant.qdot_w8a16_kernel, quant.qdot_w8a16_reference
        replaces = "whisperseg_tpu/ops/quant.py:254"
    else:
        name, quantize = "qdot_w4a16", quant.quantize4
        kernel, plain = quant.qdot_w4a16_kernel, quant.qdot_w4a16_reference
        replaces = "whisperseg_tpu/ops/quant.py:312"
    gen = torch.Generator(device="cpu").manual_seed(bits)
    weights = {}

    def weight(k, out):
        if (k, out) not in weights:
            w = torch.randn(k, out, generator=gen) * 0.05
            w = w * torch.exp(torch.randn(out, generator=gen))  # uneven columns
            weights[(k, out)] = quantize(w).to(device)
        return weights[(k, out)]

    def nbytes(qt, x, out):
        storage = qt.values if bits == 8 else qt.packed
        return (storage.numel() + 4 * qt.scale.numel()
                + x.element_size() * x.numel() + 4 * x.shape[0] * out)

    row, worst = None, 0.0
    cases = [(m, k, out) for k, out in quant_shapes() for m in QUANT_ROWS]
    for m, k, out in cases + QUANT_RAGGED:
        qt = weight(k, out)
        x = torch.randn(m, k, generator=gen).to(device)
        got, again, want = kernel(x, qt), kernel(x, qt), plain(x, qt)
        same = torch.equal(got, again)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        worst = max(worst, err / top)
        main = (m, k, out) == (DECODE_ROWS, 512, 512)
        ms = cuda_ms(lambda: kernel(x, qt), 50 if main else 10)
        plain_ms = cuda_ms(lambda: plain(x, qt), 20 if main else 5)
        bound_ms, bound_by = bound(nbytes(qt, x, out), 2 * m * k * out,
                                   torch.bfloat16)
        plan = quant.qdot_plan(m, k, out, bits)
        print(f"  {name} M {m:3d} K {k:4d} out {out:4d}: max|err| {err:.2e} "
              f"({err / top:.1e} of max|out|, tol 1e-3), second call "
              f"{'identical' if same else 'DIFFERS'}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})"
              f"  {plan.blocks} blocks, cluster {plan.cluster}", flush=True)
        if not (err <= 1e-3 * top and same):
            raise AssertionError(f"{name} M {m} K {k} out {out}: max|err| "
                                 f"{err} against max|out| {top}, second call "
                                 f"identical: {same}")
        if main:
            deq_ms = cuda_ms(lambda: dot_f32(
                x, quant.dequantize(qt, torch.bfloat16), torch.bfloat16), 20)
            lib_name, library = qdot_library_call(bits, x, qt)
            lib_err = (library().float() - want).abs().max().item()
            library_ms = cuda_ms(library, 50)
            print(f"    note: replayed from a CUDA graph: kernel "
                  f"{graph_ms(lambda: kernel(x, qt), 50):.4f} ms, "
                  f"{lib_name} {graph_ms(library, 50):.4f} "
                  f"ms (launched from Python {library_ms:.4f} ms; bf16 output, "
                  f"{lib_err / top:.1e} of max|out| from the plain version); "
                  f"dequantize to bf16, then torch.mm: {deq_ms:.4f} ms "
                  f"(several launches)", flush=True)
            row = {"name": name, "route": "cuda",
                   "source": "whisperseg_torch/csrc/qdot.cu",
                   "replaces": replaces, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
    print(f"  {name}: largest error over all shapes {worst:.1e} of max|out|",
          flush=True)

    for m in (DECODE_ROWS, 48):
        step_ms = step_bytes = weight_bytes = 0.0
        for k, out, count in DECODE_PRODUCTS:
            qt = weight(k, out)
            x = torch.randn(m, k, generator=gen).to(device)
            t = graph_ms(lambda: kernel(x, qt), 50)
            b = nbytes(qt, x, out)
            weight_bytes += DECODER_LAYERS * count * (b - 4 * m * (k + out))
            share = bound(b, 2 * m * k * out, torch.bfloat16)[0] / t
            print(f"    graph M {m} K {k:4d} out {out:4d}: {t:.4f} ms "
                  f"({100 * share:.1f} % of its bound; "
                  f"{quant.qdot_plan(m, k, out, bits).blocks} blocks)", flush=True)
            step_ms += DECODER_LAYERS * count * t
            step_bytes += DECODER_LAYERS * count * b
        launches = DECODER_LAYERS * sum(c for _, _, c in DECODE_PRODUCTS)
        print(f"    a decoder step's {launches} products at M {m}: {step_ms:.4f} "
              f"ms replayed from CUDA graphs; bound {step_bytes / 1e6:.2f} MB "
              f"at 3.35 TB/s = {bound(step_bytes, 0, torch.bfloat16)[0]:.5f} "
              f"ms (the weights and scales alone {weight_bytes / 1e6:.2f} MB, "
              f"{bound(weight_bytes, 0, torch.bfloat16)[0]:.5f} ms); {launches} "
              f"launches at the per-launch floor {launches * floor_ms:.4f} ms",
              flush=True)

    # M 512 (a one-window batch's encoder: 500 rows padded to 512), x float32
    # as the encoder gives it: the kernel against the route the port takes
    # above MAX_KERNEL_ROWS rows (dequantize to bf16, then one matmul)
    for k, out in quant_shapes():
        qt = weight(k, out)
        x = torch.randn(512, k, generator=gen).to(device)
        t = graph_ms(lambda: kernel(x, qt), 20)
        r = graph_ms(lambda: dot_f32(x, quant.dequantize(qt, torch.bfloat16),
                                     torch.bfloat16), 20)
        plan = quant.qdot_plan(512, k, out, bits)
        print(f"    graph M 512 K {k:4d} out {out:4d}: kernel {t:.4f} ms, "
              f"dequantize + matmul {r:.4f} ms ({t / r:.2f}x); {plan.blocks} "
              f"blocks: {plan.chunks} chunks of {plan.m_chunk} rows, cluster "
              f"{plan.cluster}, {plan.pieces} pieces", flush=True)
    return row


CROSS_ATTENTION_CASES = [  # name, B, S, H, Hkv, hd
    ("base", DECODE_ROWS, VALID, 8, 8, HD),
    ("tiny", DECODE_ROWS, VALID, 6, 6, HD),
    ("hd128", DECODE_ROWS, VALID, 4, 4, 128),
    ("GQA 8/2", DECODE_ROWS, VALID, 8, 2, HD),
    ("B 1", 1, VALID, 8, 8, HD),
]


def check_cross_attention(device) -> dict:
    """K5 against its plain version (same roundings, another order of sums,
    and weights that land on the other side of a bf16 tie: 1e-3 of the
    largest output), against exact attention on the unquantized K/V (2 % of
    the largest output, the JAX package's tolerance), and with a poisoned
    tail beyond seq_len (1e-5). Returns the main path's row (base)."""
    from whisperseg_torch.ops import cross_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(5)
    row = None
    for name, b, s, h, hkv, hd in CROSS_ATTENTION_CASES:
        q = torch.randn(b, h * hd, generator=gen).to(device)
        k = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to(device)
        v = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to(device)
        kq, ks, vq, vs, seq = ca.quantize_kv_for_kernel(k, v)
        args = (kq[0], ks[0], vq[0], vs[0], hkv, seq, h)
        got = ca.cross_attention_int8(q, *args)
        want = ca.cross_attention_int8_reference(q, *args)
        qh = q.double().reshape(b, hkv, h // hkv, hd) * hd ** -0.5
        probs = torch.softmax(
            torch.einsum("bkgd,bskd->bkgs", qh, k[0].double()), dim=-1)
        exact = torch.einsum("bkgs,bskd->bkgd", probs, v[0].double()).reshape(b, -1)
        top = exact.abs().max().item()
        err = (got - want).abs().max().item()
        err_exact = (got.double() - exact).abs().max().item()

        def poisoned(t, fill):
            tail = torch.full((b, 4) + tuple(t.shape[2:]), fill, dtype=t.dtype,
                              device=device)
            return torch.cat([t, tail], dim=1).contiguous()
        got_p = ca.cross_attention_int8(
            q, poisoned(kq[0], 127), poisoned(ks[0], 10.0), poisoned(vq[0], 127),
            poisoned(vs[0], 10.0), hkv, seq, h)
        err_p = (got_p - got).abs().max().item()

        ms = cuda_ms(lambda: ca.cross_attention_int8(q, *args), 50)
        plain_ms = cuda_ms(lambda: ca.cross_attention_int8_reference(q, *args), 20)
        nbytes = (kq[0].numel() + vq[0].numel() + 2 * (ks[0].numel() + vs[0].numel())
                  + 2 * 4 * q.numel())
        bound_ms, bound_by = bound(nbytes, 4 * b * h * s * hd, torch.bfloat16)
        print(f"  cross_attention_int8 {name:8s} [{b}, {s}, {h}/{hkv}, {hd}]: "
              f"max|err| {err:.2e} ({err / top:.1e} of max|out|, tol 1e-3); "
              f"against exact attention {err_exact / top:.2e} (tol 2e-2); "
              f"poisoned tail {err_p:.1e} (tol 1e-5)  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})",
              flush=True)
        if not (err <= 1e-3 * top and err_exact <= 0.02 * top and err_p <= 1e-5):
            raise AssertionError(f"cross_attention_int8 {name}: max|err| {err}, "
                                 f"against exact {err_exact}, poisoned {err_p}, "
                                 f"max|out| {top}")
        if name == "base":
            in_graph = graph_ms(lambda: ca.cross_attention_int8(q, *args), 50)
            print(f"    note: replayed from a CUDA graph, without the host's "
                  f"dispatch: {in_graph:.4f} ms", flush=True)
            row = {"name": "cross_attention_int8", "route": "cuda",
                   "source": "whisperseg_torch/csrc/cross_attention_int8.cu",
                   "replaces": "whisperseg_tpu/ops/cross_attention.py:48",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   # scaled_dot_product_attention takes no int8 K/V
                   "library_ms": None}
    return row


# ------------------------------------------------------------------- golden


@torch.no_grad()
def top2_margins(seg, frontend, clips: np.ndarray, tokens) -> np.ndarray:
    """Teacher-forced decoder logits along ``tokens`` -> [N, L] gap between
    the two largest logits of the prediction made at each position."""
    from whisperseg_torch.models.whisper import (decoder_step, encoder_forward,
                                                 init_cache, precompute_cross_kv)

    cfg = seg.config
    ids = torch.tensor(tokens, device=seg.device)
    feats = frontend.features_for_clips(torch.from_numpy(clips).to(seg.device),
                                        cfg.total_spec_columns)
    xk, xv = precompute_cross_kv(seg.params, cfg,
                                 encoder_forward(seg.params, cfg, feats))
    ck, cv = init_cache(cfg, ids.shape[0], ids.shape[1], seg.device)
    logits, _, _ = decoder_step(seg.params, cfg, xk, xv, ids, 0, ck, cv)
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def golden_phase(device) -> None:
    from whisperseg_torch import tokenizer as tok
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.checkpoint import load_checkpoint
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    with open(os.path.join(ROOT, "whisperseg_torch", "golden_tiny.json")) as f:
        golden = json.load(f)
    req = golden["request"]
    params, cfg = load_checkpoint(os.path.join(ROOT, golden["checkpoint"]))
    cfg.compute_dtype = golden["compute_dtype"]
    seg = Segmenter(params, cfg, inference_dtype="float32", device=device)
    audio = tone_bursts(req["seed"], sr=req["sr"], duration=req["duration"])
    table = seg.segment(audio, req["sr"], num_beams=req["num_beams"],
                        num_trials=req["num_trials"])
    dsc = seg.default_segmentation_config
    clips, _ = seg.slice_audio_windows(audio, req["sr"], dsc["spec_time_step"],
                                       req["num_trials"])
    frontend = Frontend(req["sr"], dsc["spec_time_step"], dsc["min_frequency"])
    tokens = seg._generate_tokens(clips, frontend, BATCH, int(dsc["max_length"]),
                                  req["num_beams"], 1.0)
    margins = top2_margins(seg, frontend, clips, golden["tokens"])
    pl = len(tok.PROMPT_IDS)
    along = [margins[w, pl - 1:row.index(tok.EOT_ID) if tok.EOT_ID in row
                     else len(row) - 1].min()
             for w, row in enumerate(golden["tokens"])]
    print(f"  {len(clips)} windows; smallest top-2 logit margin along the "
          f"golden tokens: {min(along):.4g}", flush=True)
    diverged = [(w, next(t for t, (a, b) in enumerate(zip(got, want)) if a != b))
                for w, (got, want) in enumerate(zip(tokens, golden["tokens"]))
                if got != want]
    if diverged:
        w, t = diverged[0]
        margin = float(margins[w, t - 1])
        print(f"  tokens differ in {len(diverged)} windows; first at window {w} "
              f"position {t}, top-2 logit margin there {margin:.4g}", flush=True)
    print(f"  table ({len(table['onset'])} segments) "
          f"{'identical to' if table == golden['table'] else 'DIFFERS from'} "
          f"the golden table", flush=True)
    if table != golden["table"] and not (diverged and margin < 1e-3):
        raise AssertionError(f"golden table mismatch:\n got  {table}\n want "
                             f"{golden['table']}")


# -------------------------------------------------------------------- serve


class StepCount:
    """Counts the decode loop's calls of ``decoder_step`` while it stands in
    for it: all of them, and those of a single token."""

    def __init__(self, decode_module):
        self.module = decode_module
        self.inner = decode_module.decoder_step
        self.calls = self.single = 0

    def __call__(self, params, cfg, xk, xv, input_ids, *args, **kwargs):
        self.calls += 1
        self.single += input_ids.shape[1] == 1
        return self.inner(params, cfg, xk, xv, input_ids, *args, **kwargs)

    def __enter__(self):
        self.module.decoder_step = self
        return self

    def __exit__(self, *exc):
        self.module.decoder_step = self.inner


def serve_phase(device, requests, inference_dtype="bfloat16", int8_kv=False,
                baseline=None):
    """One Segmenter on the base checkpoint answers ``requests``; checks the
    tables and every kernel's launch count. Returns the Segmenter, the
    launch counts, and the tables' segment counts by request (``baseline``:
    those of the bfloat16 phase, printed beside)."""
    from whisperseg_torch import decode
    from whisperseg_torch.ops import attention, cross_attention, logmel, quant
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    seg = Segmenter.from_pretrained(
        os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad"),
        inference_dtype=inference_dtype, device=device)
    # warm-up: cuBLAS, caches
    seg.segment(tone_bursts(99, duration=2.5), SR, int8_kv=int8_kv)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()

    logmel.launches = attention.launches = cross_attention.launches = 0
    attention.launches_bwd_dkv = attention.launches_bwd_dq = 0
    quant.launches_w8a16 = quant.launches_w4a16 = 0
    batches, audio_s, busy_s, segments = 0, 0.0, 0.0, {}
    with StepCount(decode) as steps:
        for seed, duration, trials in requests:
            audio = tone_bursts(seed, duration=duration)
            t0 = time.perf_counter()
            table = seg.segment(audio, SR, num_trials=trials, int8_kv=int8_kv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            windows = len(seg.slice_audio_windows(audio, SR, SPEC_TIME_STEP,
                                                  trials)[1])
            batches += -(-windows // BATCH)
            audio_s += duration
            busy_s += dt
            segments[(seed, duration, trials)] = len(table["onset"])
            beside = ("" if baseline is None else
                      f" (bfloat16: {baseline[(seed, duration, trials)]})")
            print(f"  request seed {seed}: {duration:4.1f} s audio, num_trials "
                  f"{trials}, {windows:2d} windows -> {len(table['onset']):3d} "
                  f"segments{beside} in {dt:.3f} s ({duration / dt:.1f} "
                  f"audio-s/s)", flush=True)
            if inference_dtype == "bfloat16":  # the card's table, recorded
                print("  table " + json.dumps({"request": [seed, duration, trials],
                                              "table": table}), flush=True)
            if not table["onset"]:
                raise AssertionError(f"request seed {seed}: empty segment table")
    counts = {"melproject": logmel.launches, "attention_hm": attention.launches,
              "attention_hm_bwd": (attention.launches_bwd_dkv
                                   + attention.launches_bwd_dq),
              "qdot_w8a16": quant.launches_w8a16,
              "qdot_w4a16": quant.launches_w4a16,
              "cross_attention_int8": cross_attention.launches}
    cfg = seg.config
    # 8 quantized projections per decoder layer and step (q, k, v, o, xq, xo,
    # fc1, fc2); the encoder's and the cross K/V's run at M > 512 rows
    per_step = 8 * cfg.decoder_layers * steps.calls
    want = {"melproject": batches,
            "attention_hm": batches * cfg.encoder_layers,
            "attention_hm_bwd": 0,
            "qdot_w8a16": per_step if inference_dtype == "int8" else 0,
            "qdot_w4a16": per_step if inference_dtype == "int4" else 0,
            "cross_attention_int8": (cfg.decoder_layers * steps.single
                                     if int8_kv else 0)}
    print(f"  {audio_s:.1f} s of audio in {busy_s:.3f} s "
          f"({audio_s / busy_s:.1f} audio-s/s); {batches} batches, "
          f"{steps.calls} decoder steps ({steps.single} of one token); "
          f"launches {counts}; device memory {before:.1f} MiB allocated "
          f"before the requests, peak {torch.cuda.max_memory_allocated() / 2**20:.0f}"
          f" MiB", flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    return seg, counts, segments


def card_tokens(seg, requests) -> None:
    """For each request, its windows' beam-4 token ids and the top-2 logit
    margin of each prediction along them (teacher-forced), one JSON line a
    request, kept with the tables in whisperseg_torch/card_tables_bf16.json:
    where a table departs from the JAX package's, they give the first
    differing decode step and how close the card's pick was there."""
    from whisperseg_torch import tokenizer as tok
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.synthetic import tone_bursts

    dsc = seg.default_segmentation_config
    frontend = Frontend(SR, dsc["spec_time_step"], dsc["min_frequency"])
    for seed, duration, trials in requests:
        clips, _ = seg.slice_audio_windows(tone_bursts(seed, duration=duration),
                                           SR, dsc["spec_time_step"], trials)
        tokens = [row[:row.index(tok.EOT_ID) + 1] if tok.EOT_ID in row else row
                  for row in seg._generate_tokens(clips, frontend, BATCH,
                                                  int(dsc["max_length"]), 4, 1.0)]
        width = max(map(len, tokens))
        padded = [row + [tok.PAD_ID] * (width - len(row)) for row in tokens]
        margins = top2_margins(seg, frontend, clips, padded)
        print("  tokens " + json.dumps({
            "request": [seed, duration, trials], "tokens": tokens,
            "margins": [[round(float(x), 4) for x in m[:len(row)]]
                        for m, row in zip(margins, tokens)]}), flush=True)


def timed(fn):
    """(fn(), seconds), the device synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stage_times(seg, audio, int8_kv: bool) -> None:
    """The request untraced, then its first batch of windows stage by stage
    (each stage ended by a synchronize): where the host clock goes."""
    from whisperseg_torch import tokenizer as tok
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.decode import generate
    from whisperseg_torch.models.whisper import encoder_forward, frame_head_forward

    cfg = seg.config
    _, wall = timed(lambda: seg.segment(audio, SR, int8_kv=int8_kv))
    clips, _ = seg.slice_audio_windows(audio, SR, SPEC_TIME_STEP, 1)
    n_batches = -(-len(clips) // BATCH)
    x = torch.from_numpy(clips[:BATCH]).to(seg.device)
    frontend = Frontend(SR, SPEC_TIME_STEP)
    max_length = int(seg.default_segmentation_config.get("max_length", 448))
    feats, t_fe = timed(lambda: frontend.features_for_clips(x, cfg.total_spec_columns))
    enc, t_enc = timed(lambda: encoder_forward(seg.params, cfg, feats))
    _, t_fh = timed(lambda: frame_head_forward(seg.params, cfg, enc))
    tokens, t_dec = timed(lambda: generate(seg.params, cfg, max_length=max_length,
                                           num_beams=4, int8_kv=int8_kv,
                                           enc_out=enc))
    longest = int((tokens != tok.PAD_ID).sum(dim=1).max()) - len(tok.PROMPT_IDS)
    print(f"  10 s request untraced: {wall:.3f} s for {len(clips)} windows "
          f"({n_batches} batch); its first batch by stage: frontend "
          f"{t_fe * 1e3:.2f} ms, encoder {t_enc * 1e3:.2f} ms, frame head "
          f"{t_fh * 1e3:.2f} ms, beam-4 decode {t_dec * 1e3:.2f} ms (longest "
          f"output {longest} tokens, {t_dec * 1e3 / max(longest, 1):.2f} ms "
          f"per token)", flush=True)


def profile_phase(seg, int8_kv: bool = False) -> None:
    """One 10 s request timed by stage, then under torch.profiler: device
    busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from whisperseg_torch.synthetic import tone_bursts

    audio = tone_bursts(200, duration=10.0)
    stage_times(seg, audio, int8_kv)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.segment(audio, SR, int8_kv=int8_kv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, "10 s request", SERVE_GROUPS)


SERVE_GROUPS = {"melproject": ("melproject",), "attention_hm": ("attention_hm",),
                "qdot": ("qdot",), "cross_attention_int8": ("cross_attention",),
                "matmul": ("gemm", "gemv", "nvjet", "cutlass", "sm90"),
                "fft": ("fft",)}


def report_profile(prof, wall: float, what: str, groups: dict) -> dict:
    """Prints the device's busy share of ``wall`` seconds and its time by
    group of kernel names (first matching group, else "other") and by
    kernel; returns the time by group in ms, and the busy time under
    "busy"."""
    from torch.autograd import DeviceType

    # user annotations (e.g. "Optimizer.step#AdamW.step") are ranges laid
    # over the device's timeline, not kernels: left out
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        print("  torch.profiler recorded no device time", flush=True)
        return {}
    busy_us, reach = 0.0, -1.0
    by_name = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, n + 1)
    print(f"  {what}, traced: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{len(spans)} device ops", flush=True)
    by_group = {}
    for name, (tot, n) in by_name.items():
        group = next((g for g, keys in groups.items()
                      if any(k in name.lower() for k in keys)), "other")
        t, c = by_group.get(group, (0.0, 0))
        by_group[group] = (t + tot, c + n)
    print("  device time by group: " + ", ".join(
        f"{g} {t / 1e3:.3f} ms ({c}x)" for g, (t, c) in
        sorted(by_group.items(), key=lambda kv: -kv[1][0])), flush=True)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {tot / 1e3:9.3f} ms {n:6d}x  {name[:90]}", flush=True)
    return {"busy": busy_us / 1e3, **{g: t / 1e3 for g, (t, _) in by_group.items()}}


# -------------------------------------------------------------------- train

TRAIN_STEPS = 30        # steps of the main training run
TRAIN_TIMED_FROM = 5    # steps before this one are warm-up, not timed
TRAIN_PROFILED = (10, 13)  # steps [10, 13) run under torch.profiler
TRAIN_FILES = 8         # 10 s recordings: 5 windows of 2.5 s each
TRAIN_GROUPS = {"K2 attention_hm": ("attention_hm",),
                "dkv": ("attention_bwd_dkv",), "dq": ("attention_bwd_dq",),
                "K1 melproject": ("melproject",),
                "cuBLAS": ("gemm", "gemv", "nvjet", "cutlass", "sm90"),
                "optimizer": ("multi_tensor",),
                "elementwise": ("elementwise", "vectorized", "reduce", "copy",
                                "fill", "index", "cat", "softmax", "norm",
                                "where", "gather", "scatter")}


class StepProbe:
    """Stands in for ``trainer.build_train_step`` while a run builds its
    step: every step is synchronized and timed, its loss read, its launches
    of the encoder-attention kernels counted, and steps ``profiled`` run
    under torch.profiler. ``VocalSegDataset.collate`` calls are counted
    too: each collated batch must launch the mel kernel once."""

    def __init__(self, profiled=None):
        from whisperseg_torch.data import VocalSegDataset
        from whisperseg_torch.training import trainer

        self.trainer, self.dataset_cls = trainer, VocalSegDataset
        self.profiled = profiled
        self.times, self.losses, self.launches = [], [], []
        self.collates = 0
        self.prof, self.prof_wall = None, 0.0

    def __enter__(self):
        from whisperseg_torch.ops import attention, logmel

        self.build, self.collate = self.trainer.build_train_step, self.dataset_cls.collate
        probe = self

        def collate(dataset, items):
            probe.collates += 1
            return probe.collate(dataset, items)

        def build(*args, **kwargs):
            step = probe.build(*args, **kwargs)

            def timed_step(params, batch, gen):
                i = len(probe.times)
                if probe.profiled and i == probe.profiled[0]:
                    from torch.profiler import ProfilerActivity, profile
                    probe.prof = profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                    probe.prof.start()
                before = (attention.launches, attention.launches_bwd_dkv,
                          attention.launches_bwd_dq)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(params, batch, gen)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                after = (attention.launches, attention.launches_bwd_dkv,
                         attention.launches_bwd_dq)
                if probe.profiled and probe.profiled[0] <= i < probe.profiled[1]:
                    probe.prof_wall += dt
                    if i == probe.profiled[1] - 1:
                        probe.prof.stop()
                probe.times.append(dt)
                probe.losses.append(float(loss))
                probe.launches.append(tuple(a - b for a, b in zip(after, before)))
                return loss
            return timed_step

        self.trainer.build_train_step = build
        self.dataset_cls.collate = collate
        logmel.launches = attention.launches = attention.launches_lse = 0
        attention.launches_bwd_dkv = attention.launches_bwd_dq = 0
        return self

    def __exit__(self, *exc):
        self.trainer.build_train_step = self.build
        self.dataset_cls.collate = self.collate


def train_run(data: str, model_folder: str, steps: int, extra=(),
              profiled=None) -> StepProbe:
    """``whisperseg_torch.cli.train.main`` on the shipped base checkpoint
    (bf16 compute as shipped, float32 master weights, AdamW, the CLI's
    default frame head) for ``steps`` steps, under a ``StepProbe``."""
    from whisperseg_torch.cli import train as train_cli

    argv = ["--initial_model_path",
            os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad"),
            "--model_folder", model_folder, "--train_dataset_folder", data,
            "--max_num_iterations", str(steps), "--batch_size", str(BATCH),
            "--total_spec_columns", "1000", "--max_length", "100",
            "--learning_rate", "1e-4", "--warmup_steps", "5",
            "--print_every", "5", "--num_workers", "4", *extra]
    with StepProbe(profiled) as probe:
        train_cli.main(argv)
    return probe


def train_phase(device) -> dict:
    """Trains the base checkpoint at full width on a synthetic tone dataset
    through the train CLI, then answers one request with the result. Fails
    unless every step launches K2 once per encoder layer (twice under
    remat) and each backward kernel once per layer, every batch the mel
    kernel once, no library attention kernel (SDPA, cuDNN) runs in the
    profiled steps, every loss is finite and the last five steps' mean loss
    is below the first five's. Returns the launches of K2 with the row
    log-sum-exp (all of a step's K2 launches) and of the backward kernels."""
    import tempfile

    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts, write_tone_dataset

    layers = 6  # the base checkpoint's encoder layers
    with tempfile.TemporaryDirectory() as tmp:
        data = write_tone_dataset(os.path.join(tmp, "data"), TRAIN_FILES,
                                  seed=500)
        before = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        probe = train_run(data, os.path.join(tmp, "model"), TRAIN_STEPS,
                          profiled=TRAIN_PROFILED)
        wall = time.perf_counter() - t0
        lse_launches = attention.launches_lse
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        k1 = logmel.launches
        timed_ms = np.array([t * 1e3 for i, t in enumerate(probe.times)
                             if i >= TRAIN_TIMED_FROM
                             and not TRAIN_PROFILED[0] <= i < TRAIN_PROFILED[1]])
        losses = probe.losses
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        med = float(np.median(timed_ms))
        clip_s = 1000 * SPEC_TIME_STEP
        print(f"  {len(probe.times)} steps of batch {BATCH} x {clip_s:.1f} s "
              f"in {wall:.1f} s (data, model load and saves included); steps "
              f"{TRAIN_TIMED_FROM}.. (unprofiled, synchronized): median "
              f"{med:.2f} ms, min {timed_ms.min():.2f}, max {timed_ms.max():.2f},"
              f" p10-p90 {np.percentile(timed_ms, 10):.2f}-"
              f"{np.percentile(timed_ms, 90):.2f} ms; "
              f"{BATCH * clip_s / med * 1e3:.1f} audio-s trained per s; device "
              f"memory {before:.1f} MiB allocated before the run, peak "
              f"{peak:.0f} MiB", flush=True)
        print(f"  loss: first 5 steps {first:.4f}, last 5 {last:.4f}; all "
              f"{', '.join(f'{x:.3f}' for x in losses)}", flush=True)
        print(f"  launches per step (K2, dkv, dq): {sorted(set(probe.launches))}"
              f"; K1 {k1} for {probe.collates} collated batches", flush=True)
        groups = report_profile(
            probe.prof, probe.prof_wall,
            f"{TRAIN_PROFILED[1] - TRAIN_PROFILED[0]} training steps",
            TRAIN_GROUPS)
        bwd = groups.get("dkv", 0.0) + groups.get("dq", 0.0)
        kernels = bwd + groups.get("K2 attention_hm", 0.0)
        busy = max(groups.get("busy", 0.0), 1e-9)
        print(f"  the three attention kernels: {kernels:.3f} ms, "
              f"{100 * kernels / busy:.1f} % of the device's busy time; the "
              f"two backward kernels {100 * bwd / busy:.1f} %", flush=True)
        library = {e.name for e in probe.prof.events() if any(
            k in e.name.lower() for k in ("fmha", "flash", "cudnn",
                                          "efficient_attention"))}
        if library:  # the encoder's attention must be the port's kernels
            raise AssertionError(f"library attention kernels ran: {library}")
        if set(probe.launches) != {(layers, layers, layers)} or \
                lse_launches != sum(x[0] for x in probe.launches):
            raise AssertionError(f"launches per step {probe.launches}; K2 "
                                 f"with the log-sum-exp {lse_launches}")
        if k1 != probe.collates or probe.collates < TRAIN_STEPS:
            raise AssertionError(f"K1 launches {k1} for {probe.collates} batches")
        if not (all(np.isfinite(losses)) and last < first):
            raise AssertionError(f"losses {losses}")
        train_launches = {"attention_hm_lse": lse_launches,
                          "attention_hm_bwd_dkv": sum(x[1] for x in probe.launches),
                          "attention_hm_bwd_dq": sum(x[2] for x in probe.launches)}

        before = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        remat = train_run(data, os.path.join(tmp, "model_remat"), 5,
                          extra=("--dropout", "0.1", "--remat", "1"))
        print(f"  --dropout 0.1 --remat 1, 5 steps: launches per step (K2, "
              f"dkv, dq) {sorted(set(remat.launches))}; losses "
              f"{', '.join(f'{x:.3f}' for x in remat.losses)}; median "
              f"{np.median(remat.times[1:]) * 1e3:.2f} ms a step; device memory "
              f"{before:.1f} MiB allocated before, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB",
              flush=True)
        if set(remat.launches) != {(2 * layers, layers, layers)} \
                or not all(np.isfinite(remat.losses)):
            raise AssertionError(f"remat run: launches {remat.launches}, "
                                 f"losses {remat.losses}")

        seg = Segmenter.from_pretrained(
            os.path.join(tmp, "model", "final_checkpoint"), device=device)
        audio = tone_bursts(600, duration=10.0)
        attention.launches = logmel.launches = 0
        attention.launches_bwd_dkv = attention.launches_bwd_dq = 0
        table, dt = timed(lambda: seg.segment(audio, SR))
        bwd = attention.launches_bwd_dkv + attention.launches_bwd_dq
        print(f"  the trained checkpoint, bfloat16: a 10 s request -> "
              f"{len(table['onset'])} segments in {dt:.3f} s (launches K1 "
              f"{logmel.launches}, K2 {attention.launches}, backward {bwd})",
              flush=True)
        if not table["onset"] or bwd or \
                attention.launches != layers * logmel.launches:
            raise AssertionError(f"serving the trained checkpoint: {table}")
    return train_launches


# --------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 products wherever a float32 matmul or convolution runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from whisperseg_torch.ops import _build

    start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    print(f"[setup] {card}; torch {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s into "
          f"{os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)
    for source, key in (("attention", "attention_hm"), ("qdot", "qdot")):
        for kernel, regs, spill, static in ptxas_summary(logs.get(source, ""), key):
            print(f"[setup] ptxas {kernel}: {regs} registers, {spill} bytes "
                  f"spilled, {static} bytes static shared memory", flush=True)
    floor_ms = launch_floor_ms()
    print(f"[setup] per-launch floor: a one-element in-place add replayed from "
          f"a CUDA graph takes {floor_ms:.5f} ms (bound "
          f"{bound(8, 1, torch.float32)[0]:.2e} ms)", flush=True)

    print("[kernels] each against its plain version on the card", flush=True)
    rows = [check_melproject(device), *check_attention(device),
            check_qdot(device, 8, floor_ms), check_qdot(device, 4, floor_ms),
            check_cross_attention(device), *check_attention_backward(device)]
    # the yardsticks' captures ran cuBLAS on their own streams, each of which
    # keeps a workspace; freed here so that the later phases' peaks measure
    # the port
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    print(f"[kernels] device memory allocated after the kernel checks "
          f"{held / 2**20:.1f} MiB, {torch.cuda.memory_allocated() / 2**20:.1f} "
          f"MiB once cuBLAS's workspaces are cleared", flush=True)

    print("[golden] tiny checkpoint, float32, beam 4, 3 trials", flush=True)
    golden_phase(device)

    print("[serve] base checkpoint, bfloat16, default arguments", flush=True)
    seg, launches, segments = serve_phase(device, REQUESTS)
    card_tokens(seg, REQUESTS)

    # each mode's kernels take their launch count from that mode's run
    for dtype, int8_kv, names in (
            ("int8", False, ("qdot_w8a16",)), ("int4", False, ("qdot_w4a16",)),
            ("int8", True, ("cross_attention_int8",))):
        print(f"[quantized serve] base checkpoint, {dtype}"
              f"{' with int8_kv' if int8_kv else ''}, default arguments",
              flush=True)
        qseg, counts, _ = serve_phase(device, QUANT_REQUESTS, dtype, int8_kv,
                                      baseline=segments)
        launches.update({name: counts[name] for name in names})

    print("[profile] bfloat16", flush=True)
    profile_phase(seg)
    print("[profile] int8 with int8_kv", flush=True)
    profile_phase(qseg, int8_kv=True)

    print("[train] base checkpoint through the train CLI, bf16 compute, "
          "float32 master weights, AdamW", flush=True)
    launches.update(train_phase(device))
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was never launched on its path")

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
