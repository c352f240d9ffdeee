#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisperseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --int8-kv-tables [PACKAGE_ROOT]

Run it from the root of a checkout. It builds the port's CUDA kernels from
``whisperseg_torch/csrc`` (one ``nvcc`` per source, all started together) and
then runs, in order:

  1. setup: the card's name and power limit, the torch version, the build time,
     every kernel's registers and spills (``nvcc -Xptxas -v``), and the
     per-launch floor (one trivial launch replayed from a CUDA graph);
  2. kernels: each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the kernel's time (also replayed from a CUDA
     graph), the plain version's, one library call's as a yardstick where
     there is one, and the least time the card could take for the same work
     with the kernel's share of it: the mel kernel at every n_fft and at the
     mouse preset, beside the plain version's graph time; the encoder
     attention at eight shapes, in bf16 also against the plain model of its
     own walk, with SDPA's time and backend; the quantized products at every
     projection shape of every model size and at ragged shapes, their graph
     times at the decode shapes and over a decoder step, and at M 512 beside
     the large-M route (dequantize, then one matmul); the int8
     cross-attention at six cases (one with seq_len 301) also against the
     plain model of its cluster walk; the encoder attention's two backward
     kernels at seven shapes with a finite-difference spot check. Every
     kernel is called twice and must give the same bits (the mel kernel, the
     bf16 attention, the quantized products, the cross-attention, the
     backward kernels). Then the audio LM at Moonlight-16B-A3B's widths
     (``audio_lm_phase``): the routed experts' grouped products (K7) against
     their plain version at a beam step's and a prefill's rows, under an
     even and a skewed routing, and one ``segment()`` through the audio LM,
     K7's launches counted over it and its expert load read. Then the
     device memory still allocated, before and after cuBLAS's workspaces
     (the yardsticks') are freed;
  3. golden: the shipped tiny checkpoint at float32 on the card must give the
     JAX package's segment table (whisperseg_torch/golden_tiny.json);
  4. serve: one ``Segmenter`` on the shipped base checkpoint (bfloat16 as
     shipped, default arguments: beam 4 and the checkpoint's
     post-processing) answers synthetic requests, each table and each
     window's tokens printed as JSON lines
     (``whisperseg_torch/card_tables_bf16.json`` records them); every batch
     must launch the mel kernel once and the attention kernel once per
     encoder layer;
  5. quantized serve: the same checkpoint as ``inference_dtype="int8"``, as
     ``"int4"``, and as ``"int8"`` with ``int8_kv=True`` answers two of those
     requests each; besides the above, every decoder step must launch the
     w8a16 (or w4a16) kernel 8 times per decoder layer, and every
     single-token step the int8 cross-attention kernel once per layer; the
     ``int8_kv`` tables and tokens are printed as JSON lines
     (``whisperseg_torch/card_tables_int8_kv.json`` records them);
  6. service: ``BatchingSegmenter`` on the base checkpoint (bf16) warms up
     (kernels, one seq2seq and one frame batch) and serves
     ``services.segment_service.build_app`` on 127.0.0.1; 7 requests (seq2seq
     of 2.5, 10 and 30 s, two identical default ones of 3 trials, two with
     the frame post-processing off, a 30 s frame-mode one, a ``top_p`` one
     and an Adobe one) come from 4 client threads at once and must get 201
     and non-empty tables, the two identical ones identical tables; a
     frame-mode request alone must make no decoder step;
     ``segment(constrained=True)`` and ``segment(top_k=5, seed=1)`` must
     each give the same well-formed table twice; over these, the mel kernel
     must launch once per batch (fused by the batcher's worker, run on a
     handler's thread for a request that needs the frame tracks, or a frame
     batch), the attention kernel once per encoder layer of each; then the
     segment CLI on a 60 s recording, whole and streamed in 20 s chunks,
     must write the same CSV bytes;
  7. backend: the model-zoo backend on 127.0.0.1 with the base checkpoint
     as a built-in model (bf16) and its training worker running: a 10 s
     recording as WAV and as FLAC must get 200 and identical tables, equal
     to ``segment()`` on the decoded samples; frame mode on the FLAC and a
     crafted MP3 must get 200; the mel kernel must launch once a batch and
     the attention kernel once an encoder layer a batch; then a fine-tune
     submitted through the client (three FLAC recordings with CSV labels)
     runs in the worker's subprocess on the card, capped at 30 iterations:
     it must exit 0, launch the attention kernel (with the row log-sum-exp)
     and both backward kernels once an encoder layer a step, and its model
     must be listed ready and answer ``/segment``; latencies, the
     fine-tune's wall time, iterations and exit code, beside the card's
     name and power limit;
  8. profile: the frontend of one batch at the mouse preset, then one more
     request, in bfloat16 and then in int8 with ``int8_kv``, timed stage by
     stage, then under ``torch.profiler``: the device's busy share and its
     time by kernel;
  9. train: ``python -m whisperseg_torch.cli.train``'s ``main`` trains the
     base checkpoint at full width (bf16 compute, float32 master weights,
     AdamW, the CLI's default frame head) for 30 steps on a synthetic tone
     dataset, 3 of them profiled; every step must launch the attention
     kernel (writing the row log-sum-exp) and each backward kernel once per
     encoder layer, every batch the
     mel kernel once, and the loss must fall; then 5 steps with dropout and
     remat (the attention kernel twice per layer), and the trained
     checkpoint answers one request;
 10. speculative: the tiny checkpoint drafting for itself at float32 must
     give plain greedy's token ids on the golden request; the base
     checkpoint (bf16) with the tiny one drafting (spec_k 4) answers 10 s
     and 30 s of audio beside plain greedy, in turns, its tokens held to
     greedy's but for near ties, with exact mel and attention launch counts
     (the draft's encoder included); an int8 target must launch the w8a16
     kernel at the verify chunk's M; the segment CLI with
     ``--draft_model_path``;
 11. train options: the train CLI on the base checkpoint with adafactor +
     QAT 8 + the profiler hook (a trace written, losses falling, the
     optimizer states' bytes and step times beside AdamW's), with GQA 8/2
     uptraining + splice synthesis (its checkpoint then serves in bf16 and
     in int8 with ``int8_kv``: the attention kernel at group 4, the int8
     cross-attention at GQA), and with the device pool (launches per
     block, steps/s beside the per-step loader's);
 12. pretrain: ``pretrain.run_pretraining`` of the base size over a pool
     of every preset configuration and a 384 kHz one: the mel kernel at
     n_fft 512 to 8192, the attention kernels once a layer a step, finite
     losses, and the checkpoint answers a request;
 13. hf: the base checkpoint exported to a HuggingFace directory and
     imported back bit for bit, ``Segmenter.from_pretrained`` on it giving
     the ``params.npz`` checkpoint's table (K1 and K2 counted), and
     transformers' float32 logits on the card beside the port's;
 14. parallel: two ranks on ``cuda:0`` over gloo train the base checkpoint
     in dp 2, tp 2 and dp 2 + fsdp, in bf16 and in float32, each beside one
     process (PARALLEL_RUNS: losses, the first gradient's norm, the
     parameters' change), the attention kernels once a layer a step on
     each rank (K2 at 4 heads under tp); then a mesh Segmenter's table.

The last three lines of its output are the kernels' JSON record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. A failed phase
raises, and the script then exits non-zero without them. Without CUDA it
exits non-zero at once.

``--int8-kv-tables`` runs only the ``int8_kv`` serve requests and prints
their tables and tokens, with the ``whisperseg_torch`` package found under
PACKAGE_ROOT (default: this checkout), so that another checkout's kernels
can be recorded on the same card.
"""

from __future__ import annotations

import gc
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
            # <kernel>[I<args>E]: kernel[<args>], each argument L<i|b><n>E
            # (a number), f (float) or 13__nv_bfloat16 (bf16)
            short = re.search(rf"\d({key}[a-z_0-9]*)(?:I((?:L[ib]-?\d+E|f|13__nv_bfloat16)+)E)?",
                              name)
            args = [] if not (short and short.group(2)) else [
                num or ("float" if ty == "f" else "bf16") for num, ty in
                re.findall(r"L[ib](-?\d+)E|(f|13__nv_bfloat16)", short.group(2))]
            label = (name if not short else short.group(1) + (
                f"<{', '.join(args)}>" if args else ""))
            rows.append((label, int(used.group(1)), spill, int(used.group(2) or 0)))
            name = None
    return rows


# ------------------------------------------------------------------ kernels


MEL_CASES = [  # sr, spec_time_step, min_frequency, seconds a clip (1000 frames)
    (32000, SPEC_TIME_STEP, 0, 2.5), (64000, SPEC_TIME_STEP, 0, 2.5),
    (128000, SPEC_TIME_STEP, 0, 2.5), (256000, SPEC_TIME_STEP, 0, 2.5),
    (400000, SPEC_TIME_STEP, 0, 2.5),
    # the mouse preset (config/segment_config.json): n_fft 4096, hop 150,
    # bands from 35 kHz up
    (300000, 0.0005, 35000, 0.5)]


def mel_bound(re, mel, bands):
    """(bound ms, by) of K1 on these inputs: the spectrum's bins that some
    band covers read once (8 bytes a bin and frame), the band weights and
    rows read once, the output written once; 3 operations a power and 2 a
    band entry of each frame."""
    b, _, frames = re.shape
    n_mel = mel.shape[1]
    lo, hi = bands.rows[:, 0], bands.rows[:, 1]
    used = hi > lo
    span = int((hi[used].max() - lo[used].min()).item()) if used.any() else 0
    entries = int((hi - lo).clamp(min=0).sum().item())
    nbytes = 8 * b * span * frames + 4 * entries + 8 * n_mel + 4 * b * n_mel * frames
    flops = b * frames * (3 * span + 2 * entries)
    return bound(nbytes, flops, torch.float32)


def check_melproject(device) -> dict:
    """K1 against its plain version for every n_fft and the mouse preset (4
    clips of 1000 frames, on the spectra the frontend feeds it), a second
    call bit-identical; the kernel's and the plain version's graph times and
    the kernel's share of the bound. Returns the main path's row (32 kHz,
    n_fft 512)."""
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.ops import logmel
    from whisperseg_torch.synthetic import tone_bursts

    row = None
    for sr, step, fmin, seconds in MEL_CASES:
        fr = Frontend(sr, step, fmin)
        clips = np.stack([tone_bursts(s, sr=sr, duration=seconds)
                          for s in range(BATCH)])
        re, im, mel, bands = fr.spectrum(torch.from_numpy(clips).to(device))

        def kernel():
            return logmel.melproject_reim(re, im, mel, bands)

        def plain():
            return logmel.melproject_reference(re, im, mel)
        got, again, want = kernel(), kernel(), plain()
        err = (got - want).abs().max().item()
        same = torch.equal(got, again)
        b, n_freq, frames = re.shape
        ms = cuda_ms(kernel, 50)
        in_graph = graph_ms(kernel, 50)
        plain_ms = cuda_ms(plain, 20)
        plain_graph = graph_ms(plain, 20)
        bound_ms, bound_by = mel_bound(re, mel, bands)
        widths = (bands.rows[:, 1] - bands.rows[:, 0]).clamp(min=0)
        print(f"  melproject n_fft {fr.n_fft:5d} sr {sr:6d} fmin {fmin:5d} "
              f"[{b}, {n_freq}, {frames}]: max|err| {err:.2e} (tol 2e-5), "
              f"second call {'identical' if same else 'DIFFERS'}; bands "
              f"{int(widths.sum())} of {n_freq * mel.shape[1]} entries, widest "
              f"{int(widths.max())}\n    kernel {ms:.4f} ms (graph "
              f"{in_graph:.4f} ms, {100 * bound_ms / in_graph:.1f} % of the "
              f"bound)  plain {plain_ms:.4f} ms (graph {plain_graph:.4f} ms)  "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        if not (err <= 2e-5 and same):
            raise AssertionError(f"melproject n_fft {fr.n_fft} sr {sr}: "
                                 f"max|err| {err}, second call identical {same}")
        if (sr, fmin) == (SR, 0):
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
    # (parallel) a rank's share of the base checkpoint at global batch 4:
    # dp 2 (and fsdp) halves the rows, tp 2 the heads
    ("base dp 2 bf16", BATCH // 2, 8, 8, HD, torch.bfloat16, VALID),
    ("base tp 2 bf16", BATCH, 4, 4, HD, torch.bfloat16, VALID),
    ("base dp 2 f32", BATCH // 2, 8, 8, HD, torch.float32, VALID),
    ("base tp 2 f32", BATCH, 4, 4, HD, torch.float32, VALID),
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
    # (parallel) a rank's share at global batch 4: dp 2, tp 2
    ("base dp 2 bf16", BATCH // 2, 8, 8, HD, torch.bfloat16, VALID),
    ("base tp 2 bf16", BATCH, 4, 4, HD, torch.bfloat16, VALID),
    ("base dp 2 f32", BATCH // 2, 8, 8, HD, torch.float32, VALID),
    ("base tp 2 f32", BATCH, 4, 4, HD, torch.float32, VALID),
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


# M: one row, a decode step, the verify chunk of a speculative step (batch 4
# x 5 tokens), the prefill, that chunk at batch 32 (the M > 64 route), 512
QUANT_ROWS = (1, DECODE_ROWS, 20, 48, 160, 512)
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
    projection shape and M = 1, 16 (a decode step), 20 and 160 (a
    speculative verify chunk at batch 4 and 32), 48 (the prefill) and 512,
    and at the ragged shapes. Kernel and plain version round alike and
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
    # not a multiple of the positions a block (4 x 76 cover 301)
    ("ragged 301", DECODE_ROWS, 301, 8, 8, HD),
]


def check_cross_attention(device) -> dict:
    """K5 against its plain version (same roundings, another order of sums,
    and weights that land on the other side of a bf16 tie: 1e-3 of the
    largest output), against the plain model of its own walk
    (``cross_attention_int8_walk`` under the kernel's plan: the same merge
    order, float32 sums within a block in another order, so again weights
    at a bf16 tie: 1e-3 of the largest output), against exact attention on
    the unquantized K/V (2 % of the largest output, the JAX package's
    tolerance), and with a poisoned tail beyond seq_len (1e-5); a second
    call bit-identical. Prints each case's graph time and share of the
    bound. Returns the main path's row (base)."""
    from whisperseg_torch.ops import cross_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(5)
    row = None
    for name, b, s, h, hkv, hd in CROSS_ATTENTION_CASES:
        q = torch.randn(b, h * hd, generator=gen).to(device)
        k = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to(device)
        v = (torch.randn(1, b, s, hkv, hd, generator=gen) * 0.5).to(device)
        kq, ks, vq, vs, seq = ca.quantize_kv_for_kernel(k, v)
        args = (kq[0], ks[0], vq[0], vs[0], hkv, seq, h)
        plan = ca.cross_attention_plan(b, seq, hkv, h // hkv, hd)
        got = ca.cross_attention_int8(q, *args)
        same = torch.equal(got, ca.cross_attention_int8(q, *args))
        want = ca.cross_attention_int8_reference(q, *args)
        walk = ca.cross_attention_int8_walk(q, *args, cluster=plan.cluster,
                                            per_block=plan.per_block)
        qh = q.double().reshape(b, hkv, h // hkv, hd) * hd ** -0.5
        probs = torch.softmax(
            torch.einsum("bkgd,bskd->bkgs", qh, k[0].double()), dim=-1)
        exact = torch.einsum("bkgs,bskd->bkgd", probs, v[0].double()).reshape(b, -1)
        top = exact.abs().max().item()
        err = (got - want).abs().max().item()
        err_walk = (got - walk).abs().max().item()
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
        in_graph = graph_ms(lambda: ca.cross_attention_int8(q, *args), 50)
        plain_ms = cuda_ms(lambda: ca.cross_attention_int8_reference(q, *args), 20)
        nbytes = (kq[0].numel() + vq[0].numel() + 2 * (ks[0].numel() + vs[0].numel())
                  + 2 * 4 * q.numel())
        bound_ms, bound_by = bound(nbytes, 4 * b * h * s * hd, torch.bfloat16)
        print(f"  cross_attention_int8 {name:10s} [{b}, {s}, {h}/{hkv}, {hd}]: "
              f"max|err| {err:.2e} ({err / top:.1e} of max|out|, tol 1e-3); "
              f"its own walk {err_walk / top:.1e} (tol 1e-3); against exact "
              f"attention {err_exact / top:.2e} (tol 2e-2); poisoned tail "
              f"{err_p:.1e} (tol 1e-5); second call "
              f"{'identical' if same else 'DIFFERS'}\n    kernel {ms:.4f} ms "
              f"(graph {in_graph:.4f} ms, {100 * bound_ms / in_graph:.1f} % of "
              f"the bound)  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms "
              f"({bound_by}); {plan.blocks} blocks, cluster {plan.cluster} of "
              f"{plan.per_block} positions", flush=True)
        if not (err <= 1e-3 * top and err_walk <= 1e-3 * top
                and err_exact <= 0.02 * top and err_p <= 1e-5 and same):
            raise AssertionError(f"cross_attention_int8 {name}: max|err| {err}, "
                                 f"walk {err_walk}, against exact {err_exact}, "
                                 f"poisoned {err_p}, max|out| {top}, second "
                                 f"call identical {same}")
        if name == "base":
            row = {"name": "cross_attention_int8", "route": "cuda",
                   "source": "whisperseg_torch/csrc/cross_attention_int8.cu",
                   "replaces": "whisperseg_tpu/ops/cross_attention.py:48",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   # scaled_dot_product_attention takes no int8 K/V
                   "library_ms": None}
    return row


# ----------------------------------------------------------------- audio LM

AUDIO_LM_CONFIG = os.path.join(ROOT, "perfbench", "configs",
                               "whisperseg-moonlight-a3b.json")
# (phase, rows) of the routed experts' product in the benchmark's cell: a
# beam step of batch 16 x beam 4, and a batch prefill of 16 prefixes of 503
MOE_SHAPES = (("decode", 64), ("prefill", 16 * 503))
# the routings of the check: each expert's scores offset by this many
# standard deviations, the offset shared by the tokens. 0: even; 2: the
# benchmark cell's load, whose random weights send a decode step's 384
# pairs to ~20 experts, the busiest taking ~60, and a prefill's busiest
# expert ~15 % of its pairs (PERF.md)
MOE_SKEWS = (0.0, 2.0)
MOE_CELL_SKEW = 2.0
MOE_TOL = 2e-2          # of max|plain|: the grouped products round to bf16
AUDIO_LM_SEED = 2_147_483_659
# the request of the audio-LM phase: the benchmark cell's settings
AUDIO_LM_REQUEST = {"sr": SR, "spec_time_step": SPEC_TIME_STEP,
                    "min_frequency": 0, "num_trials": 1, "num_beams": 4,
                    "batch_size": 16, "max_length": 32}


def check_moe(device, model: dict) -> list:
    """K7 (ops/moe.py: three grouped products over the pairs sorted by
    expert) against its plain version (a loop over the experts) at the
    audio LM's widths in bf16, at each of MOE_SHAPES under each of
    MOE_SKEWS: the largest difference (MOE_TOL of max|plain|), a second
    call bit-identical, the time with the routing's bookkeeping (also
    replayed from a CUDA graph) beside the least time of the work the
    routing asks for (``perfbench/roofline_moe.py``'s bytes and
    operations). Returns the rows at the cell's load (MOE_CELL_SKEW)."""
    from perfbench import roofline_moe
    from whisperseg_torch.ops import moe

    e, d, f, k = (model["n_routed_experts"], model["hidden_size"],
                  model["moe_intermediate_size"], model["num_experts_per_tok"])
    gen = torch.Generator(device=device).manual_seed(1)
    gate, up = (torch.randn(e, d, f, generator=gen, device=device)
                .mul_(d ** -0.5).to(torch.bfloat16) for _ in range(2))
    down = torch.randn(e, f, d, generator=gen, device=device).mul_(
        f ** -0.5).to(torch.bfloat16)
    rows = []
    for phase, tokens in MOE_SHAPES:
        x = torch.randn(tokens, d, generator=gen, device=device).to(
            torch.bfloat16)
        for skew in MOE_SKEWS:
            scores = (torch.randn(tokens, e, generator=gen, device=device)
                      + skew * torch.randn(e, generator=gen, device=device))
            idx = scores.topk(k, dim=-1).indices
            counts = moe.expert_counts(idx, e)

            def kernel():
                return moe.expert_mlp(x, idx, gate, up, down, counts)
            got = kernel()
            same = torch.equal(got, kernel())
            want = moe.expert_mlp_plain(x, idx, gate, up, down)
            top = want.abs().max().item()
            err = (got - want).abs().max().item()
            ms = cuda_ms(kernel, 20)
            in_graph = graph_ms(kernel, 10)
            plain_ms = cuda_ms(
                lambda: moe.expert_mlp_plain(x, idx, gate, up, down), 2)
            hit = int((counts > 0).sum())
            bound_ms, bound_by = bound(
                roofline_moe.moe_bytes(model, tokens * k, hit),
                roofline_moe.moe_flops(model, tokens * k), torch.bfloat16)
            print(f"  expert_mlp {phase:7s} [{tokens}, {d}] top {k} of {e}, "
                  f"skew {skew:g}: {hit} experts hit, the busiest "
                  f"{int(counts.max())} of {tokens * k} pairs; max|err| "
                  f"{err:.2e} ({err / top:.1e} of max|plain|, tol "
                  f"{MOE_TOL:g}); second call "
                  f"{'identical' if same else 'DIFFERS'}\n    grouped "
                  f"{ms:.4f} ms (graph {in_graph:.4f} ms, "
                  f"{100 * bound_ms / in_graph:.1f} % of the bound)  plain "
                  f"{plain_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})",
                  flush=True)
            if not (err <= MOE_TOL * top and same):
                raise AssertionError(f"expert_mlp {phase} skew {skew}: "
                                     f"max|err| {err}, max|plain| {top}, "
                                     f"second call identical {same}")
            if skew == MOE_CELL_SKEW:
                rows.append({"name": f"expert_mlp_{phase}",
                             "route": "torch._grouped_mm",
                             "source": "whisperseg_torch/ops/moe.py",
                             # the JAX package has no mixture of experts
                             "replaces": None, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": None})
    return rows


def audio_lm_phase(device) -> list:
    """The ``audio_lm`` family at Moonlight-16B-A3B's published widths (the
    benchmark's configuration, whisper-large-v2's encoder in front; random
    weights from ``perfbench/weights_audio_lm.py``): K7 checked (:func:`check_moe`), then a 30 s
    request through ``Segmenter.segment()`` by beam search at the cell's
    settings, K7's launches counted from zero over it (the prefill's and
    the captured step's), and the same request again under a profiler, for
    the expert load its ``segment.decode`` spans count. The weights are
    freed at the end. Returns K7's rows
    with that launch count."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench import weights as wt
    from perfbench import weights_audio_lm as wal
    from whisperseg_torch import profiling
    from whisperseg_torch.ops import moe
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    with open(AUDIO_LM_CONFIG) as f:
        model = json.load(f)
    rows = check_moe(device, model)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flat = wal.random_weights(model, AUDIO_LM_SEED, device, torch.bfloat16)
    seg = Segmenter(wt.tree(flat), wal.program_config(model),
                    inference_dtype="bfloat16", device=device)
    del flat
    torch.cuda.synchronize()
    print(f"  Moonlight-16B-A3B behind whisper-large-v2: weights drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    audio = tone_bursts(AUDIO_LM_SEED, sr=SR, duration=30.0)
    moe.launches = 0
    t0 = time.perf_counter()
    table = seg.segment(audio, **AUDIO_LM_REQUEST)
    wall = time.perf_counter() - t0
    launches = moe.launches
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        seg.segment(audio, **AUDIO_LM_REQUEST)
    load = {}
    for r in profiling.recorded(start, time.time_ns()):
        if r.name == "segment.decode":
            for key, v in r.counts.items():
                load[key] = load.get(key, 0) + v
    print(f"  segment() of 30 s, beam 4, batch 16: {wall:.2f} s (kernels "
          f"built, the step captured), {len(table['onset'])} segments; "
          f"grouped products launched {launches} times; expert load {load}",
          flush=True)
    if not launches > 0 or not load.get("routed_decode"):
        raise AssertionError(f"audio LM: grouped products launched "
                             f"{launches} times, expert load {load}")
    del seg
    gc.collect()
    torch.cuda.empty_cache()
    for row in rows:
        row["launches"] = launches
    return rows


# ------------------------------------------------------------------- golden


@torch.no_grad()
def top2_margins(seg, frontend, clips: np.ndarray, tokens,
                 int8_kv: bool = False) -> np.ndarray:
    """Teacher-forced decoder logits along ``tokens`` -> [N, L] gap between
    the two largest logits of the prediction made at each position. With
    ``int8_kv`` the cross K/V are int8 and the tokens after the prompt go
    one a step, as the decode loop takes them (the int8 cross-attention
    kernel's path)."""
    from whisperseg_torch import tokenizer as tok
    from whisperseg_torch.models.whisper import (decoder_step, encoder_forward,
                                                 init_cache, precompute_cross_kv)

    cfg = seg.config
    ids = torch.tensor(tokens, device=seg.device)
    feats = frontend.features_for_clips(torch.from_numpy(clips).to(seg.device),
                                        cfg.total_spec_columns)
    enc = encoder_forward(seg.params, cfg, feats)
    xk, xv = precompute_cross_kv(seg.params, cfg, enc, int8_kv=int8_kv)
    ck, cv = init_cache(cfg, ids.shape[0], ids.shape[1], seg.device)
    if not int8_kv:
        logits, _, _ = decoder_step(seg.params, cfg, xk, xv, ids,
                                    torch.tensor(0, device=seg.device), ck, cv)
    else:
        pl = len(tok.PROMPT_IDS)
        chunks = [(0, pl)] + [(t, t + 1) for t in range(pl, ids.shape[1])]
        parts = []
        for a, b in chunks:
            out, ck, cv = decoder_step(seg.params, cfg, xk, xv, ids[:, a:b],
                                       torch.tensor(a, device=seg.device),
                                       ck, cv)
            parts.append(out)
        logits = torch.cat(parts, dim=1)
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
    for it: all of them, those of a single token, and by model (the config
    object it runs with) its calls and their rows (batch x chunk)."""

    def __init__(self, decode_module):
        self.module = decode_module
        self.inner = decode_module.decoder_step
        self.calls = self.single = 0
        self.by_model = {}

    def __call__(self, params, cfg, xk, xv, input_ids, *args, **kwargs):
        self.calls += 1
        self.single += input_ids.shape[1] == 1
        calls, rows = self.by_model.get(id(cfg), (0, set()))
        self.by_model[id(cfg)] = (calls + 1, rows | {input_ids.numel()})
        return self.inner(params, cfg, xk, xv, input_ids, *args, **kwargs)

    def of(self, cfg):
        """(calls, set of row counts) of the model run with ``cfg``."""
        return self.by_model.get(id(cfg), (0, set()))

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
            if inference_dtype == "bfloat16" or int8_kv:  # the card's table, recorded
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


def card_tokens(seg, requests, int8_kv: bool = False) -> None:
    """For each request, its windows' beam-4 token ids and the top-2 logit
    margin of each prediction along them (teacher-forced), one JSON line a
    request, kept with the tables in whisperseg_torch/card_tables_bf16.json
    (card_tables_int8_kv.json with ``int8_kv``): where a table departs from
    the JAX package's, they give the first differing decode step and how
    close the card's pick was there."""
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
                                                  int(dsc["max_length"]), 4, 1.0,
                                                  int8_kv=int8_kv)]
        width = max(map(len, tokens))
        padded = [row + [tok.PAD_ID] * (width - len(row)) for row in tokens]
        margins = top2_margins(seg, frontend, clips, padded, int8_kv)
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


def mouse_frontend_stage(device) -> None:
    """The frontend stage of one batch (4 windows of 1000 columns) at the
    mouse preset (config/segment_config.json: sr 300000, spec_time_step
    0.0005, min_frequency 35000; n_fft 4096): reflect pad, framing, rfft,
    K1, floor and scaling."""
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.synthetic import tone_bursts

    sr, step = 300000, 0.0005
    fr = Frontend(sr, step, 35000)
    clips = torch.from_numpy(np.stack([
        tone_bursts(s, sr=sr, duration=1000 * step) for s in range(BATCH)])).to(device)

    def stage():
        return fr.features_for_clips(clips, 1000)
    host = sorted(timed(stage)[1] for _ in range(7))[3]
    print(f"  mouse preset, frontend of one batch ({BATCH} windows x 1000 "
          f"columns, n_fft {fr.n_fft}): {cuda_ms(stage, 20):.4f} ms a call "
          f"back to back (CUDA events), median {host * 1e3:.3f} ms synchronized "
          f"(host clock)", flush=True)


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


# ------------------------------------------------------------------ service

# (service) each request: a name, its audio as (seed, seconds) of
# ``tone_bursts``, and the body's options; sent by SERVICE_CLIENTS client
# threads at once. The audio is that of the serve phase's requests, whose
# tables are not empty in the JAX package's bf16 numerics either (the base
# model finds nothing on some other seeds' 2.5 s clips, in both packages).
# A request that needs the frame head's tracks (the shipped checkpoint's
# fitted frame post-processing, on by default) runs on its handler's thread;
# the batcher fuses the others, here those with that post-processing off.
NO_FRAME_POST = {"frame_split": 0, "frame_refine_ms": 0, "frame_filter": 0}
SERVICE_REQUESTS = [
    ("seq2seq 10 s, 3 trials (a)", (106, 10.0), {"num_trials": 3}),
    ("seq2seq 10 s, 3 trials (b)", (106, 10.0), {"num_trials": 3}),
    ("seq2seq 30 s, no frame post-processing", (101, 30.0),
     {"num_trials": 1, **NO_FRAME_POST}),
    ("seq2seq 2.5 s, no frame post-processing", (100, 2.5),
     {"num_trials": 1, **NO_FRAME_POST}),
    ("frame mode 30 s", (101, 30.0), {"frame_mode": True}),
    ("top_p 0.9, greedy 10 s", (106, 10.0), {"num_trials": 1, "num_beams": 1,
                                             "top_p": 0.9}),
    ("Adobe 10 s", (106, 10.0), {"num_trials": 1,
                                 "adobe_audition_compatible": True}),
]
SERVICE_CLIENTS = 4
SERVICE_BATCH = 8       # the service's --batch_size default


def _wav_base64(audio) -> str:
    import base64
    import io

    from whisperseg_torch.audio.io import save_wav

    buf = io.BytesIO()
    save_wav(buf, audio, SR)
    return base64.b64encode(buf.getvalue()).decode()


def _post(port: int, body: dict):
    """One request through the standard library's HTTP client -> (status,
    answer, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/segment", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        answer = json.loads(resp.read())
    finally:
        conn.close()
    return resp.status, answer, time.perf_counter() - t0


def _check_table(table: dict, duration: float, what: str,
                 collapsed: bool = False) -> None:
    """Non-empty, each segment inside the audio with onset < offset, in
    onset order. ``collapsed`` admits onset = offset: the FFT-blur
    correction collapses a segment shorter than twice its delta to its
    midpoint (the JAX package's and the reference's rule), and with the
    frame post-processing off nothing drops it."""
    onsets, offsets = table["onset"], table["offset"]
    if not onsets:
        raise AssertionError(f"{what}: empty segment table")
    if not (len(onsets) == len(offsets) == len(table["cluster"])
            and all(0 <= a <= b <= duration + 1e-6 and (collapsed or a < b)
                    for a, b in zip(onsets, offsets))
            and onsets == sorted(onsets)):
        raise AssertionError(f"{what}: malformed table {table}")


class BatchCount:
    """Counts a segmenter's device batches while it is entered: seq2seq
    batches (``_decode_batch``) on the batcher's worker thread (``fused``)
    and on any other thread (``caller``), and frame-mode batches
    (``_frame_fn``, ``frames``)."""

    def __init__(self, seg):
        self.seg = seg
        self.fused = self.caller = self.frames = 0

    def __enter__(self):
        import threading

        decode_batch, frame_fn = self.seg._decode_batch, self.seg._frame_fn
        worker = getattr(self.seg, "_worker", None)

        def counted_decode_batch(*args, **kwargs):
            if threading.current_thread() is worker:
                self.fused += 1
            else:
                self.caller += 1
            return decode_batch(*args, **kwargs)

        def counted_frame_fn(*args, **kwargs):
            self.frames += 1
            return frame_fn(*args, **kwargs)
        self.seg._decode_batch = counted_decode_batch
        self.seg._frame_fn = counted_frame_fn
        return self

    def __exit__(self, *exc):
        del self.seg._decode_batch, self.seg._frame_fn

    @property
    def batches(self) -> int:
        return self.fused + self.caller + self.frames


def service_phase(device) -> dict:
    """The HTTP segment service with its continuous batcher on the base
    checkpoint (bf16): warm-up, concurrent requests of every kind (two
    identical default ones must get identical tables), launch counts
    checked against the batcher's fused batches, the batches run on the
    handlers' threads and the frame batches, a frame-mode request with no
    decoder step, sampled and constrained decoding twice each, and the
    segment CLI with and without streaming giving identical CSV bytes.
    Returns the launch counts."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from whisperseg_torch import decode
    from whisperseg_torch.cli import segment as cli
    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.services.batching import BatchingSegmenter
    from whisperseg_torch.services.segment_service import build_app
    from whisperseg_torch.synthetic import tone_bursts

    start = time.perf_counter()
    held = torch.cuda.memory_allocated()
    base = os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad")
    seg = BatchingSegmenter.from_pretrained(base, device=device)
    seg.max_batch_size = SERVICE_BATCH
    t0 = time.perf_counter()
    seg.warmup(SR, batch_size=SERVICE_BATCH)
    torch.cuda.synchronize()
    print(f"  warm-up (kernels built or found, one seq2seq and one frame "
          f"batch) {time.perf_counter() - t0:.3f} s", flush=True)
    app = build_app(seg, SERVICE_BATCH, serialize=False)
    port = app.serve("127.0.0.1", 0, background=True).server_address[1]
    cfg = seg.config
    count = BatchCount(seg).__enter__()
    try:
        bodies = []
        for name, (seed, duration), options in SERVICE_REQUESTS:
            bodies.append({"audio_file_base64_string": _wav_base64(
                tone_bursts(seed, duration=duration)), "sr": SR, **options})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logmel.launches = attention.launches = 0
        fused = seg.fused_batches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_CLIENTS) as pool:
            answers = list(pool.map(lambda b: _post(port, b), bodies))
        wall = time.perf_counter() - t0
        for (name, (_, duration), options), (status, answer, dt) in zip(
                SERVICE_REQUESTS, answers):
            print(f"  request {name}: {status} in {dt:.3f} s "
                  f"({duration / dt:.1f} audio-s/s), "
                  f"{len(answer.get('Start', answer.get('onset', [])))} "
                  f"segments", flush=True)
            if status != 201:
                raise AssertionError(f"{name}: status {status}")
            if options.get("adobe_audition_compatible"):
                if not answer["Start"]:
                    raise AssertionError(f"{name}: empty cue table")
            else:
                _check_table(answer, duration, name,
                             collapsed=options.get("frame_filter") == 0)
        if answers[0][1] != answers[1][1]:
            raise AssertionError(f"two identical default requests sent at "
                                 f"once differ: {answers[0][1]} and "
                                 f"{answers[1][1]}")
        print(f"  the two identical default requests: identical tables "
              f"({len(answers[0][1]['onset'])} segments)", flush=True)
        audio_s = sum(duration for _, (_, duration), _ in SERVICE_REQUESTS)
        print(f"  {len(bodies)} requests from {SERVICE_CLIENTS} clients at "
              f"once: {audio_s:.1f} s of audio in {wall:.3f} s "
              f"({audio_s / wall:.1f} audio-s/s); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)

        # a frame-mode request alone: the encoder and the frame head only
        with StepCount(decode) as steps:
            status, answer, dt = _post(port, bodies[4])
        print(f"  frame mode 30 s alone: {status} in {dt:.3f} s, "
              f"{steps.calls} decoder steps", flush=True)
        if status != 201 or steps.calls != 0:
            raise AssertionError(f"frame-mode request: status {status}, "
                                 f"{steps.calls} decoder steps")

        # sampling and constrained decoding through the same segmenter
        audio = tone_bursts(106, duration=10.0)
        for kw in (dict(constrained=True, num_beams=1),
                   dict(top_k=5, seed=1, num_beams=1)):
            tables = [seg.segment(audio, SR, num_trials=1, **kw)
                      for _ in range(2)]
            _check_table(tables[0], 10.0, f"segment({kw})")
            if tables[0] != tables[1]:
                raise AssertionError(f"segment({kw}) differs between runs")
            print(f"  segment({kw}): {len(tables[0]['onset'])} segments, "
                  f"the same twice", flush=True)
        counts = {"melproject": logmel.launches,
                  "attention_hm": attention.launches}
        want = {"melproject": count.batches,
                "attention_hm": count.batches * cfg.encoder_layers}
        print(f"  launches {counts}: {count.fused} fused batches of the "
              f"batcher, {count.caller} batches on the handlers' threads, "
              f"{count.frames} frame batches", flush=True)
        if counts != want or count.fused != seg.fused_batches - fused:
            raise AssertionError(f"service launch counts {counts}, want "
                                 f"{want}; batcher {seg.fused_batches - fused} "
                                 f"fused batches, counted {count.fused}")
    finally:
        count.__exit__()
        app.shutdown()
        seg.close()

    # the segment CLI on a 60 s recording, whole and streamed: the energy
    # refinement needs the whole audio (streaming skips it), so the whole
    # run turns it off
    with tempfile.TemporaryDirectory() as tmp:
        from whisperseg_torch.audio.io import save_wav

        wav = os.path.join(tmp, "rec.wav")
        save_wav(wav, tone_bursts(101, duration=60.0), SR)
        argv = ["--model_path", base, "--audio_path", wav,
                "--refine_boundaries_ms", "0"]
        outs = {}
        for name, extra in (("whole", []),
                            ("streamed", ["--streaming", "1",
                                          "--chunk_seconds", "20"])):
            out = os.path.join(tmp, f"{name}.csv")
            t0 = time.perf_counter()
            cli.main(argv + extra + ["--csv_save_path", out])
            with open(out, "rb") as f:
                outs[name] = f.read()
            rows = outs[name].count(b"\n") - 1
            print(f"  segment CLI, 60 s recording, {name}: {rows} segments in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        if outs["whole"] != outs["streamed"] or rows < 1:
            raise AssertionError(f"CLI CSVs differ or are empty: {outs}")
    # the worker held the segmenter: with it stopped, its weights and the
    # handler threads' cuBLAS workspaces go, so that the later phases' peaks
    # measure their own segmenters
    del seg, app, count
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    print(f"  device memory allocated before the phase {held / 2**20:.1f} "
          f"MiB, after it {torch.cuda.memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    print(f"  service phase {time.perf_counter() - start:.1f} s", flush=True)
    return counts


# ------------------------------------------------------------------ backend

BACKEND_MODEL = "whisperseg-base-animal-vad"
BACKEND_TRAIN_ITERATIONS = 30   # the fine-tune's cap (its shim's floor)
BACKEND_TRAIN_LIMIT_S = 600     # the fine-tuned model must be ready by then

# run by the backend's worker as its train_script, in a subprocess: the
# train CLI with the iteration cap, then its kernel launches to a file
BACKEND_TRAIN_SHIM = """import json, sys
from whisperseg_torch.cli.train import main
from whisperseg_torch.ops import attention, logmel
main(sys.argv[1:] + ["--min_num_iterations", "{iterations}",
                     "--print_every", "10"])
with open({launches_path!r}, "w") as f:
    json.dump({{"melproject": logmel.launches,
               "attention_hm_lse": attention.launches_lse,
               "attention_hm_bwd_dkv": attention.launches_bwd_dkv,
               "attention_hm_bwd_dq": attention.launches_bwd_dq}}, f)
"""


def _post_form(port: int, path: str, fields: dict, files: dict = None):
    """One multipart/form-data POST -> (status, answer, seconds)."""
    import http.client
    import uuid

    boundary = uuid.uuid4().hex
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="{k}"\r\n\r\n{v}\r\n'.encode() for k, v in fields.items()]
    for k, (filename, payload) in (files or {}).items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"; filename="{filename}"\r\n\r\n'.encode()
                     + payload + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body, {
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        answer = json.loads(resp.read())
    finally:
        conn.close()
    return resp.status, answer, time.perf_counter() - t0


def _check_form_table(table: dict, duration: float, what: str) -> None:
    """A well-formed table, empty or not, collapsed segments admitted (a
    model without fitted frame post-processing keeps them)."""
    if set(table) != {"onset", "offset", "cluster"}:
        raise AssertionError(f"{what}: not a segment table: {table}")
    if table["onset"]:
        _check_table(table, duration, what, collapsed=True)


def backend_phase(device) -> dict:
    """The model-zoo backend (``services/backend.py``) on 127.0.0.1 with the
    shipped base checkpoint as a built-in model (bf16) and its training
    worker running: /segment with a WAV and a FLAC of one 10 s recording
    must answer 200 and tables identical to each other and to
    ``Segmenter.segment()`` on the decoded samples with the backend's
    arguments; then frame mode on the FLAC and a crafted MP3; the mel kernel
    must launch once a batch and the attention kernel once an encoder layer
    a batch. Then a fine-tune over HTTP (``client.train``: a zip of three
    FLAC recordings with CSV labels) that the worker runs as a subprocess on
    the card, capped at BACKEND_TRAIN_ITERATIONS steps: it must exit 0,
    launch the attention kernel (with the row log-sum-exp) and both backward
    kernels once an encoder layer a step, and its model must be listed ready
    within BACKEND_TRAIN_LIMIT_S and answer /segment with a table. Returns
    the segment requests' launch counts of K1 and K2."""
    import io
    import tempfile
    import threading
    import zipfile

    from whisperseg_torch.audio.io import load_audio
    from whisperseg_torch.hub import builtin_models
    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.services import client
    from whisperseg_torch.services.backend import BackendState, build_app
    from whisperseg_torch.synthetic import (audio_bytes, crafted_mp3,
                                            tone_bursts, tone_dataset_zip)

    card = card_line()
    start = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    models = builtin_models()
    pretrained = [{"model_name": name, "inference_model_path": path,
                   "finetune_model_path": path}
                  for name, path in models.items()]
    with tempfile.TemporaryDirectory() as tmp:
        shim = os.path.join(tmp, "train_capped.py")
        launches_path = os.path.join(tmp, "train_launches.json")
        with open(shim, "w") as f:
            f.write(BACKEND_TRAIN_SHIM.format(
                iterations=BACKEND_TRAIN_ITERATIONS,
                launches_path=launches_path))
        state = BackendState(os.path.join(tmp, "datasets"),
                             os.path.join(tmp, "models"),
                             pretrained_models=pretrained, train_script=shim,
                             device=device)
        app = build_app(state)
        port = app.serve("127.0.0.1", 0, background=True).server_address[1]
        for target in (state.run_training_worker, state.periodic_list_models):
            threading.Thread(target=target, daemon=True).start()
        seg = state.get_segmenter(BACKEND_MODEL, models[BACKEND_MODEL])
        layers = seg.config.encoder_layers
        count = BatchCount(seg).__enter__()
        try:
            audio = tone_bursts(106, duration=10.0)
            uploads = {fmt: audio_bytes(audio, SR, fmt)
                       for fmt in ("wav", "flac")}
            logmel.launches = attention.launches = 0
            answers = {}
            for fmt, body in uploads.items():
                status, answer, dt = _post_form(
                    port, "/segment",
                    {"model_name": BACKEND_MODEL, "num_trials": 1},
                    {"audio_file": (f"rec.{fmt}", body)})
                print(f"  /segment {fmt.upper()} 10 s ({len(body)} bytes): "
                      f"{status} in {dt:.3f} s, "
                      f"{len(answer.get('onset', []))} segments [{card}]",
                      flush=True)
                if status != 200:
                    raise AssertionError(f"/segment {fmt}: {status} {answer}")
                _check_table(answer, 10.0, f"/segment {fmt}")
                answers[fmt] = answer
            samples, sr = load_audio(io.BytesIO(uploads["flac"]))
            want = json.loads(json.dumps(
                seg.segment(samples, sr, num_trials=1, batch_size=8)))
            if not answers["wav"] == answers["flac"] == want:
                raise AssertionError(f"WAV {answers['wav']}, FLAC "
                                     f"{answers['flac']}, segment() {want}")
            print("  the WAV's and the FLAC's tables are identical, and equal "
                  "to segment() on the decoded samples", flush=True)
            for what, fields, upload, duration in (
                    ("FLAC, frame_mode=1", {"frame_mode": 1},
                     ("rec.flac", uploads["flac"]), 10.0),
                    ("crafted MP3 5 s", {"num_trials": 1},
                     ("rec.mp3", crafted_mp3(107, 5.0, SR)), 5.0)):
                status, answer, dt = _post_form(
                    port, "/segment", {"model_name": BACKEND_MODEL, **fields},
                    {"audio_file": upload})
                print(f"  /segment {what}: {status} in {dt:.3f} s, "
                      f"{len(answer.get('onset', []))} segments [{card}]",
                      flush=True)
                if status != 200:
                    raise AssertionError(f"/segment {what}: {status} {answer}")
                _check_form_table(answer, duration, f"/segment {what}")
            counts = {"melproject": logmel.launches,
                      "attention_hm": attention.launches}
            print(f"  launches {counts}: {count.caller} seq2seq batches, "
                  f"{count.frames} frame batches", flush=True)
            if counts != {"melproject": count.batches,
                          "attention_hm": layers * count.batches} \
                    or not count.batches:
                raise AssertionError(f"backend launch counts {counts} for "
                                     f"{count.batches} batches")
        finally:
            count.__exit__()

        # fine-tune over HTTP; the worker polls its queue every 5 s
        name = "tones-finetuned"
        t0 = time.perf_counter()
        dataset = os.path.join(tmp, "upload")  # the user's folder
        with zipfile.ZipFile(io.BytesIO(tone_dataset_zip(
                3, seed=700, sr=SR, duration=10.0))) as zf:
            zf.extractall(dataset)
        answer = client.train(f"127.0.0.1:{port}", dataset, name,
                              initial_model_name=BACKEND_MODEL, num_epochs=1)
        if answer != {"message": "Training"}:
            raise AssertionError(f"/submit-training-request: {answer}")
        ready, log = [], {}
        while time.perf_counter() - t0 < BACKEND_TRAIN_LIMIT_S:
            _, listed, _ = _post_form(
                port, "/list-models-available-for-inference", {})
            ready = [m["model_name"] for m in listed["response"]]
            log = state.training_log[-1] if state.training_log else {}
            if name in ready or log.get("exit_code", 0) != 0:
                break
            time.sleep(1)
        wall = time.perf_counter() - t0
        final = os.path.join(tmp, "models", name, "final_checkpoint")
        steps = None
        if os.path.exists(os.path.join(final, "config.json")):
            with open(os.path.join(final, "config.json")) as f:
                steps = json.load(f).get("current_step")
        print(f"  fine-tune: exit code {log.get('exit_code')}, {steps} "
              f"iterations, subprocess {log.get('seconds') or 0:.1f} s, ready "
              f"for inference {wall:.1f} s after the request [{card}]",
              flush=True)
        if log.get("exit_code") != 0 or name not in ready:
            raise AssertionError(f"fine-tune: log {state.training_log}, "
                                 f"ready {ready}")
        with open(launches_path) as f:
            sub = json.load(f)
        print(f"  the fine-tune subprocess's launches {sub}", flush=True)
        per_step = layers * steps
        if not (sub["attention_hm_lse"] == sub["attention_hm_bwd_dkv"]
                == sub["attention_hm_bwd_dq"] == per_step
                and sub["melproject"] > 0):
            raise AssertionError(f"fine-tune launches {sub}, want "
                                 f"{per_step} of each attention kernel")
        status, answer, dt = _post_form(
            port, "/segment", {"model_name": name, "num_trials": 1},
            {"audio_file": ("rec.flac", uploads["flac"])})
        print(f"  /segment with {name}: {status} in {dt:.3f} s, "
              f"{len(answer.get('onset', []))} segments [{card}]", flush=True)
        if status != 200:
            raise AssertionError(f"/segment with {name}: {status} {answer}")
        _check_form_table(answer, 10.0, f"/segment with {name}")
        app.shutdown()
        state.release_segmenters()
    del seg, count
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    print(f"  device memory allocated before the phase {held / 2**20:.1f} "
          f"MiB, after it {torch.cuda.memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    print(f"  backend phase {time.perf_counter() - start:.1f} s [{card}]",
          flush=True)
    return counts


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
    step: every step is synchronized and timed, its loss read (under a
    process group, the ranks' shares summed), its launches of the
    encoder-attention kernels counted, and steps ``profiled`` run under
    torch.profiler. The first step's gradient norm over the whole model is
    kept (``grad_norm``, and each leaf's in ``grad_leaves``), and with
    ``keep_init`` the parameters it started from (``init``, whole, on the
    host). ``scale`` multiplies every batch's input features (a control:
    1 + 1e-6 perturbs each step's arithmetic and nothing else).
    ``VocalSegDataset.collate`` calls are counted too: each collated batch
    must launch the mel kernel once."""

    def __init__(self, profiled=None, keep_init=False, scale=1.0):
        from whisperseg_torch.data import VocalSegDataset
        from whisperseg_torch.training import trainer

        self.trainer, self.dataset_cls = trainer, VocalSegDataset
        self.profiled, self.keep_init = profiled, keep_init
        self.scale = scale
        self.grad_norm, self.grad_leaves, self.init = None, None, None
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
            probe.optimizer = args[1]
            parallel = kwargs.get("parallel")

            def timed_step(params, batch, gen):
                i = len(probe.times)
                if probe.scale != 1.0:
                    batch = dict(batch, input_features=batch["input_features"]
                                 * probe.scale)
                if i == 0 and probe.keep_init:
                    probe.init = {k: v.detach().cpu().clone()
                                  for k, v in probe.trainer._leaves(params)}
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
                whole = loss if parallel is None else parallel.sum_data(loss)
                probe.losses.append(float(whole))
                if i == 0:
                    probe.grad_leaves = grad_norms(params, parallel)
                    probe.grad_norm = float(np.sqrt(sum(
                        x * x for x in probe.grad_leaves.values())))
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


def grad_norms(params, parallel=None) -> dict:
    """Each leaf's gradient norm over the whole model (``.grad``, float64
    sums): under ``parallel`` (trainer._Parallel) the parts of a leaf cut
    across ranks are summed over the ranks (a collective)."""
    import torch.distributed as dist

    from whisperseg_torch.training.trainer import _leaves

    cut = parallel.shards(params) if parallel is not None else {}
    names, sq = [], []
    for name, leaf in _leaves(params):
        names.append(name)
        own = leaf.grad is not None and (parallel is None or leaf in cut
                                         or parallel.groups.rank == 0)
        sq.append(leaf.grad.double().square().sum().cpu() if own
                  else torch.zeros((), dtype=torch.float64))
    total = torch.stack(sq)
    if parallel is not None:
        dist.all_reduce(total)
    return dict(zip(names, total.sqrt().tolist()))


def train_argv(data: str, model_folder: str, steps: int, extra=()) -> list:
    """The train CLI's arguments for ``steps`` steps on the shipped base
    checkpoint (bf16 compute as shipped, float32 master weights, AdamW, the
    CLI's default frame head), batch 4 of 2.5 s clips, lr 1e-4."""
    return ["--initial_model_path", BASE_MODEL, "--model_folder", model_folder, "--train_dataset_folder", data,
            "--max_num_iterations", str(steps), "--batch_size", str(BATCH),
            "--total_spec_columns", "1000", "--max_length", "100",
            "--learning_rate", "1e-4", "--warmup_steps", "5",
            "--print_every", "5", "--num_workers", "4", *extra]


def train_run(data: str, model_folder: str, steps: int, extra=(),
              profiled=None) -> StepProbe:
    """``whisperseg_torch.cli.train.main`` with :func:`train_argv`'s
    arguments, under a ``StepProbe``."""
    from whisperseg_torch.cli import train as train_cli

    with StepProbe(profiled) as probe:
        train_cli.main(train_argv(data, model_folder, steps, extra))
    return probe


def train_phase(device) -> dict:
    """Trains the base checkpoint at full width on a synthetic tone dataset
    through the train CLI, then answers one request with the result. Fails
    unless every step launches K2 once per encoder layer (twice under
    remat) and each backward kernel once per layer, every batch the mel
    kernel once, no library attention kernel (SDPA, cuDNN) runs in the
    profiled steps, every loss is finite and the last five steps' mean loss
    is below the first five's. Returns the launches of K2 with the row
    log-sum-exp (all of a step's K2 launches) and of the backward kernels,
    and the median step time in ms."""
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
    return train_launches, med


# ------------------------------------------------------------- speculative

BASE_MODEL = os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad")
TINY_MODEL = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
SPEC_K = 4
# (speculative) the serve phase's 10 s and 30 s audio, one trial each
SPEC_REQUESTS = [(106, 10.0), (101, 30.0)]
SPEC_MARGIN = 0.5  # a bf16 departure from greedy above this top-2 gap fails


def _acceptance(stats: dict, before: dict) -> float:
    """Mean tokens a row committed a target forward since ``before``."""
    rows = int(stats["row_forwards"]) - int(before.get("row_forwards", 0))
    return (int(stats["committed"]) - int(before.get("committed", 0))) / max(rows, 1)


def _first_differences(seg, frontend, clips, want, got) -> list:
    """(window, position, top-2 logit margin of the prediction there, along
    ``want``) of each window whose tokens ``got`` departs from ``want``."""
    from whisperseg_torch import tokenizer as tok

    out = [(w, next(t for t, (a, b) in enumerate(zip(g, x)) if a != b))
           for w, (g, x) in enumerate(zip(got, want)) if g != x]
    if not out:
        return []
    rows = [r[:r.index(tok.EOT_ID) + 1] if tok.EOT_ID in r else r for r in want]
    width = max(map(len, rows))
    margins = top2_margins(seg, frontend, clips,
                           [r + [tok.PAD_ID] * (width - len(r)) for r in rows])
    return [(w, t, float(margins[w, t - 1])) for w, t in out]


def speculative_phase(device) -> dict:
    """Greedy speculative decoding (``Segmenter.set_draft_model``): the
    tiny checkpoint drafting for itself at float32 must give plain greedy's
    token ids on the golden request; the base checkpoint (bf16 as shipped)
    with the tiny one drafting answers the serve phase's 10 s and 30 s audio
    with one trial, timed beside plain greedy ``segment(num_beams=1)`` in
    turns, each window's tokens held to greedy's (a departure fails only
    where the top-2 logit margin is above SPEC_MARGIN); every batch launches
    the mel kernel twice (the decode and the frame head's second pass) and
    the attention kernel once a layer of the target's encoder, the draft's
    and the frame pass's; then an int8 target, whose w8a16 kernel must run
    at the verify chunk's M (48 launches a target call), and the segment
    CLI with ``--draft_model_path``. Returns the launch counts."""
    import tempfile

    from whisperseg_torch import decode
    from whisperseg_torch import segmenter as segmenter_module
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.audio.io import save_wav
    from whisperseg_torch.checkpoint import load_checkpoint
    from whisperseg_torch.cli import segment as segment_cli
    from whisperseg_torch.ops import attention, logmel, quant
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    start = time.perf_counter()
    # float32: the tiny checkpoint drafting for itself on the golden request
    with open(os.path.join(ROOT, "whisperseg_torch", "golden_tiny.json")) as f:
        req = json.load(f)["request"]
    params, cfg = load_checkpoint(TINY_MODEL)
    cfg.compute_dtype = "float32"
    seg = Segmenter(params, cfg, inference_dtype="float32", device=device)
    dsc = seg.default_segmentation_config
    clips, _ = seg.slice_audio_windows(
        tone_bursts(req["seed"], sr=req["sr"], duration=req["duration"]),
        req["sr"], dsc["spec_time_step"], req["num_trials"])
    frontend = Frontend(req["sr"], dsc["spec_time_step"], dsc["min_frequency"])
    max_length = int(dsc["max_length"])
    greedy = seg._generate_tokens(clips, frontend, BATCH, max_length, 1, 1.0)
    seg.set_draft_model(TINY_MODEL, spec_k=SPEC_K)  # prints its warning once
    os.environ["WS_SPEC_NO_WARN"] = "1"
    spec = seg._generate_tokens(clips, frontend, BATCH, max_length, 1, 1.0)
    same = sum(a == b for a, b in zip(spec, greedy))
    print(f"  float32, tiny drafting for tiny: {same} of {len(greedy)} windows' "
          f"token ids identical to plain greedy; "
          f"{_acceptance(seg.spec_stats, {}):.2f} tokens a row committed a "
          f"target forward", flush=True)
    if spec != greedy:
        raise AssertionError("float32 speculative ids differ from greedy")
    del seg

    # bf16: the base checkpoint with the tiny one drafting
    target = Segmenter.from_pretrained(BASE_MODEL, device=device)
    target.set_draft_model(TINY_MODEL, spec_k=SPEC_K)
    draft = target.draft
    dsc = target.default_segmentation_config
    frontend = Frontend(SR, dsc["spec_time_step"], dsc["min_frequency"])
    max_length = int(dsc["max_length"])
    warm = tone_bursts(99, duration=2.5)
    for on in (False, True):
        target.draft = draft if on else None
        target.segment(warm, SR, num_beams=1)
    counts = {}
    for seed, duration in SPEC_REQUESTS:
        audio = tone_bursts(seed, duration=duration)
        clips, _ = target.slice_audio_windows(audio, SR, SPEC_TIME_STEP, 1)
        batches = -(-len(clips) // BATCH)
        times = {False: [], True: []}
        for on in (False, True, True, False):  # in turns
            target.draft = draft if on else None
            before = dict(target.spec_stats)
            logmel.launches = attention.launches = 0
            with StepCount(decode) as steps:
                table, dt = timed(lambda: target.segment(audio, SR,
                                                         num_beams=1))
            times[on].append(dt)
            if on:
                accepted = _acceptance(target.spec_stats, before)
                spec_table = table
                spec_steps = (steps.of(target.config)[0],
                              steps.of(draft[1])[0])
                k1, k2 = logmel.launches, attention.launches
            else:
                plain_table = table
        plain_ms, spec_ms = min(times[False]) * 1e3, min(times[True]) * 1e3
        print(f"  request seed {seed}: {duration:4.1f} s, {len(clips)} windows "
              f"({batches} batches): greedy {plain_ms:.1f} ms, speculative "
              f"{spec_ms:.1f} ms (x{plain_ms / spec_ms:.2f} of greedy's speed); "
              f"{accepted:.2f} tokens a row committed a target forward; "
              f"segments {len(plain_table['onset'])} greedy, "
              f"{len(spec_table['onset'])} speculative; launches K1 {k1}, K2 "
              f"{k2}; decoder steps target {spec_steps[0]}, draft "
              f"{spec_steps[1]}", flush=True)
        # the target's encoder and the draft's on the decode batches, the
        # target's again on the frame pass's
        want_k2 = batches * (draft[1].encoder_layers
                             + 2 * target.config.encoder_layers)
        if (k1, k2) != (2 * batches, want_k2):
            raise AssertionError(f"speculative launches K1 {k1}, K2 {k2}; want "
                                 f"{2 * batches}, {want_k2}")
        target.draft = None
        greedy = target._generate_tokens(clips, frontend, BATCH, max_length, 1,
                                         1.0)
        target.draft = draft
        spec = target._generate_tokens(clips, frontend, BATCH, max_length, 1,
                                       1.0)
        diffs = _first_differences(target, frontend, clips, greedy, spec)
        print(f"    tokens: {len(clips) - len(diffs)} of {len(clips)} windows "
              f"identical to greedy; first differences (window, position, "
              f"top-2 margin): {[(w, t, round(m, 4)) for w, t, m in diffs]}",
              flush=True)
        if any(m > SPEC_MARGIN for _, _, m in diffs):
            raise AssertionError(f"speculative tokens depart from greedy "
                                 f"beyond a near tie: {diffs}")
        if not spec_table["onset"]:
            raise AssertionError(f"request seed {seed}: empty table")
        counts = {"melproject": k1, "attention_hm": k2}

    # an int8 target: the verify chunk's products on the w8a16 kernel
    qtarget = Segmenter.from_pretrained(BASE_MODEL, inference_dtype="int8",
                                        device=device)
    qtarget.set_draft_model(TINY_MODEL, spec_k=SPEC_K)
    qtarget.segment(warm, SR, num_beams=1)
    quant.launches_w8a16 = 0
    audio = tone_bursts(106, duration=10.0)
    with StepCount(decode) as steps:
        table, dt = timed(lambda: qtarget.segment(audio, SR, num_beams=1))
    k3, (calls, rows) = quant.launches_w8a16, steps.of(qtarget.config)
    print(f"  int8 target, 10 s: {len(table['onset'])} segments in "
          f"{dt * 1e3:.1f} ms; w8a16 launches {k3} over {calls} target calls "
          f"at M {sorted(rows)}", flush=True)
    if k3 != 8 * qtarget.config.decoder_layers * calls \
            or BATCH * (SPEC_K + 1) not in rows:
        raise AssertionError(f"int8 target: w8a16 launches {k3} for {calls} "
                             f"calls at M {sorted(rows)}")
    counts["qdot_w8a16"] = k3

    # the segment CLI with --draft_model_path
    inner, used = segmenter_module.generate_speculative, []

    def counted(*args, **kwargs):
        used.append(1)
        return inner(*args, **kwargs)
    segmenter_module.generate_speculative = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav, csv_path = os.path.join(tmp, "rec.wav"), os.path.join(tmp, "o.csv")
            save_wav(wav, tone_bursts(101, duration=30.0), SR)
            t0 = time.perf_counter()
            segment_cli.main(["--model_path", BASE_MODEL, "--audio_path", wav,
                              "--csv_save_path", csv_path, "--num_beams", "1",
                              "--draft_model_path", TINY_MODEL, "--spec_k",
                              str(SPEC_K)])
            dt = time.perf_counter() - t0
            with open(csv_path) as f:
                lines = f.read().splitlines()
    finally:
        segmenter_module.generate_speculative = inner
    print(f"  segment CLI --draft_model_path, 30 s: {len(lines) - 1} rows in "
          f"{dt:.2f} s, {len(used)} speculative batches", flush=True)
    if len(lines) < 2 or not used:
        raise AssertionError(f"segment CLI with a draft: {lines[:3]}, {used}")
    print(f"  speculative phase {time.perf_counter() - start:.1f} s",
          flush=True)
    return counts


# ------------------------------------------------------------ train options

OPTION_STEPS = 15        # profile_dir traces steps 10-14
GQA_STEPS = 80           # lr 2e-4: the mean-pooled K/V heads need them
POOL_STEPS = 20          # two epoch blocks: 8 files x 5 crops, batch 4


def _state_bytes(optimizer) -> int:
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


class BlockProbe:
    """Stands in for ``pretrain.build_scan_train_step`` while entered: each
    call (one epoch block, or one pretraining call) is synchronized and
    timed, and the launches of K1 since the previous call (the block's
    collate) and of K2, dkv and dq in the call are recorded."""

    def __init__(self):
        from whisperseg_torch import pretrain

        self.module = pretrain
        self.blocks = []

    def __enter__(self):
        from whisperseg_torch.ops import attention, logmel

        self.inner = self.module.build_scan_train_step
        logmel.launches = attention.launches = attention.launches_lse = 0
        attention.launches_bwd_dkv = attention.launches_bwd_dq = 0
        probe, mark = self, [0]

        def build(*args, **kwargs):
            multi = probe.inner(*args, **kwargs)

            def timed_multi(params, pool, idx, gen):
                k1 = logmel.launches - mark[0]
                before = (attention.launches_lse, attention.launches_bwd_dkv,
                          attention.launches_bwd_dq)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = multi(params, pool, idx, gen)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                after = (attention.launches_lse, attention.launches_bwd_dkv,
                         attention.launches_bwd_dq)
                mark[0] = logmel.launches
                probe.blocks.append({
                    "steps": int(idx.shape[0]), "s": dt, "k1": k1,
                    "k2_dkv_dq": tuple(a - b for a, b in zip(after, before)),
                    "losses": losses.tolist(),
                    "pool_mib": pool["input_features"].numel() * 4 / 2 ** 20})
                return losses
            return timed_multi

        self.module.build_scan_train_step = build
        return self

    def __exit__(self, *exc):
        self.module.build_scan_train_step = self.inner


def train_options_phase(device, adamw_step_ms: float) -> None:
    """The trainer's options on the base checkpoint at full width and
    depth, through the train CLI: (1) ``--optimizer adafactor --qat_bits 8
    --profile_dir`` for OPTION_STEPS steps: a Chrome trace written, losses
    finite and falling, K2 (with the row log-sum-exp), dkv and dq once a
    layer a step; its optimizer state beside AdamW's, and both optimizers'
    step alone; (2) ``--gqa_kv_heads 2 --synth_augment 4`` for GQA_STEPS
    steps, the same launches at group 4, then its checkpoint answers a
    request in bf16 (K2 at group 4) and in int8 with ``int8_kv`` (K5 at
    GQA, once a layer a single-token step) with non-empty tables; (3)
    ``--device_pool 1`` for POOL_STEPS steps: each block launches K1 once
    (one frontend configuration) and K2, dkv and dq once a layer a step,
    and its steps/s beside the per-step loader's."""
    import tempfile

    from whisperseg_torch import decode
    from whisperseg_torch.cli import train as train_cli
    from whisperseg_torch.ops import attention, cross_attention, logmel, quant
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts, write_tone_dataset
    from whisperseg_torch.training import trainer

    with open(os.path.join(BASE_MODEL, "config.json")) as f:
        layers = json.load(f)["encoder_layers"]
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_tone_dataset(os.path.join(tmp, "data"), TRAIN_FILES,
                                  seed=500)
        # (1) adafactor + QAT 8 + the profiler hook
        trace_dir = os.path.join(tmp, "trace")
        torch.cuda.reset_peak_memory_stats()
        probe = train_run(data, os.path.join(tmp, "adafactor"), OPTION_STEPS,
                          extra=("--optimizer", "adafactor", "--qat_bits", "8",
                                 "--profile_dir", trace_dir))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        losses = probe.losses
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        med = float(np.median([t * 1e3 for t in probe.times[TRAIN_TIMED_FROM:]]))
        opt = probe.optimizer
        n_params = sum(p.numel() for g in opt.param_groups for p in g["params"])
        factored = _state_bytes(opt)
        adamw = torch.optim.AdamW(
            [{"params": g["params"], "weight_decay": g["weight_decay"]}
             for g in opt.param_groups], lr=1e-4)
        adafactor_ms = cuda_ms(opt.step, 5)
        adamw_ms = cuda_ms(adamw.step, 5)
        # QAT's own cost: the base model's 16 stacked projection leaves put
        # on their int8 grid, as every step's forward does
        with open(os.path.join(BASE_MODEL, "config.json")) as f:
            d = json.load(f)["d_model"]
        shapes = [(layers, d, d)] * 12 + [(layers, d, 4 * d),
                                          (layers, 4 * d, d)] * 2
        leaves = [torch.randn(sh, device=device) for sh in shapes]
        qat_ms = cuda_ms(lambda: [quant.ste_quant8(w) for w in leaves], 5)
        del leaves
        print(f"  adafactor + QAT 8: {len(losses)} steps, median {med:.2f} ms a "
              f"step (AdamW, the train phase: {adamw_step_ms:.2f} ms); loss "
              f"first 5 {first:.4f}, last 5 {last:.4f}; launches per step (K2, "
              f"dkv, dq) {sorted(set(probe.launches))}; trace files {traces}; "
              f"peak {peak:.0f} MiB", flush=True)
        print(f"  optimizer state for {n_params} parameters: adafactor "
              f"{factored / 2 ** 20:.2f} MiB, AdamW {_state_bytes(adamw) / 2 ** 20:.2f}"
              f" MiB (after one step); optimizer step alone (CUDA events): "
              f"adafactor {adafactor_ms:.3f} ms, AdamW {adamw_ms:.3f} ms; "
              f"the int8 grid of the 16 projection leaves {qat_ms:.3f} ms",
              flush=True)
        del adamw
        if not traces or not all(np.isfinite(losses)) or not last < first \
                or set(probe.launches) != {(layers, layers, layers)}:
            raise AssertionError(f"adafactor + QAT run: traces {traces}, losses "
                                 f"{losses}, launches {probe.launches}")

        # (2) GQA uptraining with splice synthesis
        gqa = train_run(data, os.path.join(tmp, "gqa"), GQA_STEPS,
                        extra=("--gqa_kv_heads", "2", "--synth_augment", "4",
                               "--learning_rate", "2e-4"))
        gmed = float(np.median([t * 1e3 for t in gqa.times[TRAIN_TIMED_FROM:]]))
        print(f"  GQA 8/2 + 4 synthesized files: {len(gqa.losses)} steps, median "
              f"{gmed:.2f} ms a step; loss first 5 "
              f"{np.mean(gqa.losses[:5]):.4f}, last 5 "
              f"{np.mean(gqa.losses[-5:]):.4f}; launches per step "
              f"{sorted(set(gqa.launches))}", flush=True)
        if set(gqa.launches) != {(layers, layers, layers)} \
                or not all(np.isfinite(gqa.losses)):
            raise AssertionError(f"GQA run: launches {gqa.launches}, losses "
                                 f"{gqa.losses}")
        final = os.path.join(tmp, "gqa", "final_checkpoint")
        # the first training recording (a short uptraining leaves held-out
        # audio without segments more often than not)
        audio = tone_bursts(500, duration=10.0)
        for dtype, int8_kv in (("bfloat16", False), ("int8", True)):
            gseg = Segmenter.from_pretrained(final, inference_dtype=dtype,
                                             device=device)
            gseg.segment(tone_bursts(99, duration=2.5), SR, int8_kv=int8_kv)
            logmel.launches = attention.launches = cross_attention.launches = 0
            quant.launches_w8a16 = 0
            with StepCount(decode) as steps:
                table, dt = timed(lambda: gseg.segment(audio, SR,
                                                       int8_kv=int8_kv))
            k1, k2, k5 = logmel.launches, attention.launches, cross_attention.launches
            print(f"  the GQA checkpoint (kv_heads {gseg.config.kv_heads}), "
                  f"{dtype}{' + int8_kv' if int8_kv else ''}: 10 s -> "
                  f"{len(table['onset'])} segments in {dt:.3f} s; launches K1 "
                  f"{k1}, K2 {k2}, K3 {quant.launches_w8a16}, K5 {k5} "
                  f"({steps.single} single-token steps)", flush=True)
            want_k5 = layers * steps.single if int8_kv else 0
            if gseg.config.kv_heads != 2 or k2 != layers * k1 or k5 != want_k5 \
                    or not k1 or not table["onset"]:
                raise AssertionError(f"GQA checkpoint {dtype}: table {table}, "
                                     f"K1 {k1}, K2 {k2}, K5 {k5}")
            del gseg

        # (3) the device pool, beside the per-step loader without a probe
        stamps = []
        build = trainer.build_train_step

        def stamped(*args, **kwargs):
            step = build(*args, **kwargs)

            def run(*a):
                stamps.append(time.perf_counter())
                return step(*a)
            return run
        trainer.build_train_step = stamped
        try:
            train_cli.main(train_argv(data, os.path.join(tmp, "loader"),
                                      POOL_STEPS))
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        finally:
            trainer.build_train_step = build
        loader_rate = (len(stamps) - 1 - TRAIN_TIMED_FROM) / (
            stamps[-1] - stamps[TRAIN_TIMED_FROM])
        with BlockProbe() as blocks:
            train_cli.main(train_argv(data, os.path.join(tmp, "pool"),
                                      POOL_STEPS, extra=("--device_pool", "1")))
        for i, b in enumerate(blocks.blocks):
            print(f"    block {i}: {b['steps']} steps in {b['s'] * 1e3:.1f} ms "
                  f"({b['steps'] / b['s']:.2f} steps/s); launches K1 {b['k1']}, "
                  f"(K2, dkv, dq) {b['k2_dkv_dq']}; pool features "
                  f"{b['pool_mib']:.1f} MiB; losses "
                  f"{', '.join(f'{x:.3f}' for x in b['losses'])}", flush=True)
        last_block = blocks.blocks[-1]
        print(f"  device pool: {last_block['steps'] / last_block['s']:.2f} "
              f"steps/s in its last block; the per-step loader "
              f"{loader_rate:.2f} steps/s (steps {TRAIN_TIMED_FROM}.."
              f"{POOL_STEPS - 1}, host clock, unsynchronized steps)", flush=True)
        if len(blocks.blocks) != 2 or any(
                b["k1"] != 1 or b["k2_dkv_dq"] != (layers * b["steps"],) * 3
                or not all(np.isfinite(b["losses"])) for b in blocks.blocks):
            raise AssertionError(f"device pool blocks {blocks.blocks}")
    print(f"  train-options phase {time.perf_counter() - start:.1f} s",
          flush=True)


# ----------------------------------------------------------------- pretrain

# the presets' frontend configurations (n_fft 512, 1024, 4096) and one above
# 300 kHz, whose n_fft is 8192
PRETRAIN_EXTRA_CONFIG = (384000, 0.0005, 35000.0)
PRETRAIN_MODEL, PRETRAIN_STEPS, PRETRAIN_CALL = "base", 6, 3


def pretrain_phase(device) -> None:
    """``pretrain.run_pretraining`` of the base size (random init, frame
    head of 5 clusters, dropout 0.1, batch 8) over a pool of one chunk of 4
    examples for each preset configuration and the 384 kHz one, refreshed
    on the worker thread after the first call: PRETRAIN_STEPS steps in
    calls of PRETRAIN_CALL. K1 must run at every configuration's n_fft (512
    to 8192), K2, dkv and dq once a layer a step, the losses be finite; the
    checkpoint then answers a request."""
    import tempfile

    from whisperseg_torch import pretrain
    from whisperseg_torch.audio import frontend as frontend_module
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    start = time.perf_counter()
    n_ffts = []
    inner = frontend_module.melproject_reim

    def recorded(re, *args, **kwargs):
        n_ffts.append(2 * (re.shape[-2] - 1))
        return inner(re, *args, **kwargs)
    spec = pretrain.PoolSpec(chunk=4, configs=pretrain.PRETRAIN_CONFIGS
                             + (PRETRAIN_EXTRA_CONFIG,))
    with tempfile.TemporaryDirectory() as tmp:
        args = pretrain.PretrainArgs(
            model=PRETRAIN_MODEL, model_folder=os.path.join(tmp, "pt"),
            steps=PRETRAIN_STEPS, batch_size=8,
            pool_items=len(spec.configs) * spec.chunk,
            refresh_every=PRETRAIN_CALL, steps_per_call=PRETRAIN_CALL,
            warmup_steps=2, save_every=PRETRAIN_STEPS, spec=spec)
        frontend_module.melproject_reim = recorded
        try:
            with BlockProbe() as calls:
                final = pretrain.run_pretraining(args)
        finally:
            frontend_module.melproject_reim = inner
        with open(os.path.join(args.model_folder, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        for i, c in enumerate(calls.blocks):
            print(f"    call {i}: {c['steps']} steps in {c['s'] * 1e3:.1f} ms; "
                  f"(K2, dkv, dq) {c['k2_dkv_dq']}; pool features "
                  f"{c['pool_mib']:.1f} MiB; losses "
                  f"{', '.join(f'{x:.3f}' for x in c['losses'])}", flush=True)
        print(f"  K1 launches {len(n_ffts)} at n_fft {sorted(set(n_ffts))}; "
              f"logged {[(r['current_step'], round(r['train/loss'], 4), round(r['val/loss'], 4)) for r in records]}",
              flush=True)
        seg = Segmenter.from_pretrained(final, device=device)
        table, dt = timed(lambda: seg.segment(tone_bursts(7, duration=2.5), SR,
                                              max_length=100))
        print(f"  the pretrained checkpoint: a 2.5 s request -> "
              f"{len(table['onset'])} segments in {dt:.3f} s", flush=True)
        want = {512, 1024, 4096, 8192}
        layers = seg.config.encoder_layers
        if not want <= set(n_ffts) or any(
                c["k2_dkv_dq"] != (layers * c["steps"],) * 3
                or not all(np.isfinite(c["losses"])) for c in calls.blocks) \
                or not all(np.isfinite([r["train/loss"], r["val/loss"]]).all()
                           for r in records) or set(table) != {"onset", "offset", "cluster"}:
            raise AssertionError(f"pretraining: n_fft {set(n_ffts)}, calls "
                                 f"{calls.blocks}, logged {records}")
    print(f"  pretrain phase {time.perf_counter() - start:.1f} s", flush=True)


# ---------------------------------------------------------------------- hf


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_leaves(v, name)
        else:
            yield name, v


def _counted_batches(seg):
    """Counts the device batches ``seg`` runs (``calls[0]``)."""
    calls = [0]
    inner = seg._decode_batch

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)
    seg._decode_batch = counted
    return calls


def hf_phase(device, npz_seg=None) -> None:
    """The base checkpoint exported to a HuggingFace directory
    (models/export_hf.py): imported back (models/convert_hf.py, through
    ``transformers.WhisperConfig``) it must be the same parameters, bit for
    bit, and the same config but for the training options, which an HF
    config does not carry; ``Segmenter.from_pretrained`` of the directory
    on the card must give the params.npz checkpoint's table on the same
    request, launching K1 once a batch and K2 once an encoder layer a
    batch; and transformers' own model, loaded from the directory onto the
    card in float32, must give the port's float32 logits within 1e-3.
    ``npz_seg``: a bf16 Segmenter of the params.npz checkpoint already
    loaded (the serve phase's), else one is made."""
    import tempfile

    import transformers

    from whisperseg_torch.checkpoint import cast_params, load_checkpoint
    from whisperseg_torch.models import whisper
    from whisperseg_torch.models.convert_hf import import_hf_checkpoint
    from whisperseg_torch.models.export_hf import export_hf_checkpoint
    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts

    start = time.perf_counter()
    print(f"  transformers {transformers.__version__} reads the exported "
          f"config (safetensors for the weights)", flush=True)
    params, cfg = load_checkpoint(BASE_MODEL)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = export_hf_checkpoint(params, cfg, os.path.join(tmp, "hf"))
        t1 = time.perf_counter()
        back, bcfg = import_hf_checkpoint(out, total_spec_columns=None)
        t2 = time.perf_counter()
        flat = dict(_flat_leaves(params))
        differ = [k for k, v in _flat_leaves(back)
                  if k not in flat or not torch.equal(v, flat[k])]
        # an HF config carries no training options (dropout, remat)
        cfg_differ = {k: (v, bcfg.to_dict().get(k))
                      for k, v in cfg.to_dict().items()
                      if bcfg.to_dict().get(k) != v
                      and k not in ("dropout", "remat")}
        print(f"  export {t1 - t0:.2f} s ({sorted(os.listdir(out))}), import "
              f"{t2 - t1:.2f} s: {len(flat)} leaves, differing leaves "
              f"{differ}, differing config fields {cfg_differ}", flush=True)
        if differ or cfg_differ or len(list(_flat_leaves(back))) != len(flat):
            raise AssertionError("the HF round trip changed the checkpoint")

        hf_seg = Segmenter.from_pretrained(out, device=device)
        if npz_seg is None:
            npz_seg = Segmenter.from_pretrained(BASE_MODEL, device=device)
        audio = tone_bursts(106, duration=10.0)
        want = npz_seg.segment(audio, SR, num_trials=3)
        calls = _counted_batches(hf_seg)
        logmel.launches = attention.launches = 0
        table, dt = timed(lambda: hf_seg.segment(audio, SR, num_trials=3))
        k1, k2 = logmel.launches, attention.launches
        layers = hf_seg.config.encoder_layers
        print(f"  from_pretrained(HF directory), bfloat16: 10 s, 3 trials -> "
              f"{len(table['onset'])} segments in {dt:.3f} s, "
              f"{'the same table as' if table == want else 'NOT the table of'}"
              f" the params.npz checkpoint; {calls[0]} batches, launches K1 "
              f"{k1}, K2 {k2}", flush=True)
        if table != want or not table["onset"] or k1 != calls[0] \
                or k2 != layers * calls[0]:
            raise AssertionError(f"HF segmenter: table {table} vs {want}, "
                                 f"K1 {k1}, K2 {k2}, batches {calls[0]}")

        hf = transformers.WhisperForConditionalGeneration.from_pretrained(
            out).to(device).eval()
        gen = torch.Generator().manual_seed(0)
        feats = torch.randn(2, 80, cfg.total_spec_columns, generator=gen)
        ids = torch.randint(0, 1024, (2, 24), generator=gen)
        ids[:, :3] = torch.tensor([12, 13, 14])  # the decoder prompt
        cfg32 = type(cfg).from_dict(dict(cfg.to_dict(),
                                         compute_dtype="float32"))
        with torch.no_grad():
            p32 = cast_params(params, torch.float32, device)
            enc = whisper.encoder_forward(p32, cfg32, feats.to(device))
            ours = whisper.decoder_forward_train(p32, cfg32, enc,
                                                 ids.to(device))
            theirs = hf(input_features=feats.to(device),
                        decoder_input_ids=ids.to(device)).logits
        gap = (ours - theirs).abs().max().item()
        print(f"  transformers' WhisperForConditionalGeneration on the card, "
              f"float32: logits within {gap:.2e} of the port's (tol 1e-3)",
              flush=True)
        if not gap <= 1e-3:
            raise AssertionError(f"transformers' logits differ by {gap}")
        del hf, hf_seg
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  hf phase {time.perf_counter() - start:.1f} s", flush=True)


# ---------------------------------------------------------------- parallel

PARALLEL_STEPS = 5
PARALLEL_LAYOUTS = [("dp 2", 1, False), ("tp 2", 2, False),
                    ("dp 2 + fsdp", 1, True)]
# (compute dtype, learning rate). float32 at lr 1e-4 holds the layouts'
# collectives and updates: each step's loss and the first step's gradient
# norm within PARALLEL_F32_TOL (relative) of one process's, the parameters'
# change after the steps within PARALLEL_F32_MOVE_TOL of its norm. On an
# H100 the layouts came within 3.5e-5, 6.7e-5 and 1.5e-3, one process with
# its features scaled by 1 + 1e-6 within 3.7e-5, 6.0e-5 and 1.7e-3 (the
# order of the sums, carried by AdamW); on the CPU a data axis that leaves
# its gradient sum out is 4.5e-3-1.1e-2, 0.49-0.56 and 0.64 off, a halved
# sum 0.5 off in the gradient norm. bf16, as the checkpoint ships, holds
# the kernels' path and the forward: each step's loss within
# PARALLEL_BF16_TOL of one process's. Any change to the arithmetic redraws
# bf16's rounding (chip_bf16_numerics.py): features scaled by 1 + 1e-7 to
# 1 + 1e-3 move one process's first loss by 2.4e-4-2.7e-3 and its first
# gradient by 5.2e-3-2.6e-1 of its norm, out of proportion to the scale
# (float32: 6.4e-7 and 2.0e-5 at 1e-7, in proportion); tp 2's first
# gradient is 3.1e-2-8.8e-1 off one process's, in the same leaves (the
# encoder's q and k). AdamW carries such gaps into the later losses, the
# more the larger the step: the layouts' reached 3.3e-2 by the fifth step
# at lr 1e-4, 1.3e-2 at 1e-5 and 7.1e-3 at 1e-6. So bf16 trains at 1e-6,
# and the update is held in float32.
PARALLEL_RUNS = [("bfloat16", 1e-6), ("float32", 1e-4)]
PARALLEL_BF16_TOL = 1e-2
PARALLEL_F32_TOL = 1e-3
PARALLEL_F32_MOVE_TOL = 1e-2
PARALLEL_TIMEOUT_S = 400


def parallel_model(tmp: str, dtype: str) -> str:
    """The base checkpoint computing in ``dtype``: the shipped directory for
    bfloat16, else a directory in ``tmp`` whose config says ``dtype`` and
    whose other files link the shipped ones."""
    if dtype == "bfloat16":
        return BASE_MODEL
    folder = os.path.join(tmp, f"base-{dtype}")
    if not os.path.isdir(folder):
        os.makedirs(folder)
        for name in os.listdir(BASE_MODEL):
            if name != "config.json":
                os.symlink(os.path.join(BASE_MODEL, name),
                           os.path.join(folder, name))
        with open(os.path.join(BASE_MODEL, "config.json")) as f:
            config = json.load(f)
        config["compute_dtype"] = dtype
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(config, f)
    return folder


def parallel_args(model: str, data: str, model_folder: str, lr: float, **kw):
    """``run_training``'s arguments of the parallel phase: ``model``, global
    batch 4 of 2.5 s clips, dropout 0, the frame head on, every step's loss
    logged."""
    from whisperseg_torch.training import trainer

    return trainer.TrainArgs(
        initial_model_path=model, model_folder=model_folder,
        train_dataset_folder=data, max_num_iterations=PARALLEL_STEPS,
        batch_size=BATCH, total_spec_columns=1000, max_length=100,
        learning_rate=lr, warmup_steps=2, print_every=1, num_workers=2,
        frame_head=True, **kw)


def parallel_rank(rank: int, port: int, data: str, out: str) -> None:
    """One of the two ranks of the parallel phase: joins a gloo group on
    127.0.0.1:``port`` on ``cuda:0`` (both ranks share the card), trains
    each layout of each run through ``run_training`` under a ``StepProbe``,
    and writes each one's per-step losses, first gradient norm, kernel
    launches and the head counts K2 saw to ``out``.{rank}.json (rank 0's
    checkpoints to ``<run>/<layout>``)."""
    import torch.distributed as dist

    from whisperseg_torch.models import whisper
    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.parallel import multihost
    from whisperseg_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    tmp = os.path.dirname(out)
    heads = []
    inner = whisper.encoder_attention

    def seen(valid_len, q4, kt4, v4):
        heads.append(q4.shape[1])
        return inner(valid_len, q4, kt4, v4)
    whisper.encoder_attention = seen
    results = {"backend": dist.get_backend()}
    for dtype, lr in PARALLEL_RUNS:
        for name, tp, fsdp in PARALLEL_LAYOUTS:
            heads.clear()
            t0 = time.perf_counter()
            with StepProbe() as probe:
                trainer.run_training(parallel_args(
                    parallel_model(tmp, dtype), data,
                    os.path.join(tmp, f"{dtype}-{lr}", f"{name}-{rank}"), lr,
                    tp=tp, fsdp=fsdp, device="cuda:0"))
            results[f"{dtype} {lr} {name}"] = {
                "losses": probe.losses, "grad_norm": probe.grad_norm,
                "grad_leaves": probe.grad_leaves,
                "launches": probe.launches, "lse": attention.launches_lse,
                "k1": logmel.launches, "collates": probe.collates,
                "heads": sorted(set(heads)),
                "step_ms": [t * 1e3 for t in probe.times],
                "s": time.perf_counter() - t0}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _leaf_gaps(got: dict, want: dict, n: int = 3) -> str:
    """The ``n`` leaves whose gradient norms differ most: name, norm, the
    other norm."""
    top = sorted(want, key=lambda k: -abs(got[k] - want[k]))[:n]
    return "leaves " + ", ".join(f"{k} {got[k]:.4f} ({want[k]:.4f})"
                                 for k in top)


def _final_params(folder: str) -> dict:
    """The flat parameters of ``folder``/final_checkpoint."""
    from whisperseg_torch.checkpoint import _flatten, load_checkpoint

    return _flatten(load_checkpoint(os.path.join(folder, "final_checkpoint"))[0])


def _moved(init: dict, got: dict, ref: dict):
    """(|change - one process's change| / |one process's change|, rms of
    one process's change) of the parameters ``got`` and ``ref`` from
    ``init`` (float64 sums)."""
    num = den = 0.0
    for k, p0 in init.items():
        num += float((got[k].double() - ref[k].double()).square().sum())
        den += float((ref[k].double() - p0.double()).square().sum())
    size = sum(p.numel() for p in init.values())
    return (num / den) ** 0.5, (den / size) ** 0.5


def parallel_phase(device, plain=None) -> None:
    """Two ranks share ``cuda:0`` over gloo (NCCL needs a card a rank) and
    train the base checkpoint for PARALLEL_STEPS steps at global batch 4 in
    three layouts, dp 2, tp 2 and dp 2 with fsdp, through ``run_training``
    under an initialized process group, once for each of PARALLEL_RUNS
    (compute dtype, learning rate; it says what each must match); beside
    them one process trains on the global batch, and once more with its
    features scaled by 1 + 1e-6 (a control, printed). Every rank must
    launch K2 (with its log-sum-exp), dK/dV and dQ once an encoder layer a
    step, K2 at 8 heads (dp) or 4 (tp). Then
    ``Segmenter(mesh=make_mesh(devices=[cuda:0, cuda:0]))`` must give the plain Segmenter's table (``plain``: the serve
    phase's, else one is made), each batch split over two threads (K1 twice
    a batch, K2 once an encoder layer a launch of K1). Every result is
    printed before the phase fails on any."""
    import tempfile

    from whisperseg_torch.ops import attention, logmel
    from whisperseg_torch.parallel import make_mesh
    from whisperseg_torch.parallel.multihost import free_port
    from whisperseg_torch.segmenter import Segmenter
    from whisperseg_torch.synthetic import tone_bursts, write_tone_dataset
    from whisperseg_torch.training import trainer

    start = time.perf_counter()
    layers = 6
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        data = write_tone_dataset(os.path.join(tmp, "data"), TRAIN_FILES,
                                  seed=700)
        port = free_port()
        out = os.path.join(tmp, "rank")
        cmd = ("import chip_smoke as c; c.parallel_rank({}, %d, %r, %r)"
               % (port, data, out))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", cmd.format(r)],
                                  cwd=ROOT) for r in range(2)]
        refs = {}
        try:
            # one process on the global batch, and a control: the same
            # with its features scaled by 1 + 1e-6
            for dtype, lr in PARALLEL_RUNS:
                for control in (False, True):
                    name = "one, features scaled" if control else "one"
                    with StepProbe(keep_init=dtype == "float32",
                                   scale=1 + 1e-6 if control else 1.0) as ref:
                        trainer.run_training(parallel_args(
                            parallel_model(tmp, dtype), data, os.path.join(
                                tmp, f"{dtype}-{lr}", name), lr,
                            n_device=1, device=device))
                    refs[dtype, lr, control] = ref
                ref = refs[dtype, lr, False]
                print(f"  one process, {dtype}, lr {lr:g}, global batch "
                      f"{BATCH}: losses "
                      f"{', '.join(f'{x:.6f}' for x in ref.losses)}; first "
                      f"gradient norm {ref.grad_norm:.6f}; median step "
                      f"{np.median(ref.times[1:]) * 1e3:.2f} ms (beside the "
                      f"ranks)", flush=True)
            codes = [p.wait(timeout=PARALLEL_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes != [0, 0]:
            raise AssertionError(f"parallel ranks exited with {codes}")
        ranks = []
        for r in range(2):
            with open(f"{out}.{r}.json") as f:
                ranks.append(json.load(f))
        print(f"  2 ranks on cuda:0 over {ranks[0]['backend']} (NCCL needs a "
              f"card a rank), "
              f"{time.perf_counter() - t0:.1f} s for {len(PARALLEL_RUNS)} x "
              f"{len(PARALLEL_LAYOUTS)} runs, process start included",
              flush=True)
        f32 = next((refs[k] for k in refs if k[0] == "float32" and not k[2]),
                   None)
        for dtype, lr in PARALLEL_RUNS:
            ref = refs[dtype, lr, False]
            if f32 is not None and ref is not f32:
                print(f"  one process, {dtype} against float32: first "
                      f"gradient norm {ref.grad_norm:.6f} against "
                      f"{f32.grad_norm:.6f}; "
                      f"{_leaf_gaps(ref.grad_leaves, f32.grad_leaves)}",
                      flush=True)
            folder = os.path.join(tmp, f"{dtype}-{lr}")
            ref_params = (_final_params(os.path.join(folder, "one"))
                          if ref.init is not None else None)

            def gaps(got, name):
                """(largest loss gap, gradient norm gap, change gap or None,
                the line's text) of a run against one process's."""
                rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                           ref.losses)]
                grad = abs(got["grad_norm"] - ref.grad_norm) / ref.grad_norm
                move, moved = None, ""
                if ref_params is not None:
                    move, rms = _moved(ref.init, _final_params(
                        os.path.join(folder, name)), ref_params)
                    moved = (f"; parameters' change: rms {rms:.3e}, gap "
                             f"{move:.2e} of its norm")
                text = (f"losses {', '.join(f'{x:.6f}' for x in got['losses'])}"
                        f" (relative gaps {', '.join(f'{x:.2e}' for x in rel)});"
                        f" first gradient norm {got['grad_norm']:.6f} (gap "
                        f"{grad:.2e}; "
                        f"{_leaf_gaps(got['grad_leaves'], ref.grad_leaves)})"
                        f"{moved}")
                return max(rel), grad, move, text

            control = vars(refs[dtype, lr, True])
            print(f"  {dtype} lr {lr:g} one process, features x (1 + 1e-6): "
                  f"{gaps(control, 'one, features scaled')[3]}", flush=True)
            for name, tp, fsdp in PARALLEL_LAYOUTS:
                for r, res in enumerate(ranks):
                    got = res[f"{dtype} {lr} {name}"]
                    loss, grad, move, text = gaps(got, f"{name}-0")
                    print(f"  {dtype} lr {lr:g} {name} rank {r}: {text}; "
                          f"(K2, dkv, dq) a step "
                          f"{sorted(set(map(tuple, got['launches'])))}, K2 "
                          f"with lse {got['lse']}, K1 {got['k1']} for "
                          f"{got['collates']} batches, K2 heads "
                          f"{got['heads']}; median step "
                          f"{np.median(got['step_ms'][1:]):.2f} ms; run "
                          f"{got['s']:.1f} s", flush=True)
                    if dtype == "float32":
                        close = (loss <= PARALLEL_F32_TOL
                                 and grad <= PARALLEL_F32_TOL
                                 and move <= PARALLEL_F32_MOVE_TOL)
                    else:
                        close = loss <= PARALLEL_BF16_TOL
                    if not (close and len(got["losses"]) == PARALLEL_STEPS
                            and {tuple(x) for x in got["launches"]}
                            == {(layers, layers, layers)}
                            and got["lse"] == layers * PARALLEL_STEPS
                            and got["k1"] == got["collates"]
                            and got["heads"] == [8 // tp]):
                        failed.append(f"{dtype} lr {lr:g} {name} rank {r}")

    cuda0 = torch.device("cuda", 0)
    if plain is None:
        plain = Segmenter.from_pretrained(BASE_MODEL, device=device)
    meshed = Segmenter.from_pretrained(BASE_MODEL,
                                       mesh=make_mesh(devices=[cuda0, cuda0]))
    audio = tone_bursts(106, duration=10.0)
    want = plain.segment(audio, SR, num_trials=3)
    calls = _counted_batches(meshed)
    logmel.launches = attention.launches = 0
    table, dt = timed(lambda: meshed.segment(audio, SR, num_trials=3))
    k1, k2 = logmel.launches, attention.launches
    print(f"  Segmenter(mesh=[cuda:0, cuda:0]), bfloat16: 10 s, 3 trials -> "
          f"{len(table['onset'])} segments in {dt:.3f} s, "
          f"{'the same table as' if table == want else 'NOT the table of'} "
          f"the plain Segmenter; {calls[0]} batches, launches K1 {k1}, K2 "
          f"{k2}", flush=True)
    if table != want or k1 != 2 * calls[0] or k2 != layers * k1:
        failed.append(f"mesh segmenter: {table} vs {want}; K1 {k1}, K2 {k2}, "
                      f"batches {calls[0]}")
    print(f"  parallel phase {time.perf_counter() - start:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"parallel phase: {failed}")


# --------------------------------------------------------------------- main


def int8_kv_tables(root: str) -> int:
    """The int8 + ``int8_kv`` serve requests alone, their tables and tokens
    printed, with the port's package from ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    device = torch.device("cuda")
    card = card_line()
    print(f"[int8_kv tables] {card}; package from {os.path.abspath(root)}",
          flush=True)
    qseg, _, _ = serve_phase(device, QUANT_REQUESTS, "int8", True)
    card_tokens(qseg, QUANT_REQUESTS, int8_kv=True)
    print(card)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--int8-kv-tables"]:
        return int8_kv_tables(sys.argv[2] if len(sys.argv) > 2 else ROOT)
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
    for source, key in (("melproject", "melproject"), ("attention", "attention_hm"),
                        ("qdot", "qdot"), ("cross_attention_int8", "cross_attention")):
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
    print("[audio LM] Moonlight-16B-A3B's routed experts (K7) against their "
          "plain version, then segment() through the audio LM", flush=True)
    moe_rows = audio_lm_phase(device)
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
        if int8_kv:  # whisperseg_torch/card_tables_int8_kv.json records them
            card_tokens(qseg, QUANT_REQUESTS, int8_kv=True)

    print("[service] base checkpoint, bfloat16, the HTTP service with its "
          "continuous batcher, and the segment CLI", flush=True)
    service_phase(device)

    print("[backend] base checkpoint, bfloat16, the model-zoo backend: WAV, "
          "FLAC and MP3 uploads, then a fine-tune over HTTP", flush=True)
    backend_phase(device)

    print("[profile] bfloat16", flush=True)
    mouse_frontend_stage(device)
    profile_phase(seg)
    print("[profile] int8 with int8_kv", flush=True)
    profile_phase(qseg, int8_kv=True)

    print("[train] base checkpoint through the train CLI, bf16 compute, "
          "float32 master weights, AdamW", flush=True)
    train_launches, adamw_step_ms = train_phase(device)
    launches.update(train_launches)

    print(f"[speculative] base checkpoint (bf16) with the tiny checkpoint "
          f"drafting, spec_k {SPEC_K}, greedy", flush=True)
    speculative_phase(device)
    print("[train options] base checkpoint through the train CLI: adafactor "
          "+ QAT + profiler, GQA + splice synthesis, the device pool",
          flush=True)
    train_options_phase(device, adamw_step_ms)
    print("[pretrain] synthetic pretraining of the base size over a pool on "
          "the card", flush=True)
    pretrain_phase(device)
    print("[hf] base checkpoint exported to a HuggingFace directory and "
          "served from it", flush=True)
    hf_phase(device, seg)
    print(f"[parallel] base checkpoint, two ranks on cuda:0 over gloo: "
          f"{', '.join(n for n, _, _ in PARALLEL_LAYOUTS)}, each in "
          f"{' and '.join(f'{d} at lr {lr:g}' for d, lr in PARALLEL_RUNS)}; "
          f"then a mesh Segmenter", flush=True)
    parallel_phase(device, seg)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows += moe_rows
    for row in rows:
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
