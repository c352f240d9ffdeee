#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisperseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout. It builds the port's CUDA kernels from
``whisperseg_torch/csrc`` (one ``nvcc`` per source, all started together) and
then runs, in order:

  1. setup: the card's name and power limit, the torch version, the build time;
  2. kernels: each kernel against its plain PyTorch version on the card at the
     main path's shapes (the mel kernel also at every n_fft, the quantized
     products at every projection shape of every model size), with the
     kernel's time, the plain version's, one library call's as a yardstick
     where there is one, and the least time the card could take for the same
     work;
  3. golden: the shipped tiny checkpoint at float32 on the card must give the
     JAX package's segment table (whisperseg_torch/golden_tiny.json);
  4. serve: one ``Segmenter`` on the shipped base checkpoint (bfloat16 as
     shipped, default arguments: beam 4 and the checkpoint's
     post-processing) answers synthetic requests; every batch must launch the
     mel kernel once and the attention kernel once per encoder layer;
  5. quantized serve: the same checkpoint as ``inference_dtype="int8"``, as
     ``"int4"``, and as ``"int8"`` with ``int8_kv=True`` answers two of those
     requests each; besides the above, every decoder step must launch the
     w8a16 (or w4a16) kernel 8 times per decoder layer, and every
     single-token step the int8 cross-attention kernel once per layer;
  6. profile: one more request, in bfloat16 and then in int8 with
     ``int8_kv``, timed stage by stage, then under ``torch.profiler``: the
     device's busy share and its time by kernel.

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
    graph: the device's own time, with no host dispatch between launches."""
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
        plain_ms = cuda_ms(lambda: logmel.melproject_reference(re, im, mel), 20)
        nbytes = 4 * (2 * b * n_freq * frames + n_freq * n_mel + b * n_mel * frames)
        flops = b * frames * n_freq * (3 + 2 * n_mel)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        print(f"  melproject n_fft {fr.n_fft:5d} [{b}, {n_freq}, {frames}]: "
              f"max|err| {err:.2e} (tol 2e-5)  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
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


ATTENTION_CASES = [  # name, H, Hkv, hd, dtype; B 4, Sp 512, valid 500
    ("base bf16", 8, 8, HD, torch.bfloat16),
    ("base f32", 8, 8, HD, torch.float32),
    ("tiny bf16", 6, 6, HD, torch.bfloat16),
    ("GQA 8/2 bf16", 8, 2, HD, torch.bfloat16),
    ("hd128 bf16", 4, 4, 128, torch.bfloat16),
    ("hd128 f32", 4, 4, 128, torch.float32),
]


def check_attention(device) -> dict:
    """K2 against its plain version (float32: 2e-5 absolute; bf16: 2 % of
    the largest output) at the encoder's shapes; returns the main path's row
    (base model, bf16)."""
    from whisperseg_torch.ops import attention

    gen = torch.Generator(device="cpu").manual_seed(0)
    keep = (torch.arange(SP, device=device) < VALID)[None, None, None, :]
    row = None
    for name, h, hkv, hd, dtype in ATTENTION_CASES:
        def rand(*shape):
            x = torch.randn(*shape, generator=gen) * 0.5
            return x.to(device=device, dtype=dtype)
        q, kt, v = rand(BATCH, h, SP, hd), rand(BATCH, hkv, hd, SP), rand(BATCH, hkv, SP, hd)
        got = attention.fused_attention_head_major(VALID, q, kt, v)[:, :, :VALID].float()
        want = attention.attention_hm_reference(VALID, q, kt, v)[:, :, :VALID].float()
        err = (got - want).abs().max().item()
        if dtype == torch.float32:
            ok, tol = err <= 2e-5, "2e-5"
        else:
            ok, tol = err <= 0.02 * want.abs().max().item(), "2% of max|out|"
        k = kt.transpose(-1, -2)
        ms = cuda_ms(lambda: attention.fused_attention_head_major(VALID, q, kt, v), 50)
        plain_ms = cuda_ms(lambda: attention.attention_hm_reference(VALID, q, kt, v), 20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, enable_gqa=h != hkv), 50)
        item = q.element_size()
        nbytes = item * (2 * q.numel() + kt.numel() + v.numel())
        flops = 4 * BATCH * h * SP * VALID * hd
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        print(f"  attention {name:12s} [{BATCH}, {h}/{hkv}, {SP}, {hd}]: "
              f"max|err| {err:.2e} (tol {tol})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"attention {name}: max|err| {err}")
        if name == "base bf16":
            row = {"name": "attention_hm", "route": "cuda",
                   "source": "whisperseg_torch/csrc/attention.cu",
                   "replaces": "whisperseg_tpu/ops/attention.py:86",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
    return row


def quant_shapes():
    """(K, out) of every quantized projection of every model size (d_model
    384 to 1280, d_ff = 4 d_model), and out = 640, whose tail columns a
    tiled kernel can leave unwritten."""
    shapes = []
    for d in (384, 512, 768, 1024, 1280):
        shapes += [(d, d), (d, 4 * d), (4 * d, d)]
    return shapes + [(512, 640)]


def check_qdot(device, bits: int) -> dict:
    """K3 (bits 8) or K4 (bits 4) against its plain version at every
    projection shape and at M = 1, 16 (a decode step), 48 (the prefill) and
    512. Kernel and plain version round alike and differ in the order of a
    float32 sum: held to 1e-3 of the largest output. Returns the main path's
    row (base model, one decode step: M 16, K 512, out 512)."""
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
    row, worst = None, 0.0
    for k, out in quant_shapes():
        w = torch.randn(k, out, generator=gen) * 0.05
        w = w * torch.exp(torch.randn(out, generator=gen))  # uneven columns
        qt = quantize(w).to(device)
        storage = qt.values if bits == 8 else qt.packed
        for m in (1, DECODE_ROWS, 48, 512):
            x = torch.randn(m, k, generator=gen).to(device)
            got, want = kernel(x, qt), plain(x, qt)
            err = (got - want).abs().max().item()
            top = want.abs().max().item()
            worst = max(worst, err / top)
            main = (m, k, out) == (DECODE_ROWS, 512, 512)
            ms = cuda_ms(lambda: kernel(x, qt), 50 if main else 10)
            plain_ms = cuda_ms(lambda: plain(x, qt), 20 if main else 5)
            nbytes = (storage.numel() + 4 * qt.scale.numel()
                      + x.element_size() * x.numel() + 4 * m * out)
            bound_ms, bound_by = bound(nbytes, 2 * m * k * out, torch.bfloat16)
            print(f"  {name} M {m:3d} K {k:4d} out {out:4d}: max|err| {err:.2e} "
                  f"({err / top:.1e} of max|out|, tol 1e-3)  kernel {ms:.4f} ms"
                  f"  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} ms "
                  f"({bound_by})", flush=True)
            if not err <= 1e-3 * top:
                raise AssertionError(f"{name} M {m} K {k} out {out}: max|err| "
                                     f"{err} against max|out| {top}")
            if main:
                deq_ms = cuda_ms(lambda: dot_f32(
                    x, quant.dequantize(qt, torch.bfloat16), torch.bfloat16), 20)
                print(f"    note: replayed from a CUDA graph, without the "
                      f"host's dispatch: {graph_ms(lambda: kernel(x, qt), 50):.4f}"
                      f" ms; dequantize to bf16, then torch.mm: {deq_ms:.4f} ms "
                      f"(several launches; no yardstick)", flush=True)
                row = {"name": name, "route": "cuda",
                       "source": "whisperseg_torch/csrc/qdot.cu",
                       "replaces": replaces, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       # no one PyTorch call dequantizes and multiplies
                       "library_ms": None}
    print(f"  {name}: largest error over all shapes {worst:.1e} of max|out|",
          flush=True)
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
    torch.cuda.reset_peak_memory_stats()

    logmel.launches = attention.launches = cross_attention.launches = 0
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
            if not table["onset"]:
                raise AssertionError(f"request seed {seed}: empty segment table")
    counts = {"melproject": logmel.launches, "attention_hm": attention.launches,
              "qdot_w8a16": quant.launches_w8a16,
              "qdot_w4a16": quant.launches_w4a16,
              "cross_attention_int8": cross_attention.launches}
    cfg = seg.config
    # 8 quantized projections per decoder layer and step (q, k, v, o, xq, xo,
    # fc1, fc2); the encoder's and the cross K/V's run at M > 512 rows
    per_step = 8 * cfg.decoder_layers * steps.calls
    want = {"melproject": batches,
            "attention_hm": batches * cfg.encoder_layers,
            "qdot_w8a16": per_step if inference_dtype == "int8" else 0,
            "qdot_w4a16": per_step if inference_dtype == "int4" else 0,
            "cross_attention_int8": (cfg.decoder_layers * steps.single
                                     if int8_kv else 0)}
    print(f"  {audio_s:.1f} s of audio in {busy_s:.3f} s "
          f"({audio_s / busy_s:.1f} audio-s/s); {batches} batches, "
          f"{steps.calls} decoder steps ({steps.single} of one token); "
          f"launches {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    return seg, counts, segments


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisperseg_torch.synthetic import tone_bursts

    audio = tone_bursts(200, duration=10.0)
    stage_times(seg, audio, int8_kv)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.segment(audio, SR, int8_kv=int8_kv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("  torch.profiler recorded no device time", flush=True)
        return
    busy_us, reach = 0.0, -1.0
    by_name = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, n + 1)
    print(f"  10 s request, traced: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{len(spans)} device ops", flush=True)
    groups = {"melproject": ("melproject",), "attention_hm": ("attention_hm",),
              "qdot": ("qdot_w",), "cross_attention_int8": ("cross_attention",),
              "matmul": ("gemm", "gemv", "nvjet", "cutlass", "sm90"),
              "fft": ("fft",)}
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


# --------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 products wherever a float32 matmul or convolution runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from whisperseg_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    print(f"[setup] {card}; torch {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s into "
          f"{os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)

    print("[kernels] each against its plain version on the card", flush=True)
    rows = [check_melproject(device), check_attention(device),
            check_qdot(device, 8), check_qdot(device, 4),
            check_cross_attention(device)]

    print("[golden] tiny checkpoint, float32, beam 4, 3 trials", flush=True)
    golden_phase(device)

    print("[serve] base checkpoint, bfloat16, default arguments", flush=True)
    seg, launches, segments = serve_phase(device, REQUESTS)

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
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was never launched on its path")

    print("[profile] bfloat16", flush=True)
    profile_phase(seg)
    print("[profile] int8 with int8_kv", flush=True)
    profile_phase(qseg, int8_kv=True)

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
