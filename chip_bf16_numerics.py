"""Where bf16 training on the card is sensitive, for the readings of
``chip_smoke.py``'s parallel phase (PERF.md, PR 11). Three parts, each
printing one line a case:

  products   ``torch.mm(x, w, out_dtype=float32)`` with bf16 operands at the
             shapes one process and a tensor-parallel rank (tp 2) give the
             base checkpoint's training step at global batch 4, forward and
             weight gradient, against float64, with cuBLAS's reduced-precision
             reduction allowed (PyTorch's default) and not: the largest and
             the root-mean-square error, each relative to the largest
             magnitude of the exact result;
  heads      the encoder attention kernels (K2 with its log-sum-exp, dK/dV,
             dQ) on the base checkpoint's own activations of one batch: the
             8-head launch against its plain version, and two launches of 4
             heads (a tp 2 rank's share) against the 8-head launch's heads;
  perturb    one training step of the base checkpoint in one process on a
             tone batch, bf16 and float32, with the input features scaled by
             1 + eps: the loss's and the first gradient norm's relative
             change, and the three leaves whose gradient norms move most.

    python3 chip_bf16_numerics.py [products] [heads] [perturb]   (default all)
"""

import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BASE = os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad")


def products() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, d, ff = 4 * 512, 512, 2048
    cases = [  # name, M, K, N: forward products, then weight gradients
        ("q/k/v fwd, one", rows, d, d), ("q/k/v fwd, tp 2", rows, d, d // 2),
        ("o fwd, one", rows, d, d), ("o fwd, tp 2", rows, d // 2, d),
        ("fc1 fwd, one", rows, d, ff), ("fc1 fwd, tp 2", rows, d, ff // 2),
        ("fc2 fwd, one", rows, ff, d), ("fc2 fwd, tp 2", rows, ff // 2, d),
        ("q/k/v dW, one", d, rows, d), ("q/k/v dW, tp 2", d, rows, d // 2),
        ("o dW, one", d, rows, d), ("o dW, tp 2", d // 2, rows, d),
        ("fc1 dW, one", d, rows, ff), ("fc1 dW, tp 2", d, rows, ff // 2),
        ("fc2 dW, one", ff, rows, d), ("fc2 dW, tp 2", ff // 2, rows, d),
        ("q/k/v dW, dp 2", d, rows // 2, d), ("fc2 dW, dp 2", ff, rows // 2, d),
    ]
    for name, m, k, n in cases:
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = torch.randn(k, n, device="cuda", generator=gen).to(torch.bfloat16)
        exact = x.double() @ w.double()
        scale = exact.abs().max()
        out = []
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow
            err = (torch.mm(x, w, out_dtype=torch.float32).double() - exact).abs()
            out.append(f"reduced {'on ' if allow else 'off'}: max "
                       f"{float(err.max() / scale):.2e} rms "
                       f"{float(err.square().mean().sqrt() / scale):.2e}")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        print(f"  products {name:16s} [{m}x{k}]@[{k}x{n}]  " + "; ".join(out),
              flush=True)


def heads() -> None:
    from whisperseg_torch.audio.frontend import Frontend
    from whisperseg_torch.models import whisper
    from whisperseg_torch.ops import attention
    from whisperseg_torch.synthetic import tone_bursts
    from whisperseg_torch.training import trainer

    dev = torch.device("cuda")
    params, cfg = trainer.load_model_any(BASE, 1000, 0.0)
    p = trainer.training_params(params, dev)
    audio = np.concatenate([tone_bursts(s, duration=2.5) for s in range(700, 704)])
    x = torch.from_numpy(audio.reshape(4, -1).astype(np.float32)).to(dev)
    feats = Frontend(32000, 0.0025).features_for_clips(x, 1000)
    calls = []
    inner = attention.attention_hm_backward

    def kept(valid_len, q4, kt4, v4, o, do, lse):
        out = inner(valid_len, q4, kt4, v4, o, do, lse)
        calls.append((valid_len, q4, kt4, v4, o, do, lse, out))
        return out
    attention.attention_hm_backward = kept
    try:
        enc = whisper.encoder_forward(p, cfg, feats)
        r = torch.randn(enc.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        (enc.float() * r).sum().backward()
    finally:
        attention.attention_hm_backward = inner

    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).abs().max() / b.abs().max())
    # the backward runs the layers last to first
    for layer, (vl, q4, kt4, v4, o, do, lse, (dq, dkt, dv)) in zip(
            range(len(calls) - 1, -1, -1), calls):
        pq, pk, pv = attention.attention_hm_backward_reference(
            vl, q4, kt4, v4, o, do, lse)
        line = [f"  heads layer {layer}, 8 heads against the plain version: "
                f"dq {rel(dq, pq):.2e} dk {rel(dkt, pk):.2e} dv {rel(dv, pv):.2e}"]
        for s in (slice(0, 4), slice(4, 8)):
            qh, kh, vh, doh = (t[:, s].contiguous() for t in (q4, kt4, v4, do))
            oh, lseh = attention.fused_attention_head_major(vl, qh, kh, vh,
                                                            with_lse=True)
            dqh, dkh, dvh = inner(vl, qh, kh, vh, oh, doh, lseh)
            same = all(torch.equal(a, b[:, s]) for a, b in (
                (oh, o), (lseh, lse), (dqh, dq), (dkh, dkt), (dvh, dv)))
            line.append(f"heads {s.start}-{s.stop - 1} in a 4-head launch: "
                        f"{'bit-identical' if same else 'DIFFERENT'}")
        print("; ".join(line), flush=True)


def perturb() -> None:
    import chip_smoke
    from whisperseg_torch.synthetic import write_tone_dataset
    from whisperseg_torch.training import trainer

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp()
    data = write_tone_dataset(os.path.join(tmp, "data"),
                              chip_smoke.TRAIN_FILES, seed=700)
    chip_smoke.PARALLEL_STEPS = 1

    def step(dtype, scale):
        with chip_smoke.StepProbe(scale=scale) as probe:
            trainer.run_training(chip_smoke.parallel_args(
                chip_smoke.parallel_model(tmp, dtype), data,
                os.path.join(tmp, f"{dtype}-{scale}"), 1e-6, n_device=1,
                device=dev))
        return probe

    for dtype in ("bfloat16", "float32"):
        base = step(dtype, 1.0)
        for eps in (1e-7, 1e-6, 1e-5, 1e-4, 1e-3):
            got = step(dtype, 1 + eps)
            print(f"  perturb {dtype} features x (1 + {eps:g}): loss "
                  f"{abs(got.losses[0] - base.losses[0]) / base.losses[0]:.2e}, "
                  f"gradient norm "
                  f"{abs(got.grad_norm - base.grad_norm) / base.grad_norm:.2e} "
                  f"({got.grad_norm:.4f} against {base.grad_norm:.4f}); "
                  f"{chip_smoke._leaf_gaps(got.grad_leaves, base.grad_leaves)}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_bf16_numerics: no CUDA device", file=sys.stderr)
        return 1
    from whisperseg_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    parts = sys.argv[1:] or ["products", "heads", "perturb"]
    for part in parts:
        {"products": products, "heads": heads, "perturb": perturb}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
