"""WhisperSeg's encoder-decoder, frame head and token loss in float32 PyTorch.

Written from the published Whisper architecture (Radford et al. 2022,
"Robust Speech Recognition via Large-Scale Weak Supervision", and the
``openai/whisper`` model code): two width-3 convolutions with GELU (the
second of stride 2), sinusoidal encoder positions, pre-LayerNorm blocks of
multi-head attention (no key bias) and a GELU MLP, a final LayerNorm; the
decoder adds learned positions to the token embedding, runs causal
self-attention and cross-attention over the encoder states, and reads its
logits through the transposed token embedding. WhisperSeg's frame head is
LayerNorm, dense, GELU, dense to [vocal, onset, offset, clusters].

Weights are a flat dict of tensors keyed as the repository's checkpoint file
(``params.npz``) keys them, with layer weights stacked ``[L, in, out]`` and
applied as ``x @ w``. Everything runs in float32 with TF32 off, on
whole sequences: no cache, no kernels, no batching across windows beyond
the blocks the caller passes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# "fp8": every product with a weight (projections, convolutions, the
# frame head, the logits) takes its inputs rounded to float8 e4m3, the
# activations scaled per row and the weights per output column; the
# benchmark's control, the nearest precision below the configuration's bf16
_PRECISION = {"products": "float32"}


@contextlib.contextmanager
def lower_precision():
    """Run the reference with float8 (e4m3) products inside the block."""
    _PRECISION["products"] = "fp8"
    try:
        yield
    finally:
        _PRECISION["products"] = "float32"


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along ``dim``; the
    gradient passes straight through the rounding."""
    scale = (x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
             / 448.0)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, in the block's precision."""
    if _PRECISION["products"] == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    return x @ w


def _conv(x, w, b, stride):
    """Width-3 convolution (padding 1) of x [B, C, T] with w [3, C, D]."""
    w = w.permute(2, 1, 0)
    if _PRECISION["products"] == "fp8":
        x, w = _fp8(x, 1), _fp8(w.flatten(1), 1).reshape(w.shape)
    return F.conv1d(x, w, b, stride=stride, padding=1)


def no_tf32() -> None:
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder position table: sines, then cosines."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps=1e-5)


def _heads(x, h):
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).transpose(1, 2)


def _attend(q, k, v, heads, causal=False):
    """q [B, Lq, D], k / v [B, Lk, D] -> [B, Lq, D]."""
    q, k, v = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = scores.shape[-2:]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    b, h, l, hd = out.shape
    return out.transpose(1, 2).reshape(b, l, h * hd)


def _layer(w: Weights, prefix: str, i: int) -> Weights:
    n = len(prefix)
    return {k[n:]: v[i] for k, v in w.items() if k.startswith(prefix)}


def _self_block(x, p, heads, causal):
    h = _ln(x, p["ln1_g"], p["ln1_b"])
    a = _attend(_lin(h, p["q_w"]) + p["q_b"], _lin(h, p["k_w"]),
                _lin(h, p["v_w"]) + p["v_b"], heads, causal)
    return x + _lin(a, p["o_w"]) + p["o_b"]


def _mlp(x, p):
    h = _ln(x, p["ln2_g"], p["ln2_b"])
    return x + _lin(F.gelu(_lin(h, p["fc1_w"]) + p["fc1_b"]),
                    p["fc2_w"]) + p["fc2_b"]


def encoder(w: Weights, feats: torch.Tensor, layers: int, heads: int):
    """Features [B, 80, T] -> encoder states [B, T // 2, D]."""
    x = F.gelu(_conv(feats, w["encoder.conv1_w"], w["encoder.conv1_b"], 1))
    x = F.gelu(_conv(x, w["encoder.conv2_w"], w["encoder.conv2_b"], 2))
    x = x.transpose(1, 2)
    x = x + w["encoder.pos_emb"][:x.shape[1]]
    for i in range(layers):
        p = _layer(w, "encoder.layers.", i)
        x = _mlp(_self_block(x, p, heads, causal=False), p)
    return _ln(x, w["encoder.ln_post_g"], w["encoder.ln_post_b"])


def decoder(w: Weights, enc: torch.Tensor, ids: torch.Tensor, layers: int,
            heads: int):
    """Teacher-forced decoder: encoder states [B, S, D], ids [B, L] ->
    logits [B, L, vocab]."""
    x = w["decoder.tok_emb"][ids] + w["decoder.pos_emb"][:ids.shape[1]]
    for i in range(layers):
        p = _layer(w, "decoder.layers.", i)
        x = _self_block(x, p, heads, causal=True)
        h = _ln(x, p["lnx_g"], p["lnx_b"])
        a = _attend(_lin(h, p["xq_w"]) + p["xq_b"], _lin(enc, p["xk_w"]),
                    _lin(enc, p["xv_w"]) + p["xv_b"], heads)
        x = _mlp(x + _lin(a, p["xo_w"]) + p["xo_b"], p)
    x = _ln(x, w["decoder.ln_post_g"], w["decoder.ln_post_b"])
    return _lin(x, w["decoder.tok_emb"].T)


def frame_head(w: Weights, enc: torch.Tensor) -> torch.Tensor:
    """Encoder states [B, S, D] -> frame logits [B, S, 3 + clusters]."""
    h = _ln(enc, w["frame_head.ln_g"], w["frame_head.ln_b"])
    h = F.gelu(_lin(h, w["frame_head.h1_w"]) + w["frame_head.h1_b"])
    return _lin(h, w["frame_head.h2_w"]) + w["frame_head.h2_b"]


def token_loss(logits: torch.Tensor, labels: torch.Tensor,
               ignore: int = -100) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not ``ignore``."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=ignore)


class AdamW:
    """Adam with decoupled weight decay (Loshchilov and Hutter 2019), as a
    loop over the leaves: ``p -= lr * wd * p``, then the bias-corrected
    Adam step. ``decay`` names the leaves that take weight decay."""

    def __init__(self, params: Weights, decay, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.params, self.decay = params, set(decay)
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Weights, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            if k in self.decay:
                p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def linear_warmup(step: int, lr: float, warmup: int, total: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based): a linear
    ramp over ``warmup`` steps, then a linear decay to 0 at ``total``."""
    if step < warmup:
        return lr * step / max(warmup, 1)
    return lr * max(0.0, (total - step) / max(total - warmup, 1))


def weights_on(w: Weights, device, requires_grad: bool = False) -> Weights:
    return {k: v.detach().to(device=device, dtype=torch.float32)
            .clone().requires_grad_(requires_grad) for k, v in w.items()}


def decay_leaves(names) -> list:
    """Leaves that take weight decay: all but biases and LayerNorm gains."""
    return [k for k in names if not (k.endswith("_b") or k.endswith("_g"))]
