"""Whisper encoder, frame head and KV-cache decoder over a tree of tensors.

The port of the inference half of ``whisperseg_tpu/models/whisper.py``, with
its layouts: stacked layer weights ``[L, in, out]`` applied as ``x @ w``, conv
kernels ``[3, in, out]``, features ``[B, 80, T]``, the self-attention cache
``[L, B, max_len, Hkv, hd]``.

Numerics follow the JAX package: matmul inputs are cast to
``cfg.compute_dtype`` with float32 results (``_dot``), LayerNorm and softmax
run in float32, the residual stream stays float32. The encoder always takes
the head-major attention path, whose kernel is ops/attention.py.

Quantized weights (ops/quant.py) go through ``_dot`` to ``qdot``, whose
small-M products are the w8a16 / w4a16 kernels; the head-major encoder
projections dequantize the whole weight first, as the JAX package does. With
int8 cross K/V every single-token step runs the kernel of
ops/cross_attention.py, MHA or GQA, whatever the width: the JAX call site's
further gates (MHA only, Dkv >= 256) answer a TPU compiler fault and a TPU
timing policy, and do not carry over.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention_head_major
from ..ops.cross_attention import (cross_attention_int8, dequantize_kv,
                                   quantize_kv_for_kernel)
from ..ops.dot import dot_f32
from ..ops.quant import Quant4Tensor, QuantTensor, dequantize, qdot
from .config import WhisperConfig

Params = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: WhisperConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}; "
                         f"choose from {sorted(_DTYPES)}") from None


# ---------------------------------------------------------------- primitives


def _layer_norm(x, g, b, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return (x32 - mean) * torch.rsqrt(var + eps) * g + b


def _dot(x, w, cdt):
    """x @ w with a float32 result: a quantized weight goes to ``qdot``
    (bf16 numerics whatever ``cdt``), a plain one to ``dot_f32``."""
    if isinstance(w, (QuantTensor, Quant4Tensor)):
        return qdot(x, w)
    return dot_f32(x, w, cdt)


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads)


def _attention(q, k, v, cdt, mask=None):
    """q [B, Lq, H, hd]; k, v [B, Lk, Hkv, hd] (GQA when Hkv < H); mask
    broadcastable to [B, H, Lq, Lk] -> [B, Lq, H*hd] float32.

    As in the JAX package the scores are produced in bf16 under bf16 compute
    (float32 otherwise) and the softmax runs in float32. The probability-value
    product comes back in ``cdt``: under bf16 that is the float32 sum rounded
    once, the value the output projection's cast to bf16 would make of it."""
    hd = q.shape[-1]
    h, hk = q.shape[2], k.shape[2]
    qs = (q * hd ** -0.5).to(cdt)
    k, v = k.to(cdt), v.to(cdt)
    neg = torch.tensor(-1e30, dtype=cdt, device=q.device)
    if h != hk:
        b, lq = q.shape[:2]
        q5 = qs.reshape(b, lq, hk, h // hk, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k)
        if mask is not None:
            scores = torch.where(mask[:, :, None], scores, neg)
        probs = torch.softmax(scores.float(), dim=-1).to(cdt)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return out.reshape(b, lq, h * hd).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    if mask is not None:
        scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores.float(), dim=-1).to(cdt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    b, lq = out.shape[:2]
    return out.reshape(b, lq, h * hd).float()


def _project_heads(h, w, b, heads: int, cdt):
    """h [B, S, D] @ w [D, heads*hd] (+ b) -> [B, heads, S, hd] in cdt. Like
    the other two head-major projections it dequantizes a quantized weight
    whole, in cdt."""
    y = dot_f32(h, dequantize(w, cdt), cdt)
    if b is not None:
        y = y + b
    bsz, s, _ = y.shape
    return y.reshape(bsz, s, heads, -1).permute(0, 2, 1, 3).to(cdt).contiguous()


def _project_heads_t(h, w, heads: int, cdt):
    """h [B, S, D] @ w [D, heads*hd] -> [B, heads, hd, S] (K pre-transposed)."""
    y = dot_f32(h, dequantize(w, cdt), cdt)
    bsz, s, _ = y.shape
    return y.reshape(bsz, s, heads, -1).permute(0, 2, 3, 1).to(cdt).contiguous()


def _oproj_heads(a4, w, b, cdt):
    """a4 [B, H, S, hd] @ w [H*hd, D] + b -> [B, S, D] float32."""
    bsz, heads, s, hd = a4.shape
    a = a4.permute(0, 2, 1, 3).reshape(bsz, s, heads * hd)
    return dot_f32(a, dequantize(w, cdt), cdt) + b


def _conv3(x, w, stride: int, cdt):
    """Width-3 convolution with padding 1 as ONE matmul over the taps:
    x [B, T, C], w [3, C, D] (HIO) -> [B, T_out, D] float32. Kept off cuDNN
    so a float32 model never meets cuDNN's default TF32. The JAX source
    writes the conv in ``cdt`` and widens it, but XLA (excess precision is
    allowed by default) drops that bf16 round trip under ``jit``, so the
    JAX package's compiled encoder keeps the float32 sum, as here."""
    bsz, t, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1))
    t_out = (t - 1) // stride + 1
    span = stride * (t_out - 1) + 1
    cols = torch.cat([xp[:, k:k + span:stride] for k in range(3)], dim=-1)
    return _dot(cols, w.reshape(3 * c, -1), cdt)


def _layer(layers: Params, i: int) -> Params:
    return {k: v[i] for k, v in layers.items()}


# ------------------------------------------------------------------- encoder


def encoder_forward(params: Params, cfg: WhisperConfig,
                    features: torch.Tensor) -> torch.Tensor:
    """Log-mel features [B, num_mel_bins, T] -> encoder states [B, T // 2, D]
    float32. The layers run at S rounded up to a multiple of 128 (padded rows
    never reach a valid key: the attention kernel masks keys >= S)."""
    enc = params["encoder"]
    cdt = compute_dtype(cfg)
    x = features.to(cdt).transpose(1, 2)                        # [B, T, 80]
    x = F.gelu(_conv3(x, enc["conv1_w"], 1, cdt) + enc["conv1_b"])
    x = F.gelu(_conv3(x, enc["conv2_w"], 2, cdt) + enc["conv2_b"])
    s = x.shape[1]
    x = (x + enc["pos_emb"][:s]).float()

    heads, kv_heads = cfg.num_heads, cfg.kv_heads
    sp = -(-s // 128) * 128
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))
    for i in range(cfg.encoder_layers):
        lp = _layer(enc["layers"], i)
        h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q4 = _project_heads(h, lp["q_w"], lp["q_b"], heads, cdt)
        kt4 = _project_heads_t(h, lp["k_w"], kv_heads, cdt)
        v4 = _project_heads(h, lp["v_w"], lp["v_b"], kv_heads, cdt)
        a4 = fused_attention_head_major(s, q4, kt4, v4)        # [B, H, Sp, hd]
        x = x + _oproj_heads(a4, lp["o_w"], lp["o_b"], cdt)
        h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        h = F.gelu(_dot(h, lp["fc1_w"], cdt) + lp["fc1_b"])
        x = x + (_dot(h, lp["fc2_w"], cdt) + lp["fc2_b"])
    return _layer_norm(x[:, :s], enc["ln_post_g"], enc["ln_post_b"])


def frame_head_forward(params: Params, cfg: WhisperConfig,
                       enc_out: torch.Tensor) -> torch.Tensor:
    """Encoder states [B, S, D] -> frame logits [B, S, 3 + C] float32
    (vocal, onset, offset, then cluster logits)."""
    fh = params["frame_head"]
    cdt = compute_dtype(cfg)
    h = _layer_norm(enc_out, fh["ln_g"], fh["ln_b"])
    h = F.gelu(_dot(h, fh["h1_w"], cdt) + fh["h1_b"])
    return (_dot(h, fh["h2_w"], cdt) + fh["h2_b"]).float()


# ------------------------------------------------------------------- decoder


def precompute_cross_kv(params: Params, cfg: WhisperConfig,
                        enc_out: torch.Tensor, int8_kv: bool = False):
    """Cross-attention K/V of every decoder layer: ([Ld, B, S, Hkv, hd],
    same) in the compute dtype. With ``int8_kv`` each becomes a pair (int8
    values [Ld, B, S, Hkv*hd], bf16 scales [Ld, B, S, Hkv]), quantized from
    the compute-dtype K/V (ops/cross_attention.py)."""
    layers = params["decoder"]["layers"]
    cdt = compute_dtype(cfg)
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        lp = _layer(layers, i)
        ks.append(_split_heads(_dot(enc_out, lp["xk_w"], cdt), cfg.kv_heads).to(cdt))
        vs.append(_split_heads(_dot(enc_out, lp["xv_w"], cdt) + lp["xv_b"],
                               cfg.kv_heads).to(cdt))
    k, v = torch.stack(ks), torch.stack(vs)
    if not int8_kv:
        return k, v
    kq, k_scale, vq, v_scale, _ = quantize_kv_for_kernel(k, v)
    return (kq, k_scale), (vq, v_scale)


def init_cache(cfg: WhisperConfig, batch: int, max_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed self-attention cache [Ld, B, max_len, Hkv, hd] (compute dtype)."""
    shape = (cfg.decoder_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    cdt = compute_dtype(cfg)
    return (torch.zeros(shape, dtype=cdt, device=device),
            torch.zeros(shape, dtype=cdt, device=device))


def decoder_step(params: Params, cfg: WhisperConfig, cross_k, cross_v,
                 input_ids: torch.Tensor, pos0: int, cache_k, cache_v,
                 cross_seq_len: int = 0):
    """Run the decoder over a chunk of new tokens ``input_ids`` [B, Lc] at
    absolute positions ``pos0 .. pos0 + Lc - 1`` (prefill: the prompt; decode:
    one token). Query ``qi`` of the chunk sees cache positions
    ``<= pos0 + qi``. ``cross_k`` / ``cross_v`` are tensors, or the int8
    pairs of ``precompute_cross_kv(int8_kv=True)`` together with
    ``cross_seq_len``, their number of valid encoder positions: a single
    token then goes through the int8 cross-attention kernel, a longer chunk
    (the prefill) dequantizes the pairs once.

    Returns (logits [B, Lc, vocab] float32, cache_k, cache_v). Unlike the
    JAX version the caches are updated in place (and returned for symmetry)."""
    dec = params["decoder"]
    cdt = compute_dtype(cfg)
    heads, kv_heads = cfg.num_heads, cfg.kv_heads
    lc = input_ids.shape[1]
    max_len = cache_k.shape[2]
    device = input_ids.device

    # The JAX source adds the two embeddings in the parameters' dtype and
    # widens the sum; under jit XLA drops that bf16 round trip (excess
    # precision), so the compiled program adds in float32, as here.
    x = (dec["tok_emb"][input_ids].float()
         + dec["pos_emb"][pos0:pos0 + lc][None].float())
    key_pos = torch.arange(max_len, device=device)[None, None, None, :]
    qi = torch.arange(lc, device=device)[None, None, :, None]
    self_mask = key_pos <= pos0 + qi                           # [1, 1, Lc, K]

    for i in range(cfg.decoder_layers):
        lp = _layer(dec["layers"], i)
        h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(_dot(h, lp["q_w"], cdt) + lp["q_b"], heads)
        k = _split_heads(_dot(h, lp["k_w"], cdt), kv_heads).to(cdt)
        v = _split_heads(_dot(h, lp["v_w"], cdt) + lp["v_b"], kv_heads).to(cdt)
        cache_k[i, :, pos0:pos0 + lc] = k
        cache_v[i, :, pos0:pos0 + lc] = v
        a = _attention(q, cache_k[i], cache_v[i], cdt, mask=self_mask)
        x = x + _dot(a, lp["o_w"], cdt) + lp["o_b"]

        h = _layer_norm(x, lp["lnx_g"], lp["lnx_b"])
        q2d = _dot(h, lp["xq_w"], cdt) + lp["xq_b"]
        if isinstance(cross_k, tuple):
            (kq, k_scale), (vq, v_scale) = cross_k, cross_v
            if lc == 1:
                a = cross_attention_int8(
                    q2d[:, 0], kq[i], k_scale[i], vq[i], v_scale[i], kv_heads,
                    cross_seq_len, num_q_heads=heads)[:, None]
            else:
                kd = dequantize_kv(kq[i], k_scale[i], kv_heads, cross_seq_len)
                vd = dequantize_kv(vq[i], v_scale[i], kv_heads, cross_seq_len)
                a = _attention(_split_heads(q2d, heads), kd.to(cdt),
                               vd.to(cdt), cdt)
        else:
            a = _attention(_split_heads(q2d, heads), cross_k[i], cross_v[i],
                           cdt)
        x = x + _dot(a, lp["xo_w"], cdt) + lp["xo_b"]

        h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        h = F.gelu(_dot(h, lp["fc1_w"], cdt) + lp["fc1_b"])
        x = x + _dot(h, lp["fc2_w"], cdt) + lp["fc2_b"]

    x = _layer_norm(x, dec["ln_post_g"], dec["ln_post_b"])
    logits = _dot(x, dec["tok_emb"].T, cdt)
    return logits, cache_k, cache_v
