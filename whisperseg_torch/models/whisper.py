"""Whisper encoder, frame head and KV-cache decoder over a tree of tensors.

The port of the inference half of ``whisperseg_tpu/models/whisper.py``, with
its layouts: stacked layer weights ``[L, in, out]`` applied as ``x @ w``, conv
kernels ``[3, in, out]``, features ``[B, 80, T]``, the self-attention cache
``[L, B, max_len, Hkv, hd]``. The decode step's cross K/V is head-major,
``[L, B, Hkv, S, hd]``, one row a window that its beams share.

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

The training half: parameter init, dropout, ``encoder_forward(train=...)``
with remat, the teacher-forced ``decoder_forward_train``, the token loss
and the frame-head loss. Parameters are float32 leaf tensors; compute casts
to ``cfg.compute_dtype`` as ``_dot`` does. Under autograd the encoder's
attention is ``EncoderAttention`` (forward kernel plus two backward kernels,
ops/attention.py). Dropout draws from ``torch.Generator``s: each layer's
seed is drawn from the caller's generator before the layer runs, and its
masks come from a generator made from that seed inside the layer, so a
rematerialized layer makes the same masks (JAX splits one key per layer).

Under tensor parallelism (parallel/mesh.py ``model_parallel``) a rank holds
a column slice of q/k/v/fc1 (and xq/xk/xv) and a row slice of o/fc2/xo,
and runs with ``num_heads / tp`` heads of the same width (``_split_heads``
derives the width from the local one): each column-parallel input goes
through ``copy_to_model`` and each row-parallel product through
``reduce_from_model`` before its bias. Without a model group both are the
identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tokenizer as tok
from ..ops.attention import encoder_attention
from ..ops.cross_attention import (cross_attention_int8, dequantize_kv,
                                   quantize_kv_for_kernel)
from ..ops.dot import dot_f32
from ..ops.quant import Quant4Tensor, QuantTensor, dequantize, qdot
from ..parallel.mesh import copy_to_model, reduce_from_model
from .config import WhisperConfig

Params = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: WhisperConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}; "
                         f"choose from {sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------- init


def sinusoid_position_table(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position embedding (sin half, then cos half)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def _dense_init(gen: torch.Generator, shape, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen) * scale


def _layer_params(gen: torch.Generator, cfg: WhisperConfig, cross: bool) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dkv = cfg.kv_heads * cfg.head_dim  # < d under grouped-query attention
    ones, zeros = torch.ones, torch.zeros
    p = {
        "ln1_g": ones(d), "ln1_b": zeros(d),
        "q_w": _dense_init(gen, (d, d)), "q_b": zeros(d),
        "k_w": _dense_init(gen, (d, dkv)),
        "v_w": _dense_init(gen, (d, dkv)), "v_b": zeros(dkv),
        "o_w": _dense_init(gen, (d, d)), "o_b": zeros(d),
        "ln2_g": ones(d), "ln2_b": zeros(d),
        "fc1_w": _dense_init(gen, (d, f)), "fc1_b": zeros(f),
        "fc2_w": _dense_init(gen, (f, d)), "fc2_b": zeros(d),
    }
    if cross:
        p.update({
            "lnx_g": ones(d), "lnx_b": zeros(d),
            "xq_w": _dense_init(gen, (d, d)), "xq_b": zeros(d),
            "xk_w": _dense_init(gen, (d, dkv)),
            "xv_w": _dense_init(gen, (d, dkv)), "xv_b": zeros(dkv),
            "xo_w": _dense_init(gen, (d, d)), "xo_b": zeros(d),
        })
    return p


def _stack_layers(gen: torch.Generator, cfg: WhisperConfig, n: int,
                  cross: bool) -> Params:
    layers = [_layer_params(gen, cfg, cross) for _ in range(n)]
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def init_encoder(gen: torch.Generator, cfg: WhisperConfig) -> Params:
    """Fresh float32 encoder parameters on the CPU, drawn from ``gen``."""
    d = cfg.d_model
    return {
        "conv1_w": _dense_init(gen, (3, cfg.num_mel_bins, d),
                               scale=1.0 / math.sqrt(3 * cfg.num_mel_bins)),
        "conv1_b": torch.zeros(d),
        "conv2_w": _dense_init(gen, (3, d, d), scale=1.0 / math.sqrt(3 * d)),
        "conv2_b": torch.zeros(d),
        "pos_emb": torch.from_numpy(
            sinusoid_position_table(cfg.max_source_positions, d)),
        "layers": _stack_layers(gen, cfg, cfg.encoder_layers, cross=False),
        "ln_post_g": torch.ones(d), "ln_post_b": torch.zeros(d),
    }


def init_params(gen: torch.Generator, cfg: WhisperConfig) -> Params:
    """Fresh float32 parameters on the CPU, drawn from ``gen`` (the JAX
    package's shapes and scales; its random stream cannot be matched)."""
    d = cfg.d_model
    encoder = init_encoder(gen, cfg)
    decoder = {
        "tok_emb": _dense_init(gen, (cfg.vocab_size, d), scale=0.02),
        "pos_emb": torch.zeros(cfg.max_target_positions, d),
        "layers": _stack_layers(gen, cfg, cfg.decoder_layers, cross=True),
        "ln_post_g": torch.ones(d), "ln_post_b": torch.zeros(d),
    }
    params = {"encoder": encoder, "decoder": decoder}
    if cfg.frame_head:
        params["frame_head"] = init_frame_head(gen, cfg)
    return params


def init_frame_head(gen: torch.Generator, cfg: WhisperConfig) -> Params:
    """Parameters of the per-encoder-position head: LN -> dense -> gelu ->
    dense to [vocal, onset, offset] (+ cluster logits)."""
    d = cfg.d_model
    hidden = max(d // 2, 64)
    out = 3 + cfg.frame_head_clusters
    return {
        "ln_g": torch.ones(d), "ln_b": torch.zeros(d),
        "h1_w": _dense_init(gen, (d, hidden)), "h1_b": torch.zeros(hidden),
        "h2_w": _dense_init(gen, (hidden, out)), "h2_b": torch.zeros(out),
    }


def ensure_frame_head(params: Params, cfg: WhisperConfig,
                      gen: torch.Generator) -> Params:
    """Add a freshly initialized frame head to a tree that lacks one; on a
    change of cluster count keep the trained layers and widen or narrow the
    output layer. A head of the right width is kept as it is."""
    fh = params.get("frame_head")
    want_out = 3 + cfg.frame_head_clusters
    if fh is not None and fh["h2_w"].shape[-1] == want_out:
        return params
    new = dict(params)
    head = init_frame_head(gen, cfg)
    if fh is not None:
        keep = min(fh["h2_w"].shape[-1], want_out)
        w2, b2 = head["h2_w"].clone(), torch.zeros(want_out)
        w2[:, :keep] = fh["h2_w"][:, :keep].detach().cpu()
        b2[:keep] = fh["h2_b"][:keep].detach().cpu()
        head = {k: v.detach().cpu() for k, v in fh.items()}
        head["h2_w"], head["h2_b"] = w2, b2
    new["frame_head"] = head
    return new


def num_parameters(params: Params) -> int:
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(node.numel())
    return count(params)


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


def _neg(cdt, device) -> torch.Tensor:
    """The masked score, -1e30 in ``cdt`` on ``device``, made by a caller of
    :func:`_attention` (``decoder_step`` once for all its layers)."""
    return torch.full((), -1e30, dtype=cdt, device=device)


def _attention(q, k, v, cdt, mask=None, neg=None):
    """q [B, Lq, H, hd]; k, v [B, Lk, Hkv, hd] (GQA when Hkv < H); mask
    broadcastable to [B, H, Lq, Lk] -> [B, Lq, H*hd] float32. With a mask
    comes ``neg`` (:func:`_neg`), the score the masked keys take.

    As in the JAX package the scores are produced in bf16 under bf16 compute
    (float32 otherwise) and the softmax runs in float32. The probability-value
    product comes back in ``cdt``: under bf16 that is the float32 sum rounded
    once, the value the output projection's cast to bf16 would make of it."""
    hd = q.shape[-1]
    h, hk = q.shape[2], k.shape[2]
    qs = (q * hd ** -0.5).to(cdt)
    k, v = k.to(cdt), v.to(cdt)
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


def _cross_attention(q, k, v, cdt):
    """The decoder step's cross-attention over head-major K/V, read in
    place. q [R, Lq, H, hd]; k, v [B, Hkv, S, hd] in ``cdt`` (GQA when
    Hkv < H), R a multiple of B: the R / B query rows of each K/V row,
    consecutive (a window's beams, beam-major), attend to it as
    (R / B) * Lq queries -> [R, Lq, H*hd] float32. The queries are gathered
    head-major, so each product is one batched matmul over (B, Hkv) with
    K/V as they lie. Numerics as :func:`_attention`'s."""
    r, lq, h, hd = q.shape
    b, hk = k.shape[:2]
    n = r // b * lq                            # queries a K/V row and head
    qs = (q * hd ** -0.5).to(cdt).reshape(b, n, hk, h // hk, hd)
    qs = qs.permute(0, 2, 3, 1, 4).reshape(b, hk, h // hk * n, hd)
    scores = torch.matmul(qs, k.transpose(-1, -2))           # [B, Hkv, gn, S]
    probs = torch.softmax(scores.float(), dim=-1).to(cdt)
    out = torch.matmul(probs, v)                              # [B, Hkv, gn, hd]
    out = out.reshape(b, hk, h // hk, n, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(r, lq, h * hd).float()


def _dense(w, cdt):
    """A quantized weight dequantized whole in ``cdt``; a plain one as it is
    (``dot_f32`` casts it, so a float32 master weight keeps a float32
    gradient)."""
    if isinstance(w, (QuantTensor, Quant4Tensor)):
        return dequantize(w, cdt)
    return w


def _project_heads(h, w, b, heads: int, cdt):
    """h [B, S, D] @ w [D, heads*hd] (+ b) -> [B, heads, S, hd] in cdt. Like
    the other two head-major projections it dequantizes a quantized weight
    whole, in cdt."""
    y = dot_f32(h, _dense(w, cdt), cdt)
    if b is not None:
        y = y + b
    bsz, s, _ = y.shape
    return y.reshape(bsz, s, heads, -1).permute(0, 2, 1, 3).to(cdt).contiguous()


def _project_heads_t(h, w, heads: int, cdt):
    """h [B, S, D] @ w [D, heads*hd] -> [B, heads, hd, S] (K pre-transposed)."""
    y = dot_f32(h, _dense(w, cdt), cdt)
    bsz, s, _ = y.shape
    return y.reshape(bsz, s, heads, -1).permute(0, 2, 3, 1).to(cdt).contiguous()


def _oproj_heads(a4, w, b, cdt):
    """a4 [B, H, S, hd] @ w [H*hd, D] + b -> [B, S, D] float32 (a
    row-parallel product: summed over the model axis before the bias)."""
    bsz, heads, s, hd = a4.shape
    a = a4.permute(0, 2, 1, 3).reshape(bsz, s, heads * hd)
    return reduce_from_model(dot_f32(a, _dense(w, cdt), cdt)) + b


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


def _layers(layers: Params, n: int) -> List[Params]:
    """Per-layer views of stacked ``[L, ...]`` leaves. A leaf that takes a
    gradient is unbound once, so its backward stacks the layers' gradients in
    one op instead of summing L full-size ones."""
    cols = {k: (v.unbind(0) if isinstance(v, torch.Tensor) and v.requires_grad
                else [v[i] for i in range(n)]) for k, v in layers.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _dropout(x, rate: float, gen: torch.Generator):
    """Keep each element with probability ``1 - rate`` and scale the kept
    ones by ``1 / (1 - rate)``."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def _layer_seeds(gen: Optional[torch.Generator], n: int) -> List[Optional[int]]:
    """One dropout seed per layer, drawn before any layer runs."""
    if gen is None:
        raise ValueError("dropout needs a torch.Generator")
    return torch.randint(0, 2 ** 62, (n,), generator=gen).tolist()


def _seeded(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _run(layer_fn, remat: bool, x, *args):
    """One layer, rematerialized in the backward under ``remat``. Its dropout
    masks come from a seed among ``args``, so the recomputation makes the
    same ones; the global RNG state is not involved and is not saved."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer_fn, x, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return layer_fn(x, *args)


# ------------------------------------------------------------------- encoder


def _encoder_layer(x, lp: Params, s: int, cfg: WhisperConfig, rate: float,
                   seed: Optional[int]):
    cdt = compute_dtype(cfg)
    gen = _seeded(seed, x.device) if rate > 0.0 else None
    h = copy_to_model(_layer_norm(x, lp["ln1_g"], lp["ln1_b"]))
    q4 = _project_heads(h, lp["q_w"], lp["q_b"], cfg.num_heads, cdt)
    kt4 = _project_heads_t(h, lp["k_w"], cfg.kv_heads, cdt)
    v4 = _project_heads(h, lp["v_w"], lp["v_b"], cfg.kv_heads, cdt)
    a4 = encoder_attention(s, q4, kt4, v4)                    # [B, H, Sp, hd]
    a = _oproj_heads(a4, lp["o_w"], lp["o_b"], cdt)
    if rate > 0.0:
        a = _dropout(a, rate, gen)
    x = x + a
    h = copy_to_model(_layer_norm(x, lp["ln2_g"], lp["ln2_b"]))
    h = F.gelu(_dot(h, lp["fc1_w"], cdt) + lp["fc1_b"])
    h = reduce_from_model(_dot(h, lp["fc2_w"], cdt)) + lp["fc2_b"]
    if rate > 0.0:
        h = _dropout(h, rate, gen)
    return x + h


def encoder_forward(params: Params, cfg: WhisperConfig, features: torch.Tensor,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Log-mel features [B, num_mel_bins, T] -> encoder states [B, T // 2, D]
    float32. The layers run at S rounded up to a multiple of 128 (padded rows
    never reach a valid key: the attention kernel masks keys >= S).
    ``train`` applies ``cfg.dropout`` (seeds drawn from ``generator``);
    ``cfg.remat`` recomputes each layer in the backward."""
    enc = params["encoder"]
    cdt = compute_dtype(cfg)
    x = features.to(cdt).transpose(1, 2)                        # [B, T, 80]
    x = F.gelu(_conv3(x, enc["conv1_w"], 1, cdt) + enc["conv1_b"])
    x = F.gelu(_conv3(x, enc["conv2_w"], 2, cdt) + enc["conv2_b"])
    s = x.shape[1]
    x = (x + enc["pos_emb"][:s]).float()

    sp = -(-s // 128) * 128
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))
    rate = cfg.dropout if train else 0.0
    n = cfg.encoder_layers
    seeds = _layer_seeds(generator, n) if rate > 0.0 else [None] * n
    for lp, seed in zip(_layers(enc["layers"], n), seeds):
        x = _run(_encoder_layer, cfg.remat, x, lp, s, cfg, rate, seed)
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


def frame_head_loss(logits, targets, cluster_pos_weight: float = 1.0,
                    boundary_weight: float = 1.0, allreduce=None):
    """Multi-task frame loss: sigmoid BCE (mean over all positions) on the
    vocal channel and, scaled by ``boundary_weight``, on the soft onset and
    offset channels; softmax CE over the cluster logits masked to labelled
    positions (``targets["cluster"]`` >= 0), scaled by
    ``cluster_pos_weight``. ``targets``: [B, S] tensors.

    ``allreduce`` (a sum over the ranks that share a global batch) makes
    each mean's denominator the global batch's, so the ranks' losses add up
    to the global batch's loss."""
    def mean(v):
        if allreduce is None:
            return torch.mean(v)
        return v.sum() / allreduce(torch.tensor(float(v.numel()),
                                                device=v.device))

    def bce(logit, target):
        # the stable x - x z + log(1 + exp(-|x|)) form
        return mean(torch.clamp_min(logit, 0) - logit * target
                    + torch.log1p(torch.exp(-logit.abs())))

    loss = (bce(logits[..., 0], targets["vocal"])
            + boundary_weight * (bce(logits[..., 1], targets["onset"])
                                 + bce(logits[..., 2], targets["offset"])))
    cluster = targets.get("cluster")
    if cluster is not None and logits.shape[-1] > 3:
        logp = torch.log_softmax(logits[..., 3:], dim=-1)
        mask = cluster >= 0
        safe = torch.where(mask, cluster, 0).long()
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        count = mask.sum()
        denom = torch.clamp_min(count if allreduce is None
                                else allreduce(count), 1)
        loss = loss + cluster_pos_weight * torch.where(
            mask, nll, torch.zeros((), device=nll.device)).sum() / denom
    return loss


# ------------------------------------------------------------------- decoder


def cross_kv_buffers(cfg: WhisperConfig, batch: int, seq_len: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An empty head-major cross K/V pair [Ld, B, Hkv, S, hd] (compute
    dtype), the layout the decoder step's products read in place
    (:func:`_cross_attention`)."""
    shape = (cfg.decoder_layers, batch, cfg.kv_heads, seq_len, cfg.head_dim)
    cdt = compute_dtype(cfg)
    return (torch.empty(shape, dtype=cdt, device=device),
            torch.empty(shape, dtype=cdt, device=device))


def precompute_cross_kv(params: Params, cfg: WhisperConfig,
                        enc_out: torch.Tensor, int8_kv: bool = False,
                        beams: int = 1,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Cross-attention K/V of every decoder layer, head-major, written into
    ``out`` (a pair of :func:`cross_kv_buffers`) or else into a pair made
    here: one row a window, which its ``beams`` share. With ``int8_kv``
    (``out`` not given) each becomes a pair (int8 values [Ld, B * beams, S,
    Hkv*hd], bf16 scales [Ld, B * beams, S, Hkv]) at one row a beam, since
    the kernel of ops/cross_attention.py reads a row a query: the encoder
    output is repeated to a row a beam, then projected, and quantized in
    the position-major layout."""
    if int8_kv:
        enc_out = enc_out.repeat_interleave(beams, dim=0)
    layers = params["decoder"]["layers"]
    cdt = compute_dtype(cfg)
    k, v = out or cross_kv_buffers(cfg, *enc_out.shape[:2], enc_out.device)
    for i in range(cfg.decoder_layers):
        lp = _layer(layers, i)
        k[i].transpose(1, 2).copy_(
            _split_heads(_dot(enc_out, lp["xk_w"], cdt), cfg.kv_heads))
        v[i].transpose(1, 2).copy_(
            _split_heads(_dot(enc_out, lp["xv_w"], cdt) + lp["xv_b"],
                         cfg.kv_heads))
    if not int8_kv:
        return k, v
    k = k.transpose(2, 3).contiguous()   # position-major, one at a time
    v = v.transpose(2, 3).contiguous()
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
                 input_ids: torch.Tensor, pos0, cache_k, cache_v,
                 truepos: Optional[torch.Tensor] = None,
                 slot_valid: Optional[torch.Tensor] = None):
    """Run the decoder over a chunk of new tokens ``input_ids`` [B, Lc] at
    absolute positions ``pos0 .. pos0 + Lc - 1`` (prefill: the prompt; decode:
    one token), ``pos0`` a 0-dim long tensor on the step's device. Query
    ``qi`` of the chunk sees cache positions ``<= pos0 + qi``. The cache
    write is ``index_copy_`` and the position embedding ``index_select``, so
    no shape or launch depends on the position and a CUDA graph can capture
    the step (decode.py's beam search). ``cross_k`` / ``cross_v`` are the
    head-major tensors of ``precompute_cross_kv``, with B' rows where B is a
    multiple of B': each serves B / B' consecutive rows of the chunk (a
    window's beams, :func:`_cross_attention`). Or they are the int8 pairs of
    ``precompute_cross_kv(int8_kv=True)``, a row each: a single token then
    goes through the int8 cross-attention kernel, a longer chunk (the
    prefill) dequantizes the pairs once.

    Slot mode (speculative decoding, decode.generate_speculative): with
    ``truepos`` [B] (each row's sequence position of ``input_ids[:, 0]``)
    and ``slot_valid`` [B, max_len] (the cache slots that hold committed
    history), ``pos0`` is a cache slot, an int, the same for every row: the
    chunk's K/V go to slots ``pos0 .. pos0 + Lc - 1``, the position
    embeddings come from ``truepos`` (clipped to the table), and query
    ``qi`` sees the valid slots below ``pos0`` and the chunk's slots up to
    its own. Slots at or past ``pos0 + Lc`` are masked for every query, so
    attention runs over the first ``pos0 + Lc`` slots only (the JAX package
    attends over all ``max_len`` of them, the masked ones weighing exactly
    0).

    Returns (logits [B, Lc, vocab] float32, cache_k, cache_v). Unlike the
    JAX version the caches are updated in place (and returned for symmetry)."""
    dec = params["decoder"]
    cdt = compute_dtype(cfg)
    heads, kv_heads = cfg.num_heads, cfg.kv_heads
    lc = input_ids.shape[1]
    device = input_ids.device
    qi = torch.arange(lc, device=device)[None, None, :, None]
    at = pos0 + torch.arange(lc, device=device)    # the chunk's cache slots

    # The JAX source adds the two embeddings in the parameters' dtype and
    # widens the sum; under jit XLA drops that bf16 round trip (excess
    # precision), so the compiled program adds in float32, as here.
    if truepos is None:
        pos_emb = dec["pos_emb"].index_select(0, at)[None]
        keys = cache_k.shape[2]
        key_pos = torch.arange(keys, device=device)[None, None, None, :]
        self_mask = key_pos <= pos0 + qi                       # [1, 1, Lc, K]
    else:
        pos = truepos[:, None] + torch.arange(lc, device=device)[None]
        pos_emb = dec["pos_emb"][pos.clamp(0, dec["pos_emb"].shape[0] - 1)]
        keys = pos0 + lc
        key_pos = torch.arange(keys, device=device)[None, None, None, :]
        in_chunk = (key_pos >= pos0) & (key_pos <= pos0 + qi)  # [1, 1, Lc, K]
        hist = slot_valid[:, None, None, :keys] & (key_pos < pos0)
        self_mask = hist | in_chunk                            # [B, 1, Lc, K]
    x = dec["tok_emb"][input_ids].float() + pos_emb.float()
    neg = _neg(cdt, device)

    for i in range(cfg.decoder_layers):
        lp = _layer(dec["layers"], i)
        h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(_dot(h, lp["q_w"], cdt) + lp["q_b"], heads)
        k = _split_heads(_dot(h, lp["k_w"], cdt), kv_heads).to(cdt)
        v = _split_heads(_dot(h, lp["v_w"], cdt) + lp["v_b"], kv_heads).to(cdt)
        cache_k[i].index_copy_(1, at, k)
        cache_v[i].index_copy_(1, at, v)
        a = _attention(q, cache_k[i, :, :keys], cache_v[i, :, :keys], cdt,
                       mask=self_mask, neg=neg)
        x = x + _dot(a, lp["o_w"], cdt) + lp["o_b"]

        h = _layer_norm(x, lp["lnx_g"], lp["lnx_b"])
        q2d = _dot(h, lp["xq_w"], cdt) + lp["xq_b"]
        if isinstance(cross_k, tuple):
            (kq, k_scale), (vq, v_scale) = cross_k, cross_v
            seq = kq.shape[2]
            if lc == 1:
                a = cross_attention_int8(
                    q2d[:, 0], kq[i], k_scale[i], vq[i], v_scale[i], kv_heads,
                    seq, num_q_heads=heads)[:, None]
            else:
                kd = dequantize_kv(kq[i], k_scale[i], kv_heads, seq)
                vd = dequantize_kv(vq[i], v_scale[i], kv_heads, seq)
                a = _attention(_split_heads(q2d, heads), kd.to(cdt),
                               vd.to(cdt), cdt)
        else:
            a = _cross_attention(_split_heads(q2d, heads), cross_k[i],
                                 cross_v[i], cdt)
        x = x + _dot(a, lp["xo_w"], cdt) + lp["xo_b"]

        h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        h = F.gelu(_dot(h, lp["fc1_w"], cdt) + lp["fc1_b"])
        x = x + _dot(h, lp["fc2_w"], cdt) + lp["fc2_b"]

    x = _layer_norm(x, dec["ln_post_g"], dec["ln_post_b"])
    logits = _dot(x, dec["tok_emb"].T, cdt)
    return logits, cache_k, cache_v


# ---------------------------------------------------------- teacher forcing


def _decoder_layer(x, lp: Params, enc_out, causal, cfg: WhisperConfig,
                   rate: float, seed: Optional[int]):
    cdt = compute_dtype(cfg)
    heads, kv_heads = cfg.num_heads, cfg.kv_heads
    gen = _seeded(seed, x.device) if rate > 0.0 else None
    h = copy_to_model(_layer_norm(x, lp["ln1_g"], lp["ln1_b"]))
    q = _split_heads(_dot(h, lp["q_w"], cdt) + lp["q_b"], heads)
    k = _split_heads(_dot(h, lp["k_w"], cdt), kv_heads)
    v = _split_heads(_dot(h, lp["v_w"], cdt) + lp["v_b"], kv_heads)
    a = reduce_from_model(_dot(_attention(q, k, v, cdt, mask=causal,
                                          neg=_neg(cdt, x.device)),
                               lp["o_w"], cdt)) + lp["o_b"]
    if rate > 0.0:
        a = _dropout(a, rate, gen)
    x = x + a

    h = copy_to_model(_layer_norm(x, lp["lnx_g"], lp["lnx_b"]))
    q = _split_heads(_dot(h, lp["xq_w"], cdt) + lp["xq_b"], heads)
    k = _split_heads(_dot(enc_out, lp["xk_w"], cdt), kv_heads)
    v = _split_heads(_dot(enc_out, lp["xv_w"], cdt) + lp["xv_b"], kv_heads)
    a = reduce_from_model(_dot(_attention(q, k, v, cdt), lp["xo_w"],
                               cdt)) + lp["xo_b"]
    if rate > 0.0:
        a = _dropout(a, rate, gen)
    x = x + a

    h = copy_to_model(_layer_norm(x, lp["ln2_g"], lp["ln2_b"]))
    h = F.gelu(_dot(h, lp["fc1_w"], cdt) + lp["fc1_b"])
    h = reduce_from_model(_dot(h, lp["fc2_w"], cdt)) + lp["fc2_b"]
    if rate > 0.0:
        h = _dropout(h, rate, gen)
    return x + h


def decoder_forward_train(params: Params, cfg: WhisperConfig,
                          enc_out: torch.Tensor, input_ids: torch.Tensor,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Teacher-forced decoder: encoder states [B, S, D] and ``input_ids``
    [B, L] -> logits [B, L, vocab] float32, causal self-attention through the
    einsum ``_attention`` (no kernel, as in the JAX package)."""
    dec = params["decoder"]
    cdt = compute_dtype(cfg)
    l = input_ids.shape[1]
    ids = input_ids.long()
    # the residual stream is float32 whatever the parameters' type
    x = (dec["tok_emb"][ids] + dec["pos_emb"][:l][None]).float()
    causal = torch.ones((l, l), dtype=torch.bool,
                        device=ids.device).tril()[None, None]
    rate = cfg.dropout if train else 0.0
    n = cfg.decoder_layers
    seeds = _layer_seeds(generator, n) if rate > 0.0 else [None] * n
    enc_out = copy_to_model(enc_out)  # the input of every layer's xk / xv
    for lp, seed in zip(_layers(dec["layers"], n), seeds):
        x = _run(_decoder_layer, cfg.remat, x, lp, enc_out, causal, cfg, rate,
                 seed)
    x = _layer_norm(x, dec["ln_post_g"], dec["ln_post_b"])
    return _dot(x, dec["tok_emb"].T, cdt)


def cross_entropy_loss(logits, labels, ignore_id: int = -100,
                       timestamp_weight: float = 1.0,
                       timestamp_sigma: float = 0.0, allreduce=None):
    """Mean token cross-entropy over the targets that are not ``ignore_id``.
    ``timestamp_weight`` weighs timestamp targets against the others;
    ``timestamp_sigma`` > 0 replaces a timestamp's one-hot target with a
    discrete Gaussian over neighbouring columns (stddev in columns,
    truncated at 3 sigma, renormalized; neighbours past either end clip onto
    the edge column). ``allreduce`` (a sum over the ranks that share a
    global batch) divides by the global batch's token weight, so the ranks'
    losses add up to the global batch's loss."""
    labels = labels.long()
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    first, last = tok.TIMESTAMP_BASE, tok.TIMESTAMP_BASE + tok.NUM_TIMESTAMPS - 1
    is_ts = (safe >= first) & (safe <= last)
    if timestamp_sigma and timestamp_sigma > 0:
        k_max = max(1, int(math.ceil(3.0 * timestamp_sigma)))
        offs = np.arange(-k_max, k_max + 1)
        w = np.exp(-0.5 * (offs / timestamp_sigma) ** 2)
        w = (w / w.sum()).astype(np.float32)
        soft = torch.zeros_like(nll)
        for k, wk in zip(offs, w):
            idx = torch.clamp(safe + int(k), first, last)
            soft = soft - float(wk) * logp.gather(-1, idx[..., None])[..., 0]
        nll = torch.where(is_ts, soft, nll)
    one = torch.ones((), device=nll.device)
    token_w = torch.where(is_ts, one * timestamp_weight, one)
    token_w = torch.where(mask, token_w, torch.zeros((), device=nll.device))
    total = token_w.sum()
    if allreduce is not None:
        total = allreduce(total.detach())
    return (nll * token_w).sum() / torch.clamp_min(total, 1e-6)
