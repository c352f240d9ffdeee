"""The ``audio_lm`` decoder family: a decoder-only language model of the
DeepSeek-V3 kind (multi-head latent attention, sigmoid-routed experts with
shared experts) that reads the Whisper encoder's states as its first
positions, the audio-tower pattern of audio LMs.

The sequence of one window: the encoder's S states through a linear
projector (encoder width -> the LM's hidden size) at positions 0..S-1, the
prompt ids (tokenizer.PROMPT_IDS) embedded by the LM's table after them, and
then the generated tokens, from position S + len(PROMPT_IDS) on. The LM
emits the same ``<|onset|>cluster<|offset|>`` triples as Whisper's decoder;
its segmentation ids are 0..1023 of its vocabulary, and the codec drops the
rest.

The equations (``LMConfig`` carries the widths under the keys of the
published ``config.json``; d the hidden size, H heads, r the latent rank,
dn / dr / dv the no-position, rotary and value head sizes):

* RMSNorm: ``x * rsqrt(mean(x^2) + eps) * g``.
* Attention: ``q = x W_q`` -> per head ``[q_nope dn | q_pe dr]``;
  ``[c r | k_pe dr] = x W_kva``, ``c = RMSNorm(c)``, ``k_pe = RoPE(k_pe)``
  shared by the heads; ``[k_nope dn | v dv] = c W_kvb`` per head; causal
  softmax at scale (dn + dr)^-0.5, then ``W_o``. RoPE at ``rope_theta`` on
  the dr channels, whose rotary pairs are interleaved (channels 2i, 2i+1):
  as DeepSeek-V3's modelling code, the channels are first reordered to
  [even | odd] and then rotated by halves. The cache holds ``(c, k_pe)``,
  r + dr values a token a layer.
* Decode runs the absorbed form: ``q_nope W_UK`` (W_kvb's key columns) is
  scored against the cached ``c`` directly and the weighted sum of ``c``
  goes out through ``W_UV`` (its value columns). It is the same sum taken
  in another order, so it equals the prefill's form up to rounding.
* Blocks: ``h = x + Attn(RMSNorm(x))``, then ``h + MLP(RMSNorm(h))``. The
  first ``first_k_dense_replace`` layers' MLP is a dense SwiGLU
  ``down(silu(x gate) * (x up))``; the others route: ``s = sigmoid(x W_g)``
  in float32, the top ``num_experts_per_tok`` of ``s + b`` (b the
  correction bias), weights ``s_i / (sum s_i + 1e-20) * routed_scaling_factor``
  (``norm_topk_prob``), output ``sum_i w_i expert_i(x)`` plus a shared SwiGLU
  of width ``n_shared_experts * moe_intermediate_size``.
* A final RMSNorm and the untied head.

Numerics follow models/whisper.py: products take their operands in
``cfg.compute_dtype`` with float32 sums (``dot_f32``), the residual stream,
norms, the router and the softmax run in float32, scores come back in the
compute type. The routed experts are ops/moe.py's product.

Layout of ``params["lm"]`` (stacked over layers, ``x @ w``): ``proj_w``
[A, d], ``proj_b``, ``tok_emb`` [V, d], ``head_w`` [d, V], ``norm_g``;
``layers`` (all layers): ``attn_norm_g``, ``q_w`` [d, H(dn+dr)], ``kva_w``
[d, r+dr], ``kv_norm_g`` [r], ``kvb_w`` [r, H(dn+dv)], ``o_w`` [H dv, d],
``mlp_norm_g``; ``dense`` (the first layers): ``gate_w``, ``up_w`` [d, I],
``down_w`` [I, d]; ``moe`` (the rest): ``router_w`` [d, E], ``router_b``
[E], ``gate_w``, ``up_w`` [E, d, F], ``down_w`` [E, F, d],
``shared_gate_w``, ``shared_up_w`` [d, Fs], ``shared_down_w`` [Fs, d].
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tokenizer as tok
from ..ops import moe as moe_ops
from ..ops.dot import dot_f32
from .config import AudioLMConfig, WhisperConfig
from .whisper import _dense_init, compute_dtype, init_encoder

# the settings this family implements, by their published keys
_SUPPORTED = {"scoring_func": "sigmoid", "topk_method": "noaux_tc",
              "n_group": 1, "topk_group": 1, "q_lora_rank": None,
              "hidden_act": "silu", "tie_word_embeddings": False,
              "moe_layer_freq": 1, "attention_bias": False}


@dataclass(frozen=True)
class LMConfig:
    """The LM's widths, under its published ``config.json``'s keys, and the
    projector's input width (the encoder's)."""
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    rope_theta: float
    rms_norm_eps: float
    vocab_size: int
    audio_hidden_size: int

    @classmethod
    def from_dict(cls, d: dict) -> "LMConfig":
        for key, want in _SUPPORTED.items():
            if key in d and d[key] != want:
                raise ValueError(f"audio_lm: {key}={d[key]!r} is not "
                                 f"supported (only {want!r})")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def latent(self) -> int:
        """Cached values a token a layer: the latent and the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


def lm_config(cfg: WhisperConfig) -> LMConfig:
    if cfg.decoder_family != "audio_lm":
        raise ValueError(f"not an audio_lm config: {cfg.decoder_family!r}")
    return LMConfig.from_dict(cfg.lm)


def make_config(lm: dict, encoder: WhisperConfig) -> AudioLMConfig:
    """An ``audio_lm`` config: ``encoder``'s encoder fields with the LM of
    ``lm`` (published keys) behind it."""
    lmc = LMConfig.from_dict(dict(lm, audio_hidden_size=encoder.d_model))
    fields = {f.name: getattr(encoder, f.name)
              for f in dataclasses.fields(WhisperConfig)}
    fields.update(vocab_size=lmc.vocab_size,
                  decoder_layers=lmc.num_hidden_layers)
    return AudioLMConfig(**fields, lm=dataclasses.asdict(lmc))


def prompt_length() -> int:
    return len(tok.PROMPT_IDS)


# ---------------------------------------------------------------------- init


def init_lm(gen: torch.Generator, c: LMConfig) -> dict:
    """Fresh float32 LM parameters on the CPU: N(0, 1/fan_in) products,
    N(0, 0.02) embeddings, unit gains, zero biases."""
    d, h, n = c.hidden_size, c.num_attention_heads, c.num_hidden_layers
    r, dn, dr, dv = (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
                     c.v_head_dim)
    nd, nm, e = c.first_k_dense_replace, c.moe_layers, c.n_routed_experts
    ff, fs = c.moe_intermediate_size, c.moe_intermediate_size * c.n_shared_experts

    def stack(count, shape, fan=None):
        return _dense_init(gen, (count, *shape),
                           1.0 / math.sqrt(fan or shape[0]))

    return {
        "proj_w": _dense_init(gen, (c.audio_hidden_size, d)),
        "proj_b": torch.zeros(d),
        "tok_emb": _dense_init(gen, (c.vocab_size, d), scale=0.02),
        "head_w": _dense_init(gen, (d, c.vocab_size)),
        "norm_g": torch.ones(d),
        "layers": {
            "attn_norm_g": torch.ones(n, d),
            "q_w": stack(n, (d, h * (dn + dr))),
            "kva_w": stack(n, (d, r + dr)),
            "kv_norm_g": torch.ones(n, r),
            "kvb_w": stack(n, (r, h * (dn + dv))),
            "o_w": stack(n, (h * dv, d)),
            "mlp_norm_g": torch.ones(n, d),
        },
        "dense": {
            "gate_w": stack(nd, (d, c.intermediate_size)),
            "up_w": stack(nd, (d, c.intermediate_size)),
            "down_w": stack(nd, (c.intermediate_size, d)),
        },
        "moe": {
            "router_w": stack(nm, (d, e)),
            "router_b": torch.zeros(nm, e),
            "gate_w": stack(nm, (e, d, ff), fan=d),
            "up_w": stack(nm, (e, d, ff), fan=d),
            "down_w": stack(nm, (e, ff, d), fan=ff),
            "shared_gate_w": stack(nm, (d, fs)),
            "shared_up_w": stack(nm, (d, fs)),
            "shared_down_w": stack(nm, (fs, d)),
        },
    }


def init_params(gen: torch.Generator, cfg: WhisperConfig) -> dict:
    """Fresh float32 parameters of an ``audio_lm`` model: the encoder, then
    the LM, drawn from ``gen``."""
    return {"encoder": init_encoder(gen, cfg), "lm": init_lm(gen, lm_config(cfg))}


def expected_shapes(cfg: WhisperConfig) -> dict:
    """A few leaves' shapes, which a loaded tree must have."""
    c = lm_config(cfg)
    h = c.num_attention_heads
    return {
        "lm.tok_emb": (c.vocab_size, c.hidden_size),
        "lm.proj_w": (c.audio_hidden_size, c.hidden_size),
        "lm.layers.q_w": (c.num_hidden_layers, c.hidden_size,
                          h * (c.qk_nope_head_dim + c.qk_rope_head_dim)),
        "lm.moe.gate_w": (c.moe_layers, c.n_routed_experts, c.hidden_size,
                          c.moe_intermediate_size),
    }


# ---------------------------------------------------------------- primitives


def rms_norm(x, g, eps: float):
    x32 = x.float()
    return x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos and sin [N, dim] float32 of positions [N] (a tensor, possibly on
    the device): the angles of the dim / 2 rotary pairs, twice."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., dim] float32 with interleaved rotary pairs, cos / sin
    broadcastable to it: the pairs reordered to [even | odd] channels, then
    rotated by halves (DeepSeek-V3's ``apply_rotary_pos_emb``)."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def _swiglu(x, gate_w, up_w, down_w, cdt):
    act = F.silu(dot_f32(x, gate_w, cdt)) * dot_f32(x, up_w, cdt)
    return dot_f32(act, down_w, cdt)


def route(x: torch.Tensor, router_w, router_b, c: LMConfig):
    """x [T, d] -> (experts [T, k], weights [T, k] float32): sigmoid scores
    in float32, the top k of scores plus the correction bias, weights from
    the scores alone."""
    s = torch.sigmoid(x.float() @ router_w.float())
    idx = torch.topk(s + router_b.float(), c.num_experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, idx)
    if c.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c.routed_scaling_factor


def _moe(x, mp: dict, c: LMConfig, cdt, load: Optional[torch.Tensor]):
    """The routed experts and the shared ones over x [T, d] float32.
    ``load`` [3] (int64, on the device) gains the routed pairs, the experts
    that got any and the busiest expert's pairs."""
    idx, w = route(x, mp["router_w"], mp["router_b"], c)
    counts = moe_ops.expert_counts(idx, c.n_routed_experts)
    if load is not None:
        load.add_(torch.stack([counts.sum(), (counts > 0).sum(),
                               counts.max()]))
    y = moe_ops.expert_mlp(x.to(cdt), idx, mp["gate_w"], mp["up_w"],
                           mp["down_w"], counts)
    return (y * w[..., None]).sum(1) + _swiglu(
        x, mp["shared_gate_w"], mp["shared_up_w"], mp["shared_down_w"], cdt)


def _mlp(x, lm: dict, i: int, c: LMConfig, cdt, load):
    """Layer i's MLP over x [..., d] float32."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    if i < c.first_k_dense_replace:
        dp = {k: v[i] for k, v in lm["dense"].items()}
        y = _swiglu(x, dp["gate_w"], dp["up_w"], dp["down_w"], cdt)
    else:
        mp = {k: v[i - c.first_k_dense_replace] for k, v in lm["moe"].items()}
        y = _moe(x, mp, c, cdt, load)
    return y.reshape(shape)


def _latent(h, lp: dict, c: LMConfig, cdt, cos, sin):
    """h [..., d] -> (q_nope, q_pe rotated) per head, and the cache entry
    [c | k_pe rotated] in the compute type."""
    hq, dn, dr = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
    q = dot_f32(h, lp["q_w"], cdt)
    q = q.reshape(*q.shape[:-1], hq, dn + dr)
    kva = dot_f32(h, lp["kva_w"], cdt)
    lat = rms_norm(kva[..., :c.kv_lora_rank], lp["kv_norm_g"], c.rms_norm_eps)
    k_pe = apply_rope(kva[..., c.kv_lora_rank:], cos, sin)
    q_pe = apply_rope(q[..., dn:], cos.unsqueeze(-2), sin.unsqueeze(-2))
    return q[..., :dn], q_pe, torch.cat([lat, k_pe], dim=-1).to(cdt)


def _neg(cdt, device) -> torch.Tensor:
    return torch.full((), -1e30, dtype=cdt, device=device)


# ------------------------------------------------------------------- prefill


def _attend_prefill(h, lp, c: LMConfig, cdt, cos, sin):
    """Causal attention over a whole sequence h [B, P, d] in the plain form:
    (output [B, P, d] float32, cache entries [B, P, r + dr])."""
    b, p, _ = h.shape
    hq, dn, dv = c.num_attention_heads, c.qk_nope_head_dim, c.v_head_dim
    q_nope, q_pe, entry = _latent(h, lp, c, cdt, cos, sin)
    kv = dot_f32(entry[..., :c.kv_lora_rank], lp["kvb_w"], cdt)
    kv = kv.reshape(b, p, hq, dn + dv)
    k = torch.cat([kv[..., :dn], entry[..., None, c.kv_lora_rank:].expand(
        b, p, hq, c.qk_rope_head_dim).float()], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    scale = (dn + c.qk_rope_head_dim) ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(cdt), k.to(cdt))
    causal = torch.ones(p, p, dtype=torch.bool, device=h.device).tril()
    scores = torch.where(causal, scores, _neg(cdt, h.device))
    probs = torch.softmax(scores.float(), dim=-1).to(cdt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., dn:].to(cdt))
    return dot_f32(out.reshape(b, p, hq * dv).float(), lp["o_w"], cdt), entry


def embed_prefix(params: dict, cfg: WhisperConfig, enc_out: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """The LM's input rows of a window: enc_out [B, S, A] projected, then
    ids [B, L] embedded -> [B, S + L, d] float32."""
    lm = params["lm"]
    cdt = compute_dtype(cfg)
    audio = dot_f32(enc_out, lm["proj_w"], cdt) + lm["proj_b"].float()
    return torch.cat([audio, lm["tok_emb"][ids].float()], dim=1)


def prefill(params: dict, cfg: WhisperConfig, enc_out: torch.Tensor,
            out: Optional[torch.Tensor] = None,
            load: Optional[torch.Tensor] = None,
            all_logits: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefix of each window (the projected encoder states, then the
    prompt) through the LM: (logits [B, V] float32 at its last position, or
    [B, P, V] at every position with ``all_logits``; the prefix cache [L, B,
    P, r + dr] in the compute type, written into ``out`` where given).
    ``load`` [3] gains the expert load (see :func:`_moe`)."""
    c = lm_config(cfg)
    lm = params["lm"]
    cdt = compute_dtype(cfg)
    b = enc_out.shape[0]
    ids = torch.tensor(tok.PROMPT_IDS, device=enc_out.device).expand(b, -1)
    x = embed_prefix(params, cfg, enc_out, ids)
    p = x.shape[1]
    if out is None:
        out = torch.empty((c.num_hidden_layers, b, p, c.latent), dtype=cdt,
                          device=x.device)
    cos, sin = rope_tables(torch.arange(p, device=x.device),
                           c.qk_rope_head_dim, c.rope_theta)
    for i in range(c.num_hidden_layers):
        lp = {k: v[i] for k, v in lm["layers"].items()}
        a, entry = _attend_prefill(
            rms_norm(x, lp["attn_norm_g"], c.rms_norm_eps), lp, c, cdt,
            cos, sin)
        out[i].copy_(entry)
        x = x + a
        x = x + _mlp(rms_norm(x, lp["mlp_norm_g"], c.rms_norm_eps), lm, i, c,
                     cdt, load)
    if not all_logits:
        x = x[:, -1]
    x = rms_norm(x, lm["norm_g"], c.rms_norm_eps)
    return dot_f32(x, lm["head_w"], cdt), out


# -------------------------------------------------------------------- decode


def init_cache(cfg: WhisperConfig, rows: int, length: int, device
               ) -> torch.Tensor:
    """The generated tokens' cache [L, rows, length, r + dr], zeroed."""
    c = lm_config(cfg)
    return torch.zeros((c.num_hidden_layers, rows, length, c.latent),
                       dtype=compute_dtype(cfg), device=device)


def _attend_step(h, lp, c: LMConfig, cdt, cos, sin, prefix, cache, slot,
                 neg):
    """One token a row, h [R, d], in the absorbed form, over the window's
    prefix cache [B, P, r + dr] (shared by the R / B rows of each window)
    and the row's own cache [R, G, r + dr], whose entries up to ``slot``
    (this token's, written here) count. Returns [R, d] float32."""
    r_rows = h.shape[0]
    b, p, _ = prefix.shape
    hq, dn, dv = c.num_attention_heads, c.qk_nope_head_dim, c.v_head_dim
    rank = c.kv_lora_rank
    q_nope, q_pe, entry = _latent(h, lp, c, cdt, cos, sin)
    cache.index_copy_(1, slot.reshape(1), entry[:, None])
    wkv = lp["kvb_w"].reshape(rank, hq, dn + dv)
    q_lat = torch.einsum("rhd,chd->rhc", q_nope.to(cdt),
                         wkv[..., :dn].to(cdt)).float()
    scale = (dn + c.qk_rope_head_dim) ** -0.5
    q = (torch.cat([q_lat, q_pe], dim=-1) * scale).to(cdt)      # [R, H, C]
    s_pre = torch.einsum("bkhc,bpc->bkhp", q.reshape(b, -1, hq, q.shape[-1]),
                         prefix).reshape(r_rows, hq, p)
    s_gen = torch.einsum("rhc,rgc->rhg", q, cache)
    keys = torch.arange(cache.shape[1], device=h.device)
    s_gen = torch.where(keys <= slot, s_gen, neg)
    probs = torch.softmax(torch.cat([s_pre, s_gen], dim=-1).float(),
                          dim=-1).to(cdt)
    o_pre = torch.einsum("bkhp,bpc->bkhc", probs[..., :p].reshape(b, -1, hq, p),
                         prefix[..., :rank]).reshape(r_rows, hq, rank)
    o_gen = torch.einsum("rhg,rgc->rhc", probs[..., p:], cache[..., :rank])
    o_lat = (o_pre.float() + o_gen.float()).to(cdt)
    out = torch.einsum("rhc,chd->rhd", o_lat, wkv[..., dn:].to(cdt)).float()
    return dot_f32(out.reshape(r_rows, hq * dv), lp["o_w"], cdt)


def step(params: dict, cfg: WhisperConfig, prefix: torch.Tensor,
         cache: torch.Tensor, ids: torch.Tensor, slot: torch.Tensor,
         load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One generated token a row: ids [R] at generated slot ``slot`` (a
    0-dim long tensor on the device; sequence position P + slot),
    R a multiple of the prefix cache's B windows [L, B, P, r + dr], rows
    window-major. Writes the rows' cache [L, R, G, r + dr] at ``slot`` and
    returns the logits [R, V] float32. No shape, launch or host read
    depends on ``slot`` or on the data, so a CUDA graph can capture it."""
    c = lm_config(cfg)
    lm = params["lm"]
    cdt = compute_dtype(cfg)
    device = ids.device
    p = prefix.shape[2]
    cos, sin = rope_tables((slot + p).reshape(1), c.qk_rope_head_dim,
                           c.rope_theta)
    neg = _neg(cdt, device)
    x = lm["tok_emb"][ids].float()
    for i in range(c.num_hidden_layers):
        lp = {k: v[i] for k, v in lm["layers"].items()}
        x = x + _attend_step(rms_norm(x, lp["attn_norm_g"], c.rms_norm_eps),
                             lp, c, cdt, cos, sin, prefix[i], cache[i], slot,
                             neg)
        x = x + _mlp(rms_norm(x, lp["mlp_norm_g"], c.rms_norm_eps), lm, i, c,
                     cdt, load)
    x = rms_norm(x, lm["norm_g"], c.rms_norm_eps)
    return dot_f32(x, lm["head_w"], cdt)
