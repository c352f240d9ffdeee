"""A plain float32 reference of the ``audio_lm`` decoder family: a decoder-only
language model of the DeepSeek-V3 kind fed the encoder's states as its first
positions.

Written from DeepSeek-V3's published modelling code (the ``deepseek_v3``
model type of Moonlight-16B-A3B's ``config.json``): RMSNorm; multi-head
latent attention without a query latent (``q = x W_q`` split per head into
a no-position and a rotary part, ``[c | k_pe] = x W_kva``, ``c`` normalised,
keys and values ``c W_kvb`` per head, the rotary key shared by the heads,
rotary pairs at interleaved channels 2i and 2i + 1, scale (dn + dr)^-0.5,
causal); a dense SwiGLU MLP in the first ``first_k_dense_replace`` layers,
then sigmoid-scored experts chosen by the top ``num_experts_per_tok`` of
score plus correction bias, weighted by their normalised scores times
``routed_scaling_factor``, plus the shared experts' SwiGLU; a final RMSNorm
and an untied head. The audio-LM part: the encoder's states through a linear
projector are positions 0..S-1, the token ids follow.

One window at a time, the whole sequence at once: no cache, no batching,
float32 with TF32 off. Every product with a weight goes through
``model._lin``, so that ``model.lower_precision()`` runs it with float8
(e4m3) products, the benchmark's control. Each weight is widened to
float32 where it is used, so that a model stored in bfloat16 never exists
whole in float32. Weights are a flat dict keyed as the checkpoint file
(``params.npz``) keys them. Imports torch and this package's ``model``
alone (a copy of the repository's ``tests/plain_audio_lm.py`` with the
products so routed).
"""

from __future__ import annotations

import torch

from .model import _lin

Weights = dict


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope(x, positions, theta):
    """Rotate each interleaved pair (x[2i], x[2i+1]) of x [..., P, (H,) dr]
    by position * theta^(-2i / dr); positions [P]."""
    dr = x.shape[-1]
    freq = theta ** (-torch.arange(0, dr, 2, dtype=torch.float32,
                                   device=x.device) / dr)
    ang = positions.float()[:, None] * freq[None, :]          # [P, dr / 2]
    while ang.dim() < x.dim():
        ang = ang.unsqueeze(-2)
    even, odd = x[..., 0::2], x[..., 1::2]
    cos, sin = ang.cos(), ang.sin()
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = even * sin + odd * cos
    return out


def _w(w: Weights, key: str, *index):
    """A weight, or a layer's or an expert's slice of it, in float32."""
    t = w[key]
    for i in index:
        t = t[i]
    return t.float()


def attention(w: Weights, i: int, x, c: dict):
    """Layer i's causal latent attention over x [P, d] (its input, already
    normalised) -> [P, d]."""
    p = x.shape[0]
    h, dn, dr = (c["num_attention_heads"], c["qk_nope_head_dim"],
                 c["qk_rope_head_dim"])
    r, dv = c["kv_lora_rank"], c["v_head_dim"]
    pos = torch.arange(p, device=x.device)
    q = _lin(x, _w(w, "lm.layers.q_w", i)).reshape(p, h, dn + dr)
    kva = _lin(x, _w(w, "lm.layers.kva_w", i))
    lat = rms_norm(kva[:, :r], _w(w, "lm.layers.kv_norm_g", i),
                   c["rms_norm_eps"])
    k_pe = rope(kva[:, r:], pos, c["rope_theta"])             # [P, dr]
    kv = _lin(lat, _w(w, "lm.layers.kvb_w", i)).reshape(p, h, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, c["rope_theta"])], -1)
    k = torch.cat([kv[..., :dn], k_pe[:, None].expand(p, h, dr)], -1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
    mask = torch.ones(p, p, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), kv[..., dn:])
    return _lin(out.reshape(p, h * dv), _w(w, "lm.layers.o_w", i))


def swiglu(x, gate, up, down):
    return _lin(torch.nn.functional.silu(_lin(x, gate)) * _lin(x, up), down)


def router(w: Weights, j: int, x, c: dict):
    """Expert layer j's choice for x [T, d]: (experts [T, k], weights)."""
    s = torch.sigmoid(_lin(x, _w(w, "lm.moe.router_w", j)))
    idx = torch.topk(s + _w(w, "lm.moe.router_b", j),
                     c["num_experts_per_tok"], dim=-1).indices
    wt = s.gather(1, idx)
    if c["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return idx, wt * c["routed_scaling_factor"]


def moe(w: Weights, j: int, x, c: dict):
    """Expert layer j over x [T, d] (normalised): routed experts, expert by
    expert over the tokens that chose it, plus the shared SwiGLU."""
    idx, wt = router(w, j, x, c)
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], _w(w, "lm.moe.gate_w", j, e),
                       _w(w, "lm.moe.up_w", j, e), _w(w, "lm.moe.down_w", j, e))
            out.index_add_(0, tok, y * wt[tok, slot][:, None])
    return out + swiglu(x, _w(w, "lm.moe.shared_gate_w", j),
                        _w(w, "lm.moe.shared_up_w", j),
                        _w(w, "lm.moe.shared_down_w", j))


def mlp(w: Weights, i: int, x, c: dict):
    k = c["first_k_dense_replace"]
    if i < k:
        return swiglu(x, _w(w, "lm.dense.gate_w", i), _w(w, "lm.dense.up_w", i),
                      _w(w, "lm.dense.down_w", i))
    return moe(w, i - k, x, c)


def inputs(w: Weights, audio, ids):
    """The window's input rows: the encoder states audio [S, A] projected,
    then the ids [L] embedded -> [S + L, d]."""
    proj = _lin(audio.float(), _w(w, "lm.proj_w")) + _w(w, "lm.proj_b")
    return torch.cat([proj, w["lm.tok_emb"][ids].float()], dim=0)


@torch.no_grad()
def logits(w: Weights, c: dict, audio, ids, first: int = 0):
    """The logits [S + L - first, V] of one window's sequence (audio [S, A]
    encoder states, then ids [L]) at every position from ``first`` on."""
    x = inputs(w, audio, ids)
    eps = c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        x = x + attention(w, i, rms_norm(x, _w(w, "lm.layers.attn_norm_g", i),
                                         eps), c)
        x = x + mlp(w, i, rms_norm(x, _w(w, "lm.layers.mlp_norm_g", i), eps),
                    c)
    x = rms_norm(x[first:], _w(w, "lm.norm_g"), eps)
    return _lin(x, _w(w, "lm.head_w"))
