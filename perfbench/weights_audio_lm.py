"""The weights of an ``audio_lm`` configuration (a Whisper encoder feeding a
DeepSeek-V3-kind LM through a linear projector), drawn on the device from
the seed, and the program's config for it. Keys as the program's checkpoint
file keys them (``encoder.*`` as ``weights.layout``'s, ``lm.*`` as
``whisperseg_torch/models/audio_lm.py`` lays them out); the reference reads
the flat dict, ``weights.tree`` nests it for the program."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import weights as wt
from .reference.model import sinusoids

# the LM's published keys that the program's config carries
LM_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
           "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
           "qk_rope_head_dim", "v_head_dim", "intermediate_size",
           "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
           "num_experts_per_tok", "first_k_dense_replace",
           "routed_scaling_factor", "norm_topk_prob", "scoring_func",
           "topk_method", "n_group", "topk_group", "rope_theta",
           "rms_norm_eps", "vocab_size", "hidden_act", "tie_word_embeddings",
           "moe_layer_freq", "attention_bias")


def lm_dict(model: dict) -> dict:
    return {k: model[k] for k in LM_KEYS}


def layout(model: dict) -> List[wt.Leaf]:
    """Every leaf with how it is drawn: N(0, 1/fan_in) products, N(0, 0.02)
    biases, embeddings and correction bias, gains 1 + N(0, 0.02)."""
    encoder = [leaf for leaf in wt.layout(dict(
        model, decoder_layers=0, decoder_ffn_dim=1, vocab_size=1,
        max_target_positions=1)) if leaf[0].startswith("encoder.")]
    d, v = model["hidden_size"], model["vocab_size"]
    n, h = model["num_hidden_layers"], model["num_attention_heads"]
    r, dr = model["kv_lora_rank"], model["qk_rope_head_dim"]
    dn, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    nd = model["first_k_dense_replace"]
    nm, e = n - nd, model["n_routed_experts"]
    big, ff = model["intermediate_size"], model["moe_intermediate_size"]
    fs = ff * model["n_shared_experts"]
    a, small = model["d_model"], 0.02

    def w(key, shape, fan):
        return (key, shape, "normal", 1 / math.sqrt(fan))

    return encoder + [
        w("lm.proj_w", (a, d), a),
        ("lm.proj_b", (d,), "normal", small),
        ("lm.tok_emb", (v, d), "normal", small),
        w("lm.head_w", (d, v), d),
        ("lm.norm_g", (d,), "gain", small),
        ("lm.layers.attn_norm_g", (n, d), "gain", small),
        w("lm.layers.q_w", (n, d, h * (dn + dr)), d),
        w("lm.layers.kva_w", (n, d, r + dr), d),
        ("lm.layers.kv_norm_g", (n, r), "gain", small),
        w("lm.layers.kvb_w", (n, r, h * (dn + dv)), r),
        w("lm.layers.o_w", (n, h * dv, d), h * dv),
        ("lm.layers.mlp_norm_g", (n, d), "gain", small),
        w("lm.dense.gate_w", (nd, d, big), d),
        w("lm.dense.up_w", (nd, d, big), d),
        w("lm.dense.down_w", (nd, big, d), big),
        w("lm.moe.router_w", (nm, d, e), d),
        ("lm.moe.router_b", (nm, e), "normal", small),
        w("lm.moe.gate_w", (nm, e, d, ff), d),
        w("lm.moe.up_w", (nm, e, d, ff), d),
        w("lm.moe.down_w", (nm, e, ff, d), ff),
        w("lm.moe.shared_gate_w", (nm, d, fs), d),
        w("lm.moe.shared_up_w", (nm, d, fs), d),
        w("lm.moe.shared_down_w", (nm, fs, d), fs),
    ]


def random_weights(model: dict, seed: int, device, dtype
                   ) -> Dict[str, torch.Tensor]:
    """The model drawn from ``seed`` on ``device`` in ``dtype``, leaf by
    leaf from one generator, each scaled in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for key, shape, kind, scale in layout(model):
        if kind == "sinusoid":
            out[key] = sinusoids(*shape).to(device=device, dtype=dtype)
            continue
        leaf = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        leaf.mul_(scale)
        if kind == "gain":
            leaf.add_(1.0)
        out[key] = leaf
    return out


def reference_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same weights for the reference: the encoder's in float32, the
    LM's as served (the reference widens each where it is used)."""
    served = torch.bfloat16 if model["inference_dtype"] == "bfloat16" \
        else torch.float32
    flat = random_weights(model, seed, device, served)
    return {k: v.float() if k.startswith("encoder.") else v
            for k, v in flat.items()}


def program_config(model: dict):
    """The program's ``audio_lm`` config for a configuration file."""
    from whisperseg_torch.models.audio_lm import make_config
    from whisperseg_torch.models.config import WhisperConfig

    encoder = WhisperConfig(
        d_model=model["d_model"], encoder_layers=model["encoder_layers"],
        decoder_layers=0, num_heads=model["encoder_attention_heads"],
        d_ff=model["encoder_ffn_dim"], num_mel_bins=model["num_mel_bins"],
        vocab_size=model["vocab_size"],
        max_source_positions=model["max_source_positions"],
        total_spec_columns=model["total_spec_columns"],
        compute_dtype=model["compute_dtype"], dropout=0.0,
        model_name=model["name"])
    return make_config(lm_dict(model), encoder)
