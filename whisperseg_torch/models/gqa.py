"""MHA -> grouped-query attention checkpoint conversion (the port of
``whisperseg_tpu/models/gqa.py``).

GQA divides the decode step's largest stream, the cross-attention K/V, by
``num_heads / num_kv_heads``. Shipped Whisper weights are MHA; the grouped
K/V projections start as the mean of the heads of each group, and a short
uptraining run (``--gqa_kv_heads`` of the train CLI) recovers the rest.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import WhisperConfig


def _pool_kv(w: torch.Tensor, num_heads: int, kv_heads: int,
             head_dim: int) -> torch.Tensor:
    """Mean of each group of heads along the output dim of a K/V
    projection: [..., H*hd] -> [..., Hkv*hd]. The group's members are added
    one after another and the sum multiplied by the float32 reciprocal of
    the group size, as the JAX package's compiled mean does, so that both
    give the same bits."""
    g = num_heads // kv_heads
    parts = w.reshape(w.shape[:-1] + (kv_heads, g, head_dim)).unbind(-2)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    inv = torch.tensor(1.0, dtype=w.dtype) / torch.tensor(g, dtype=w.dtype)
    return (total * inv).reshape(w.shape[:-1] + (kv_heads * head_dim,))


def convert_to_gqa(params: dict, cfg: WhisperConfig, num_kv_heads: int):
    """(params, cfg) of an MHA model -> the same with ``num_kv_heads`` K/V
    heads: the K/V projections of the encoder (``k_w, v_w, v_b``) and of the
    decoder (those and the cross ``xk_w, xv_w, xv_b``) are mean-pooled per
    group; every other encoder and decoder leaf is the same tensor. As in the
    JAX package, the tree keeps only the encoder and the decoder (a frame
    head is left out; the trainer adds a fresh one). The result approximates
    the original model and should be uptrained."""
    if cfg.num_heads % num_kv_heads:
        raise ValueError("num_kv_heads must divide num_heads")
    if cfg.kv_heads != cfg.num_heads:
        raise ValueError("the model is already grouped")
    h, hd = cfg.num_heads, cfg.head_dim

    def convert_layers(layers, names):
        out = dict(layers)
        for name in names:
            if name in layers:
                out[name] = _pool_kv(layers[name], h, num_kv_heads, hd)
        return out

    new_params = {"encoder": dict(params["encoder"]),
                  "decoder": dict(params["decoder"])}
    new_params["encoder"]["layers"] = convert_layers(
        params["encoder"]["layers"], ["k_w", "v_w", "v_b"])
    new_params["decoder"]["layers"] = convert_layers(
        params["decoder"]["layers"],
        ["k_w", "v_w", "v_b", "xk_w", "xv_w", "xv_b"])

    new_cfg = dataclasses.replace(cfg, num_kv_heads=num_kv_heads)
    new_cfg.cluster_codebook = dict(cfg.cluster_codebook)
    new_cfg.default_segmentation_config = dict(cfg.default_segmentation_config)
    return new_params, new_cfg
