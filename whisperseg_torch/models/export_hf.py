"""Exporter: the port's checkpoints -> the HuggingFace Whisper layout (the
port of ``whisperseg_tpu/models/export_hf.py``).

The reverse of convert_hf.py: a parameter tree and its config become a
standard HF checkpoint directory that
``transformers.WhisperForConditionalGeneration.from_pretrained`` loads and
runs, and that :func:`convert_hf.import_hf_checkpoint` reads back as it was.
The files equal the JAX package's export of the same parameters: the same
tensors under the same names, the same ``config.json`` and tokenizer files.

Vocabulary: the compact 1024-token table (tokenizer.py) is written as a
self-contained HF tokenizer: digits, ``<|pad|>`` and ``<|endoftext|>`` in
``vocab.json``, everything else as added special tokens with explicit ids,
so HF ids equal ours and the embedding matrix needs no reordering. The
extended pieces of an imported fine-tune ('12', ...) go into ``vocab.json``
and ``merges.txt`` such that GPT2-style BPE reproduces the recorded
``cluster_encodings``.

Grouped-query attention is exported as the identical multi-head attention
(each K/V head repeated group-size times), since HF Whisper has none; the
frame head rides along as ``frame_head.*`` tensors, which HF ignores.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tokenizer as tok
from .config import WhisperConfig
from .convert_hf import bpe_encode_digits


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _expand_kv(mat: np.ndarray, kv_heads: int, num_heads: int,
               head_dim: int) -> np.ndarray:
    """Repeat each K/V head ``num_heads // kv_heads`` times: GQA -> MHA with
    the same attention output."""
    if kv_heads == num_heads:
        return mat
    group = num_heads // kv_heads
    if mat.ndim == 1:  # bias [kv*hd]
        return mat.reshape(kv_heads, 1, head_dim).repeat(group, 1).reshape(-1)
    d = mat.shape[0]  # weight [d, kv*hd]
    return (mat.reshape(d, kv_heads, 1, head_dim)
            .repeat(group, 2).reshape(d, num_heads * head_dim))


_SELF_ATTN = [
    ("ln1_g", "self_attn_layer_norm.weight", False, False),
    ("ln1_b", "self_attn_layer_norm.bias", False, False),
    ("q_w", "self_attn.q_proj.weight", True, False),
    ("q_b", "self_attn.q_proj.bias", False, False),
    ("k_w", "self_attn.k_proj.weight", True, True),
    ("v_w", "self_attn.v_proj.weight", True, True),
    ("v_b", "self_attn.v_proj.bias", False, True),
    ("o_w", "self_attn.out_proj.weight", True, False),
    ("o_b", "self_attn.out_proj.bias", False, False),
    ("ln2_g", "final_layer_norm.weight", False, False),
    ("ln2_b", "final_layer_norm.bias", False, False),
    ("fc1_w", "fc1.weight", True, False),
    ("fc1_b", "fc1.bias", False, False),
    ("fc2_w", "fc2.weight", True, False),
    ("fc2_b", "fc2.bias", False, False),
]
_CROSS_ATTN = [
    ("lnx_g", "encoder_attn_layer_norm.weight", False, False),
    ("lnx_b", "encoder_attn_layer_norm.bias", False, False),
    ("xq_w", "encoder_attn.q_proj.weight", True, False),
    ("xq_b", "encoder_attn.q_proj.bias", False, False),
    ("xk_w", "encoder_attn.k_proj.weight", True, True),
    ("xv_w", "encoder_attn.v_proj.weight", True, True),
    ("xv_b", "encoder_attn.v_proj.bias", False, True),
    ("xo_w", "encoder_attn.out_proj.weight", True, False),
    ("xo_b", "encoder_attn.out_proj.bias", False, False),
]


def state_dict_from_params(params, cfg: WhisperConfig) -> Dict[str, np.ndarray]:
    """The stacked-layer tree -> a HF Whisper state dict (numpy float32):
    linear weights transposed, layers unstacked, keys prefixed ``model.``.
    The output projection is tied to the token embedding, so no ``proj_out``
    is written; HF Whisper has no k_proj bias."""
    nh, kv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    sd: Dict[str, np.ndarray] = {}

    enc = params["encoder"]
    sd["model.encoder.conv1.weight"] = _np(enc["conv1_w"]).transpose(2, 1, 0)
    sd["model.encoder.conv1.bias"] = _np(enc["conv1_b"])
    sd["model.encoder.conv2.weight"] = _np(enc["conv2_w"]).transpose(2, 1, 0)
    sd["model.encoder.conv2.bias"] = _np(enc["conv2_b"])
    sd["model.encoder.embed_positions.weight"] = _np(enc["pos_emb"])
    sd["model.encoder.layer_norm.weight"] = _np(enc["ln_post_g"])
    sd["model.encoder.layer_norm.bias"] = _np(enc["ln_post_b"])

    def unstack(prefix: str, layers, names: List[Tuple[str, str, bool, bool]],
                n_layers: int):
        for i in range(n_layers):
            for ours, hf, transpose, expand in names:
                m = _np(layers[ours][i])
                if expand:
                    m = _expand_kv(m, kv, nh, hd)
                if transpose:
                    m = m.T
                sd[f"{prefix}.{i}.{hf}"] = m

    unstack("model.encoder.layers", enc["layers"], _SELF_ATTN,
            cfg.encoder_layers)

    dec = params["decoder"]
    sd["model.decoder.embed_tokens.weight"] = _np(dec["tok_emb"])
    sd["model.decoder.embed_positions.weight"] = _np(dec["pos_emb"])
    sd["model.decoder.layer_norm.weight"] = _np(dec["ln_post_g"])
    sd["model.decoder.layer_norm.bias"] = _np(dec["ln_post_b"])
    unstack("model.decoder.layers", dec["layers"], _SELF_ATTN + _CROSS_ATTN,
            cfg.decoder_layers)

    if "frame_head" in params:
        for k, v in params["frame_head"].items():
            sd[f"frame_head.{k}"] = _np(v)
    return sd


def _merges_for_encodings(cluster_encodings: Dict[str, list]) -> List[str]:
    """GPT2 merge lines under which BPE over digit strings reproduces the
    recorded piece sequences: each multi-digit piece is built left to right,
    shorter pieces rank first. Encodings no merge table can give (no real
    BPE tokenizer makes them) raise ``ValueError``."""
    pieces = sorted({p for enc in cluster_encodings.values()
                     for p in enc if len(p) > 1}, key=lambda s: (len(s), s))
    merges: List[Tuple[str, str]] = []
    for piece in pieces:
        prefix = piece[0]
        for ch in piece[1:]:
            pair = (prefix, ch)
            if pair not in merges:
                merges.append(pair)
            prefix += ch
    ranks = {pair: i for i, pair in enumerate(merges)}
    for s, enc in cluster_encodings.items():
        got = bpe_encode_digits(s, ranks)
        if got != list(enc):
            raise ValueError(
                f"cannot reproduce cluster encoding {s!r}: recorded {enc}, "
                f"generated merges produce {got}")
    return [f"{a} {b}" for a, b in merges]


def _dump(obj, path: str, **kwargs) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, **kwargs)


def write_tokenizer_files(out_dir: str, cfg: Optional[WhisperConfig] = None):
    """A self-contained HF Whisper tokenizer for the compact vocabulary and
    the checkpoint's extended pieces: vocab.json, merges.txt,
    added_tokens.json, special_tokens_map.json, tokenizer_config.json."""
    extra = list(cfg.extra_tokens) if cfg is not None else []
    encodings = dict(cfg.cluster_encodings) if cfg is not None else {}

    # the base vocab holds what BPE can produce (digits and the extended
    # digit pieces) and pad / eot, so the tokenizer's core specials resolve
    vocab = {str(d): d for d in range(10)}
    vocab["<|pad|>"] = tok.PAD_ID
    vocab["<|endoftext|>"] = tok.EOT_ID
    for i, piece in enumerate(extra):
        vocab[piece] = tok.VOCAB_SIZE + i
    added = {t: i for i, t in enumerate(tok.ID_TO_TOKEN) if t not in vocab}
    merges = _merges_for_encodings(encodings)

    _dump(vocab, os.path.join(out_dir, "vocab.json"), indent=0, sort_keys=True)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        for line in merges:
            f.write(line + "\n")
    _dump(added, os.path.join(out_dir, "added_tokens.json"), indent=0,
          sort_keys=True)
    specials = {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                "pad_token": "<|pad|>", "unk_token": "<|endoftext|>"}
    _dump(specials, os.path.join(out_dir, "special_tokens_map.json"), indent=2)
    _dump({"tokenizer_class": "WhisperTokenizer", "model_max_length": 1024,
           **specials, "add_prefix_space": False},
          os.path.join(out_dir, "tokenizer_config.json"), indent=2)


def hf_config_dict(cfg: WhisperConfig) -> dict:
    """HF WhisperConfig JSON, plus the WhisperSeg metadata kept in the
    config object and what a lossless round trip needs."""
    return {
        "model_type": "whisper",
        "architectures": ["WhisperForConditionalGeneration"],
        "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.d_ff,
        "decoder_ffn_dim": cfg.d_ff,
        "num_mel_bins": cfg.num_mel_bins,
        "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
        "vocab_size": cfg.vocab_size,
        "activation_function": "gelu",
        "is_encoder_decoder": True,
        "tie_word_embeddings": True,
        "decoder_start_token_id": tok.SOT_ID,
        "bos_token_id": tok.EOT_ID,
        "eos_token_id": tok.EOT_ID,
        "pad_token_id": tok.PAD_ID,
        "suppress_tokens": [],
        "begin_suppress_tokens": [],
        "forced_decoder_ids": None,
        "use_cache": True,
        "torch_dtype": "float32",
        # WhisperSeg metadata
        "total_spec_columns": cfg.total_spec_columns,
        "cluster_codebook": dict(cfg.cluster_codebook),
        "species_codebook": {name: f"<|{name}|>" for name in tok.SPECIES_LIST},
        "default_segmentation_config": dict(cfg.default_segmentation_config),
        "current_step": cfg.current_step,
        # for the round trip (ignored by HF)
        "extra_tokens": list(cfg.extra_tokens),
        "cluster_encodings": {k: list(v)
                              for k, v in cfg.cluster_encodings.items()},
        "frame_head": bool(cfg.frame_head),
        "frame_head_clusters": int(cfg.frame_head_clusters),
        "whisperseg_gqa_kv_heads": int(cfg.kv_heads),
        "whisperseg_compute_dtype": cfg.compute_dtype,
        "whisperseg_model_name": cfg.model_name,
    }


def export_hf_checkpoint(params, cfg: WhisperConfig, out_dir: str) -> str:
    """Write ``out_dir`` as a self-contained HF Whisper checkpoint directory
    (weights, config, tokenizer): ``model.safetensors``, or
    ``pytorch_model.bin`` where safetensors is absent. Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    # the serializers write raw buffers: transposed views made contiguous
    sd = {k: np.ascontiguousarray(v)
          for k, v in state_dict_from_params(params, cfg).items()}
    try:
        from safetensors.numpy import save_file
    except ImportError:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(out_dir, "pytorch_model.bin"))
    else:
        save_file(sd, os.path.join(out_dir, "model.safetensors"))
    _dump(hf_config_dict(cfg), os.path.join(out_dir, "config.json"), indent=2)
    write_tokenizer_files(out_dir, cfg)
    return out_dir
