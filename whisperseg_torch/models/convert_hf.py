"""Importer: HuggingFace Whisper checkpoints -> the port's parameter tree (the
port of ``whisperseg_tpu/models/convert_hf.py``).

A HF ``WhisperForConditionalGeneration`` directory (``model.safetensors`` or
``pytorch_model.bin``, ``config.json`` and the tokenizer files) becomes a
tree of float32 CPU tensors and a :class:`WhisperConfig`, so a published
Whisper or WhisperSeg fine-tune can be segmented with or trained from.

Vocabulary: the port decodes over the compact 1024-token vocabulary
(tokenizer.py), so embedding rows are gathered through a ``token_map``
(our id -> HF id) that :func:`build_token_map` derives from the saved vocab
files: digits, control tokens, and the timestamp and species tokens. A
reference fine-tune's multi-digit cluster ids ('12') are single BPE tokens
there; :func:`derive_extra_tokens` gives each such piece an extended row
(ids >= ``VOCAB_SIZE``).

Rows HF does not supply keep the random initialization of
``init_params(torch.Generator().manual_seed(seed), cfg)``: the ids missing
from ``token_map`` and the rows past HF's vocabulary. That stream is torch's,
so those rows differ from the JAX package's import, which draws them from
``jax.random.PRNGKey(seed)``; every row and leaf that HF supplies is the
same, bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import tokenizer as tok
from .config import WhisperConfig
from .whisper import init_params, sinusoid_position_table


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_hf_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Read a HF checkpoint directory (safetensors or torch .bin) into numpy."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        return load_file(st_path)
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: _to_np(v) for k, v in sd.items()}
    raise FileNotFoundError(f"no model weights found under {model_dir}")


def _load_hf_vocab(tokenizer_dir: str) -> Dict[str, int]:
    """token string -> HF id from vocab.json + added_tokens.json."""
    vocab: Dict[str, int] = {}
    for name in ("vocab.json", "added_tokens.json"):
        path = os.path.join(tokenizer_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                vocab.update(json.load(f))
    if not vocab:
        raise FileNotFoundError(
            f"no vocab.json/added_tokens.json under {tokenizer_dir}")
    return vocab


def _load_merge_ranks(tokenizer_dir: str) -> Dict[tuple, int]:
    """(left, right) -> merge priority from merges.txt (lower merges first)."""
    path = os.path.join(tokenizer_dir, "merges.txt")
    ranks: Dict[tuple, int] = {}
    if not os.path.exists(path):
        return ranks
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            parts = line.split(" ")
            if len(parts) == 2:
                ranks[(parts[0], parts[1])] = i
    return ranks


def bpe_encode_digits(digits: str, merge_ranks: Dict[tuple, int]):
    """Byte-pair-encode an all-digit pretoken as a GPT2-style HF tokenizer
    does (ASCII digits are fixed points of its byte encoder, and a digit run
    is one pretoken): merge the lowest-rank adjacent pair until none is left.
    Returns the list of piece strings."""
    word = list(digits)
    while len(word) > 1:
        best_rank, best_pair = None, None
        for pair in zip(word, word[1:]):
            r = merge_ranks.get(pair)
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_pair = r, pair
        if best_pair is None:
            break
        merged = []
        i = 0
        while i < len(word):
            if i + 1 < len(word) and (word[i], word[i + 1]) == best_pair:
                merged.append(word[i] + word[i + 1])
                i += 2
            else:
                merged.append(word[i])
                i += 1
        word = merged
    return word


def derive_extra_tokens(tokenizer_dir: str, cluster_int_ids):
    """The multi-digit BPE pieces the checkpoint's own tokenizer makes of the
    given cluster ids. Returns ``(extras, encodings)``: ``extras`` maps
    piece -> HF id; ``encodings`` maps each multi-digit cluster string to its
    exact piece sequence (merge order matters: '123' may be ['1', '23'] where
    a greedy match over the piece set gives ['12', '3']), kept as
    ``cfg.cluster_encodings`` so labels encode as the checkpoint's did."""
    vocab = _load_hf_vocab(tokenizer_dir)
    ranks = _load_merge_ranks(tokenizer_dir)
    extras: Dict[str, int] = {}
    encodings: Dict[str, list] = {}
    for cid in sorted({int(c) for c in cluster_int_ids}):
        s = str(cid)
        if len(s) < 2:
            continue
        pieces = [s] if s in vocab and not ranks else bpe_encode_digits(s, ranks)
        encodings[s] = list(pieces)
        for piece in pieces:
            if len(piece) > 1 and piece in vocab and piece not in extras:
                extras[piece] = vocab[piece]
    return extras, encodings


def build_token_map(tokenizer_dir: str,
                    extra_tokens: Optional[list] = None) -> Dict[int, int]:
    """our token id -> HF token id from the vocab files saved with a HF
    checkpoint. ``extra_tokens`` (ordered multi-digit pieces) map onto the
    extended ids ``VOCAB_SIZE + i``."""
    vocab = _load_hf_vocab(tokenizer_dir)
    mapping: Dict[int, int] = {}
    for our_id, token in enumerate(tok.ID_TO_TOKEN):
        if token in vocab:
            mapping[our_id] = vocab[token]
    # our pad has no HF equivalent by name; Whisper pads with eot
    if tok.PAD_ID not in mapping and "<|endoftext|>" in vocab:
        mapping[tok.PAD_ID] = vocab["<|endoftext|>"]
    for i, piece in enumerate(extra_tokens or []):
        if piece in vocab:
            mapping[tok.VOCAB_SIZE + i] = vocab[piece]
    return mapping


def config_from_hf(hf_config, total_spec_columns: int = 1000) -> WhisperConfig:
    """A HF WhisperConfig -> ours, with ``max_source_positions`` =
    ``total_spec_columns // 2`` (the encoder table is cut or extended)."""
    return WhisperConfig(
        d_model=hf_config.d_model,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        d_ff=hf_config.encoder_ffn_dim,
        num_mel_bins=hf_config.num_mel_bins,
        max_source_positions=total_spec_columns // 2,
        max_target_positions=hf_config.max_target_positions,
        total_spec_columns=total_spec_columns,
    )


def params_from_hf_state_dict(
    sd: Dict[str, np.ndarray],
    cfg: WhisperConfig,
    token_map: Optional[Dict[int, int]] = None,
    seed: int = 0,
):
    """A HF Whisper state dict -> the port's stacked-layer tree of float32
    CPU tensors. Leaves and rows HF lacks keep ``init_params``'s draw."""
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    params = {k: _numpy_tree(v) for k, v in params.items()}

    def g(name):
        key = name if name in sd else "model." + name
        return np.asarray(sd[key]).astype(np.float32)

    enc = params["encoder"]
    enc["conv1_w"] = g("encoder.conv1.weight").transpose(2, 1, 0)
    enc["conv1_b"] = g("encoder.conv1.bias")
    enc["conv2_w"] = g("encoder.conv2.weight").transpose(2, 1, 0)
    enc["conv2_b"] = g("encoder.conv2.bias")
    # the encoder table cut (or sinusoid-extended) to max_source_positions
    pos = g("encoder.embed_positions.weight")
    if pos.shape[0] < cfg.max_source_positions:
        ext = sinusoid_position_table(cfg.max_source_positions, cfg.d_model)
        ext[: pos.shape[0]] = pos
        pos = ext
    enc["pos_emb"] = pos[: cfg.max_source_positions]
    enc["ln_post_g"] = g("encoder.layer_norm.weight")
    enc["ln_post_b"] = g("encoder.layer_norm.bias")

    def stack(fmt, n, transpose=False):
        mats = [g(fmt.format(i)) for i in range(n)]
        return np.stack([m.T for m in mats] if transpose else mats)

    self_attn = [
        ("ln1_g", "self_attn_layer_norm.weight", False),
        ("ln1_b", "self_attn_layer_norm.bias", False),
        ("q_w", "self_attn.q_proj.weight", True),
        ("q_b", "self_attn.q_proj.bias", False),
        ("k_w", "self_attn.k_proj.weight", True),
        ("v_w", "self_attn.v_proj.weight", True),
        ("v_b", "self_attn.v_proj.bias", False),
        ("o_w", "self_attn.out_proj.weight", True),
        ("o_b", "self_attn.out_proj.bias", False),
        ("ln2_g", "final_layer_norm.weight", False),
        ("ln2_b", "final_layer_norm.bias", False),
        ("fc1_w", "fc1.weight", True),
        ("fc1_b", "fc1.bias", False),
        ("fc2_w", "fc2.weight", True),
        ("fc2_b", "fc2.bias", False),
    ]
    cross_attn = [
        ("lnx_g", "encoder_attn_layer_norm.weight", False),
        ("lnx_b", "encoder_attn_layer_norm.bias", False),
        ("xq_w", "encoder_attn.q_proj.weight", True),
        ("xq_b", "encoder_attn.q_proj.bias", False),
        ("xk_w", "encoder_attn.k_proj.weight", True),
        ("xv_w", "encoder_attn.v_proj.weight", True),
        ("xv_b", "encoder_attn.v_proj.bias", False),
        ("xo_w", "encoder_attn.out_proj.weight", True),
        ("xo_b", "encoder_attn.out_proj.bias", False),
    ]
    for ours, hf, transpose in self_attn:
        enc["layers"][ours] = stack("encoder.layers.{}." + hf,
                                    cfg.encoder_layers, transpose)

    dec = params["decoder"]
    emb = g("decoder.embed_tokens.weight")
    if token_map is not None:
        new_emb = dec["tok_emb"].copy()
        for our_id, hf_id in token_map.items():
            if hf_id < emb.shape[0]:
                new_emb[our_id] = emb[hf_id]
        dec["tok_emb"] = new_emb
    elif emb.shape[0] < cfg.vocab_size:
        new_emb = dec["tok_emb"].copy()
        new_emb[: emb.shape[0]] = emb
        dec["tok_emb"] = new_emb
    else:
        dec["tok_emb"] = emb[: cfg.vocab_size]
    dec["pos_emb"] = g("decoder.embed_positions.weight")[
        : cfg.max_target_positions]
    dec["ln_post_g"] = g("decoder.layer_norm.weight")
    dec["ln_post_b"] = g("decoder.layer_norm.bias")
    for ours, hf, transpose in self_attn + cross_attn:
        dec["layers"][ours] = stack("decoder.layers.{}." + hf,
                                    cfg.decoder_layers, transpose)
    return _tensor_tree(params)


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return node.numpy()


def _tensor_tree(node):
    if isinstance(node, dict):
        return {k: _tensor_tree(v) for k, v in node.items()}
    return torch.from_numpy(np.ascontiguousarray(node, dtype=np.float32))


def import_hf_checkpoint(model_dir: str,
                         total_spec_columns: Optional[int] = 1000):
    """A HF Whisper checkpoint directory -> (params, config).

    Besides the weights this reads the segmentation metadata a WhisperSeg
    checkpoint keeps in its HF config (``cluster_codebook``,
    ``default_segmentation_config``, ``total_spec_columns``,
    ``current_step``), so an imported fine-tune segments as it is. A
    checkpoint written by export_hf.py carries its extended-token layout and
    its frame head (``frame_head.*`` tensors, which transformers ignores),
    and comes back as it was exported."""
    from transformers import WhisperConfig as HFConfig

    hf_cfg = HFConfig.from_pretrained(model_dir)
    raw = {}
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
    if total_spec_columns is None:
        total_spec_columns = int(raw.get("total_spec_columns", 1000))
    cfg = config_from_hf(hf_cfg, total_spec_columns)
    cfg.cluster_codebook = dict(raw.get("cluster_codebook", {}) or {})
    cfg.default_segmentation_config = dict(
        raw.get("default_segmentation_config", {}) or {})
    cfg.current_step = int(raw.get("current_step", 0) or 0)
    if raw.get("whisperseg_compute_dtype"):
        cfg.compute_dtype = str(raw["whisperseg_compute_dtype"])
    if raw.get("whisperseg_model_name"):
        cfg.model_name = str(raw["whisperseg_model_name"])

    sd = load_hf_state_dict(model_dir)
    token_map = None
    stamped = "extra_tokens" in raw
    try:
        if stamped:
            # an export of ours stamps its extended-token layout, and its
            # embedding matrix is already in our id layout (rows copy
            # straight across, token_map stays None)
            cfg.extra_tokens = list(raw.get("extra_tokens") or [])
            cfg.cluster_encodings = {
                k: list(v)
                for k, v in (raw.get("cluster_encodings") or {}).items()}
        else:
            extras, encodings = derive_extra_tokens(
                model_dir, cfg.cluster_codebook.values())
            cfg.extra_tokens = list(extras.keys())
            cfg.cluster_encodings = encodings
        if cfg.extra_tokens:
            # extended rows follow the compact vocabulary, their count padded
            # to a multiple of 128
            n = len(cfg.extra_tokens)
            cfg.vocab_size = tok.VOCAB_SIZE + ((n + 127) // 128) * 128
        if not stamped:
            token_map = build_token_map(model_dir, cfg.extra_tokens)
    except FileNotFoundError:
        pass
    params = params_from_hf_state_dict(sd, cfg, token_map)
    if raw.get("frame_head") and "frame_head.h1_w" in sd:
        cfg.frame_head = True
        cfg.frame_head_clusters = int(raw.get("frame_head_clusters", 0) or 0)
        params["frame_head"] = {
            k.split(".", 1)[1]: torch.from_numpy(
                np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items() if k.startswith("frame_head.")}
    return params, cfg
