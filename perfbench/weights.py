"""The weights a cell runs: drawn on the device from the seed, or read from a
checkpoint file of the repository. Both give a flat dict keyed as the
checkpoint file (``params.npz``) keys its leaves, which the reference reads
as it is and :func:`tree` nests for the program."""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.model import sinusoids

Leaf = Tuple[str, tuple, str, float]   # key, shape, kind, scale


def layout(cfg: dict) -> List[Leaf]:
    """Every leaf of a WhisperSeg model of the configuration's widths, with
    how it is drawn: ``normal`` leaves N(0, scale), ``gain`` leaves 1 plus
    that, ``sinusoid`` the encoder's fixed position table."""
    d, f = cfg["d_model"], cfg["encoder_ffn_dim"]
    le, ld = cfg["encoder_layers"], cfg["decoder_layers"]
    mel, v = cfg["num_mel_bins"], cfg["vocab_size"]
    small = 0.02
    out: List[Leaf] = [
        ("encoder.conv1_w", (3, mel, d), "normal", 1 / math.sqrt(3 * mel)),
        ("encoder.conv1_b", (d,), "normal", small),
        ("encoder.conv2_w", (3, d, d), "normal", 1 / math.sqrt(3 * d)),
        ("encoder.conv2_b", (d,), "normal", small),
        ("encoder.pos_emb", (cfg["max_source_positions"], d), "sinusoid", 0.0),
        ("encoder.ln_post_g", (d,), "gain", small),
        ("encoder.ln_post_b", (d,), "normal", small),
        ("decoder.tok_emb", (v, d), "normal", small),
        ("decoder.pos_emb", (cfg["max_target_positions"], d), "normal", small),
        ("decoder.ln_post_g", (d,), "gain", small),
        ("decoder.ln_post_b", (d,), "normal", small),
    ]
    for side, n, cross in (("encoder", le, False), ("decoder", ld, True)):
        ff = f if side == "encoder" else cfg["decoder_ffn_dim"]
        names = [("ln1", None), ("q", (d, d)), ("k", (d, d)), ("v", (d, d)),
                 ("o", (d, d)), ("ln2", None), ("fc1", (d, ff)),
                 ("fc2", (ff, d))]
        if cross:
            names += [("lnx", None), ("xq", (d, d)), ("xk", (d, d)),
                      ("xv", (d, d)), ("xo", (d, d))]
        for name, shape in names:
            p = f"{side}.layers.{name}"
            if shape is None:
                out += [(p + "_g", (n, d), "gain", small),
                        (p + "_b", (n, d), "normal", small)]
                continue
            out.append((p + "_w", (n,) + shape, "normal",
                        1 / math.sqrt(shape[0])))
            if name not in ("k", "xk"):   # Whisper's keys have no bias
                out.append((p + "_b", (n, shape[1]), "normal", small))
    return out


def random_weights(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """A model of the configuration's widths drawn from ``seed`` on
    ``device`` in ``dtype``: one normal draw for every drawn leaf together,
    each leaf a view of it scaled in place."""
    leaves = layout(cfg)
    total = sum(math.prod(s) for _, s, kind, _ in leaves if kind != "sinusoid")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, pos = {}, 0
    for key, shape, kind, scale in leaves:
        if kind == "sinusoid":
            out[key] = sinusoids(*shape).to(device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        leaf = flat[pos:pos + n].view(shape)
        pos += n
        leaf.mul_(scale)
        if kind == "gain":
            leaf.add_(1.0)
        out[key] = leaf
    return out


def checkpoint_weights(directory: str) -> Dict[str, torch.Tensor]:
    """float32 host tensors of a checkpoint's ``params.npz`` (bfloat16
    storage is the upper half of float32's bits)."""
    import json

    with open(os.path.join(directory, "config.json")) as f:
        storage = json.load(f).get("__storage_dtype__", "float32")
    out = {}
    with np.load(os.path.join(directory, "params.npz")) as z:
        for k in z.files:
            a = z[k]
            if storage == "bfloat16" and a.dtype == np.uint16:
                a = (a.astype(np.uint32) << 16).view(np.float32)
            out[k] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return out


def tree(flat: Dict[str, torch.Tensor]) -> dict:
    """Dotted keys -> the nested dict the program takes."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flat(nested: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in nested.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out
