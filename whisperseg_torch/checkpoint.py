"""Checkpoints: ``config.json`` + ``params.npz`` <-> (tensor tree, config).

Reads and writes the JAX package's checkpoint directories as they are, and
keeps its training-checkpoint lifecycle (``checkpoint-{step}`` directories,
pruning, ``final_checkpoint``). Parameters keep
the JAX layouts: stacked per-layer weights ``[L, in, out]`` applied as
``x @ w`` and conv kernels ``[3, in, out]`` (the encoder runs each conv as one
matmul over the three taps, models/whisper.py), so a tree moves between the
two packages without relayout. Quantized leaves (ops/quant.py) cross as
``{"values", "scale"}`` / ``{"packed", "scale"}`` pairs of numpy arrays.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models import audio_lm
from .models.config import WhisperConfig
from .ops.quant import Quant4Tensor, QuantTensor

_SEP = "."


def _unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict:
    """Cast every floating leaf to ``dtype`` (LayerNorm gains, position tables
    and the frame head included, as the JAX Segmenter does), and move every
    leaf to ``device`` when one is given. Quantized leaves keep their int8
    storage and float32 scales, and move."""
    return _map(params, lambda t: t.to(
        device=device, dtype=dtype if t.is_floating_point() else None))


def _check_tree(params: dict, cfg: WhisperConfig) -> None:
    d = cfg.d_model
    want = {
        "encoder.layers.q_w": (cfg.encoder_layers, d, d),
        "encoder.conv1_w": (3, cfg.num_mel_bins, d),
    }
    if cfg.decoder_family == "audio_lm":
        want.update(audio_lm.expected_shapes(cfg))
    else:
        want.update({"decoder.layers.q_w": (cfg.decoder_layers, d, d),
                     "decoder.tok_emb": (cfg.vocab_size, d)})
    flat = _flatten(params)
    for key, shape in want.items():
        if key not in flat:
            raise KeyError(f"parameter {key!r} missing from the tree")
        if tuple(flat[key].shape) != shape:
            raise ValueError(f"{key}: shape {tuple(flat[key].shape)} does not "
                             f"match the config's {shape}")


def params_from_numpy(tree: dict, cfg: WhisperConfig, device,
                      dtype: torch.dtype = torch.float32) -> dict:
    """JAX parameters as numpy arrays (a nested tree or a flat dict with
    dotted keys) -> the port's nested dict of tensors on ``device``, floating
    leaves cast to ``dtype``. Layouts are kept (see the module note). A
    ``{"values", "scale"}`` or ``{"packed", "scale"}`` pair becomes a
    ``QuantTensor`` or ``Quant4Tensor`` bit for bit."""
    if any(_SEP in k for k in tree):
        tree = _unflatten(tree)

    def to_tensor(a):
        a = np.asarray(a)
        # JAX's bf16 leaves reach numpy as ml_dtypes.bfloat16, which
        # torch.from_numpy refuses: carry their 16 bits over unchanged
        storage = "bfloat16" if a.dtype.name == "bfloat16" else "float32"
        t = _from_storage(a, storage)
        return t.to(device=device, dtype=dtype if t.is_floating_point() else None)

    def build(node):
        if not isinstance(node, dict):
            return to_tensor(node)
        for cls, storage in ((QuantTensor, "values"), (Quant4Tensor, "packed")):
            if set(node) == {storage, "scale"}:
                return cls(torch.from_numpy(np.array(node[storage], np.int8)),
                           torch.from_numpy(np.array(node["scale"], np.float32))
                           ).to(device)
        return {k: build(v) for k, v in node.items()}

    params = build(tree)
    _check_tree(params, cfg)
    return params


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`: float32 numpy leaves (bf16 widens
    exactly), quantized leaves as their pairs of arrays."""
    def to_numpy(t):
        if isinstance(t, QuantTensor):
            return {"values": to_numpy(t.values), "scale": to_numpy(t.scale)}
        if isinstance(t, Quant4Tensor):
            return {"packed": to_numpy(t.packed), "scale": to_numpy(t.scale)}
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return _map(params, to_numpy)


def _from_storage(arr: np.ndarray, storage_dtype: str) -> torch.Tensor:
    if storage_dtype == "bfloat16":
        # bf16 leaves are stored as their raw 16 bits (uint16): reinterpret
        # them through int16, which torch.from_numpy accepts.
        bits = np.array(arr, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_checkpoint(directory: str) -> Tuple[dict, WhisperConfig]:
    """Load a checkpoint directory into float32 host tensors (bf16 storage
    widens exactly, as the JAX loader does); ``Segmenter`` casts and moves
    them."""
    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    storage_dtype = meta.pop("__storage_dtype__", "float32")
    config = WhisperConfig.from_dict(meta)
    with np.load(os.path.join(directory, "params.npz")) as z:
        flat = {k: _from_storage(z[k], storage_dtype) for k in z.files}
    params = _map(_unflatten(flat), lambda t: t.float())
    _check_tree(params, config)
    return params, config


# ------------------------------------------------------------------ saving


def save_checkpoint(directory: str, params: dict, config: WhisperConfig,
                    step: Optional[int] = None) -> str:
    """Write ``params.npz`` (flat dotted keys, float32) and ``config.json``
    to ``directory``; ``step`` is stamped into the config's
    ``current_step``."""
    os.makedirs(directory, exist_ok=True)
    if step is not None:
        config.current_step = int(step)
    np.savez(os.path.join(directory, "params.npz"),
             **_flatten(params_to_numpy(params)))
    meta = config.to_dict()
    meta["__storage_dtype__"] = "float32"
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return directory


def list_checkpoints(model_folder: str) -> List[str]:
    """``checkpoint-*`` directories sorted by step."""
    if not os.path.isdir(model_folder):
        return []
    found = []
    for name in os.listdir(model_folder):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            found.append((int(m.group(1)), os.path.join(model_folder, name)))
    return [p for _, p in sorted(found)]


def save_training_checkpoint(model_folder: str, params: dict,
                             config: WhisperConfig, step: int,
                             max_to_keep: int = -1,
                             keep_step: Optional[int] = None) -> str:
    """Write ``model_folder/checkpoint-{step}`` and prune the oldest beyond
    ``max_to_keep``, never ``checkpoint-{keep_step}`` (the best validation
    step, which :func:`finalize_best_checkpoint` may promote)."""
    path = os.path.join(model_folder, f"checkpoint-{step}")
    save_checkpoint(path, params, config, step=step)
    if max_to_keep is not None and max_to_keep > 0:
        protected = (os.path.join(model_folder, f"checkpoint-{keep_step}")
                     if keep_step is not None else None)
        ckpts = [c for c in list_checkpoints(model_folder) if c != protected]
        for old in ckpts[:-max_to_keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def finalize_best_checkpoint(model_folder: str,
                             best_step: Optional[int]) -> Optional[str]:
    """Copy the winning checkpoint (``best_step``, else the newest) to
    ``final_checkpoint`` and delete the ``checkpoint-*`` directories."""
    ckpts = list_checkpoints(model_folder)
    if not ckpts:
        return None
    src = ckpts[-1]
    if best_step is not None:
        best = os.path.join(model_folder, f"checkpoint-{best_step}")
        if best in ckpts:
            src = best
        else:
            print(f"Warning: best-validation checkpoint-{best_step} no longer "
                  f"exists (pruned?); falling back to {src}")
    dst = os.path.join(model_folder, "final_checkpoint")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for c in ckpts:
        shutil.rmtree(c, ignore_errors=True)
    return dst
