"""Model resolution (the local and cache part of ``whisperseg_tpu/hub.py``).

``download_model`` resolves a model name to a local checkpoint directory: a
local path passes through; a built-in name resolves to a checkpoint shipped
under ``<repo>/pretrained/``; any other name is looked up in the cache
directory (``$WHISPERSEG_MODEL_CACHE``, default
``~/.cache/whisperseg_tpu_models/``, shared with the JAX package) under a
sha256 of the name. The port fetches nothing: a name that is neither local,
built in nor cached raises.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional


def pretrained_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "pretrained")


def builtin_models() -> Dict[str, str]:
    """{name: checkpoint path} of the models shipped in the repository:
    every ``pretrained/<name>/`` directory that holds a ``config.json``."""
    out = {}
    root = pretrained_dir()
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if os.path.exists(os.path.join(path, "config.json")):
                out[name] = path
    return out


def default_pretrained_model() -> Optional[str]:
    """Path of the default model (the multi-species generalist), else the
    first built-in one, else None."""
    models = builtin_models()
    if "whisperseg-base-animal-vad" in models:
        return models["whisperseg-base-animal-vad"]
    return next(iter(models.values()), None)


def model_cache_dir() -> str:
    return os.environ.get(
        "WHISPERSEG_MODEL_CACHE",
        os.path.expanduser("~/.cache/whisperseg_tpu_models/"))


def download_model(model_name: str) -> str:
    """A local path as it is, else a built-in model, else the cache entry."""
    if os.path.exists(model_name):
        return model_name
    builtin = builtin_models().get(model_name)
    if builtin is not None:
        return builtin
    digest = hashlib.sha256(model_name.encode()).hexdigest()
    target = os.path.join(model_cache_dir(), digest)
    if os.path.isdir(target) and os.listdir(target):
        return target
    raise NotImplementedError(
        f"model {model_name!r} is neither a local path, a built-in model nor "
        f"cached under {target}; downloads from the HF hub are not part of "
        f"the port (no huggingface_hub): place the checkpoint there or pass "
        f"its directory")
