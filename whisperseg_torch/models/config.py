"""Model configuration (a copy of ``whisperseg_tpu/models/config.py``).

Whisper's published family sizes with the two WhisperSeg changes:
``max_source_positions = total_spec_columns // 2`` and the compact 1024-token
vocabulary. The config also carries the segmentation metadata stored with a
checkpoint (``total_spec_columns``, ``cluster_codebook``,
``default_segmentation_config``).

``decoder_family`` names what turns the encoder's states into tokens:
``"whisper"`` for a ``WhisperConfig``, Whisper's own decoder with
cross-attention, or ``"audio_lm"`` for an ``AudioLMConfig``, a decoder-only
language model fed the projected encoder states as its first positions
(models/audio_lm.py), whose widths ``lm`` carries under the keys of its
published ``config.json``. Its other fields then describe the encoder
alone, and ``vocab_size`` is the LM's. A Whisper config's dict and
``config.json`` hold no family key; ``from_dict`` reads an audio-LM one by
its ``decoder_family``."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict

from ..constants import DEFAULT_TOTAL_SPEC_COLUMNS, NUM_MEL_BINS
from ..tokenizer import VOCAB_SIZE


@dataclass
class WhisperConfig:
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    num_kv_heads: int = 0  # 0 -> = num_heads (MHA); < num_heads -> GQA
    d_ff: int = 1536
    num_mel_bins: int = NUM_MEL_BINS
    vocab_size: int = VOCAB_SIZE
    max_source_positions: int = DEFAULT_TOTAL_SPEC_COLUMNS // 2
    max_target_positions: int = 448
    dropout: float = 0.0
    compute_dtype: str = "bfloat16"  # dtype of matmul inputs
    remat: bool = False
    frame_head: bool = False
    frame_head_clusters: int = 0
    total_spec_columns: int = DEFAULT_TOTAL_SPEC_COLUMNS
    extra_tokens: list = field(default_factory=list)
    cluster_encodings: Dict[str, list] = field(default_factory=dict)
    cluster_codebook: Dict[str, int] = field(default_factory=dict)
    default_segmentation_config: Dict[str, Any] = field(default_factory=dict)
    current_step: int = 0
    model_name: str = "custom"
    decoder_family: ClassVar[str] = "whisper"

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Number of K/V heads (grouped-query attention when < num_heads)."""
        n = self.num_kv_heads or self.num_heads
        assert self.num_heads % n == 0
        return n

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WhisperConfig":
        family = d.get("decoder_family", cls.decoder_family)
        if family != cls.decoder_family:
            if family != AudioLMConfig.decoder_family:
                raise ValueError(f"unknown decoder_family {family!r}")
            return AudioLMConfig.from_dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class AudioLMConfig(WhisperConfig):
    """An encoder's config with an ``audio_lm`` decoder: the LM's widths in
    ``lm`` (models/audio_lm.py, ``LMConfig``)."""
    lm: Dict[str, Any] = field(default_factory=dict)
    decoder_family: ClassVar[str] = "audio_lm"

    def to_dict(self) -> Dict[str, Any]:
        return dict(super().to_dict(), decoder_family=self.decoder_family)


_FAMILY = {
    "tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4, num_heads=6),
    "base": dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8),
    "small": dict(d_model=768, encoder_layers=12, decoder_layers=12, num_heads=12),
    "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24, num_heads=16),
    "large": dict(d_model=1280, encoder_layers=32, decoder_layers=32, num_heads=20),
}


def make_config(
    name: str = "base",
    total_spec_columns: int = DEFAULT_TOTAL_SPEC_COLUMNS,
    dropout: float = 0.0,
    **overrides,
) -> WhisperConfig:
    """Build a config for a named Whisper family size."""
    if name not in _FAMILY:
        raise ValueError(f"unknown model size {name!r}; choose from {sorted(_FAMILY)}")
    base = dict(_FAMILY[name])
    base["d_ff"] = 4 * base["d_model"]
    base.update(overrides)
    return WhisperConfig(
        total_spec_columns=total_spec_columns,
        max_source_positions=total_spec_columns // 2,
        dropout=dropout,
        model_name=name,
        **base,
    )
