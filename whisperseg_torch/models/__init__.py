"""Model configuration and the Whisper encoder/decoder."""

from .config import WhisperConfig, make_config

__all__ = ["WhisperConfig", "make_config"]
