"""WhisperSeg on PyTorch and CUDA: the port of ``whisperseg_tpu`` to an
NVIDIA H100.

The package stands alone (it imports neither JAX nor ``whisperseg_tpu``) and
keeps the JAX package's module names, so each module's counterpart is easy
to find. Its entry points run on the card unless the caller asks for the CPU.
"""

from .checkpoint import load_checkpoint, params_from_numpy
from .models.config import WhisperConfig, make_config
from .segmenter import Segmenter

__all__ = ["Segmenter", "WhisperConfig", "load_checkpoint", "make_config",
           "params_from_numpy"]
