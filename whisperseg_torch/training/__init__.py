"""Training (the port of ``whisperseg_tpu/training``)."""

from .trainer import TrainArgs, load_model_any, run_training

__all__ = ["TrainArgs", "load_model_any", "run_training"]
