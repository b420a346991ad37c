"""Training (port of ``repro.train``): AdamW and its schedules, and the
single-device Trainer whose checkpoints are the JAX package's."""
from repro_torch.train.optimizer import (AdamW, AdamWState, cosine_schedule,
                                         linear_schedule)
from repro_torch.train.trainer import TrainConfig, Trainer, TrainState

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "linear_schedule",
           "TrainConfig", "Trainer", "TrainState"]
