"""Training: state, fused AdamW+EMA, the train step and checkpoints."""

from .checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_name,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
from .state import TrainState, ema_update
from .trainer import Trainer, make_optimizer, sample_from_latent, warmup_cosine_lr

__all__ = [
    "TrainState", "ema_update",
    "Trainer", "make_optimizer", "warmup_cosine_lr", "sample_from_latent",
    "AsyncCheckpointWriter", "checkpoint_name", "save_checkpoint", "load_checkpoint", "load_train_state",
]
