"""Training substrate of the port (``repro.train``): the train step with
gradient accumulation, AdamW, gradient compression and checkpoints."""

from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, lr_schedule)
from repro_torch.train.train_step import (TrainState, make_loss_fn,
                                          make_train_step)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import compress_grads

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "TrainState",
    "make_train_step",
    "make_loss_fn",
    "CheckpointManager",
    "compress_grads",
]
