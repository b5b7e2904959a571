"""Training layer: AdamW with the JAX package's decay grouping and
schedule, checkpoints, metrics and the training loop."""

from .checkpoint import latest_step_dir, restore_checkpoint, save_checkpoint
from .metrics import MetricsLogger
from .optimizer import cosine_schedule, decay_mask, make_optimizer
from .trainer import Trainer, TrainerConfig, TrainStep, make_eval_step, make_train_step

__all__ = [
    "MetricsLogger",
    "TrainStep",
    "Trainer",
    "TrainerConfig",
    "cosine_schedule",
    "decay_mask",
    "latest_step_dir",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
]
