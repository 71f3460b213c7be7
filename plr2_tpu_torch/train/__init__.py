"""Training: the curriculum `Trainer` (per-sample accumulation), the
`FusedTrainer` (windows on a shared canvas), `BatchTrainer` (mean
gradient, batch BN; mixed precision through `ModelConfig.dtype`; on one
device or over a process-group mesh) and `CheckpointManager`."""

from plr2_tpu_torch.train.batch_trainer import BatchTrainer
from plr2_tpu_torch.train.checkpoint import CheckpointManager
from plr2_tpu_torch.train.fused_accum import (make_fused_accum_step,
                                              make_fused_window_grads)
from plr2_tpu_torch.train.fused_trainer import FusedTrainer
from plr2_tpu_torch.train.trainer import Trainer, TrainState

__all__ = ["BatchTrainer", "CheckpointManager", "FusedTrainer", "Trainer",
           "TrainState", "make_fused_accum_step", "make_fused_window_grads"]
