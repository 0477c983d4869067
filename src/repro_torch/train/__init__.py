"""Training substrate of the port: AdamW and its schedule
(``train/optimizer.py``), the step builders — microbatch accumulation,
FSDP+TP on a mesh, the int8-compressed data-parallel step
(``train/train_step.py``) — and the fault-tolerant trainer loop
(``train/trainer.py``: checkpoints, heartbeats, crash and resume)."""

from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         cosine_schedule, init_opt_state)
from repro_torch.train.train_step import (build_dp_compressed_step,
                                          build_train_step,
                                          init_compressed_state,
                                          init_train_state, loss_and_grads)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["OptimizerConfig", "Trainer", "TrainerConfig", "adamw_update",
           "build_dp_compressed_step", "build_train_step",
           "cosine_schedule", "init_compressed_state", "init_opt_state",
           "init_train_state", "loss_and_grads"]
