"""Training numerics of the port: AdamW and its schedule
(``train/optimizer.py``) and the step builder with microbatch
accumulation (``train/train_step.py``).  The trainer loop
(``Trainer``/``TrainerConfig``), checkpoints and the data pipeline wait
for ROADMAP A11.4b."""

from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         cosine_schedule, init_opt_state)
from repro_torch.train.train_step import (build_train_step, init_train_state,
                                          loss_and_grads)

__all__ = ["OptimizerConfig", "adamw_update", "build_train_step",
           "cosine_schedule", "init_opt_state", "init_train_state",
           "loss_and_grads"]
