"""Trainer: the fault-tolerant training loop (port of the reference
``train/trainer.py``).

Wires together: model + train step + data loader + checkpoint manager +
heartbeat monitor.  Restart-safe by construction: state is (checkpointed
params/opt, step index); the data pipeline is a pure function of the
step, so a restart resumes bit-identically from the last committed
checkpoint.

Without a mesh it runs on one ``device`` (``"cuda"`` unless the caller
asks for the CPU; it raises without a card).  With one (``mesh``, a
``launch.mesh.Mesh``), as the reference: the model is built with
``activation_hints(cfg, mesh, global_batch, "train")``, the params and
AdamW's ``m``/``v`` are laid out by ``shardings_for`` (``ShardedTensor``
blocks on the mesh's devices) and each batch is split by
``batch_shardings``; checkpoints hold whole arrays and restore onto the
state's layout.  The step is ``build_train_step``'s, called as it is:
there is no jit, and no donation, since ``adamw_update`` already writes
the params and the moments in place.  ``run`` keeps its losses and step
timer on the trainer (``losses``, ``timer``), where a supervisor finds
them after a crash.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import (activation_hints,
                                              batch_shardings, shardings_for)
from repro_torch.models import build_model, init_params
from repro_torch.models.layers import NO_HINTS
from repro_torch.models.params import tree_map
from repro_torch.runtime import HeartbeatMonitor, StepTimer
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import build_train_step, init_train_state

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    seed: int = 0
    accum: int = 1


class Trainer:
    def __init__(self, arch_cfg, loader, opt_cfg: OptimizerConfig,
                 tcfg: TrainerConfig, mesh=None, global_batch: int = 8,
                 device="cuda"):
        self.cfg = arch_cfg
        self.tcfg = tcfg
        self.loader = loader
        self.mesh = mesh
        hints = (activation_hints(arch_cfg, mesh, global_batch, "train")
                 if mesh is not None else NO_HINTS)
        # on a mesh the model runs on the mesh's devices, not ``device``
        self.model = build_model(arch_cfg, hints, device=device)
        self.device = self.model.device
        self.step_fn = build_train_step(self.model, opt_cfg, tcfg.accum)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.monitor = HeartbeatMonitor()
        self.global_batch = global_batch

    # -- state ----------------------------------------------------------------
    def init_state(self):
        params = init_params(self.model.spec(), self.tcfg.seed, self.device)
        if self.mesh is not None:
            # m and v follow the params' layout (init_opt_state maps the
            # blocks)
            params = tree_map(lambda x, sh: sh.place(x), params,
                              shardings_for(self.model.spec(), self.mesh))
        return init_train_state(params)

    def batch(self, step: int) -> dict:
        """The loader's batch for ``step`` on the device, split over the
        mesh's data axes where there is one."""
        batch = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                         self.loader(step))
        if self.mesh is None:
            return batch
        return tree_map(lambda x, sh: sh.place(x), batch, batch_shardings(
            batch, self.mesh, self.global_batch))

    def maybe_restore(self, state):
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                log.info("restoring checkpoint step %d", latest)
                state = self.ckpt.restore(latest, state)
                start = latest
        return state, start

    # -- loop ------------------------------------------------------------------
    def run(self, state=None):
        if state is None:
            state = self.init_state()
        state, start = self.maybe_restore(state)
        # kept on the trainer, so a supervisor reads them after a crash too
        timer = self.timer = StepTimer()
        losses = self.losses = []
        try:
            for step in range(start, self.tcfg.steps):
                batch = self.batch(step)
                timer.start()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = timer.stop()
                losses.append(loss)
                self.monitor.heartbeat("worker0", step)
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.0f ms)", step, loss,
                             dt * 1e3)
                if self.ckpt is not None and \
                        (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save_async(step + 1, state)
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}")
        except Exception:
            # Crash path: the supervisor will restart from the latest
            # *committed* checkpoint — let any in-flight async save finish
            # committing before the failure propagates, or the restart
            # silently falls back to an older step (lost work).
            # (Exception, not BaseException: Ctrl-C should stay prompt
            # rather than block on a write to slow storage.)
            if self.ckpt is not None:
                self.ckpt.wait()
            raise
        if self.ckpt is not None:
            self.ckpt.save(self.tcfg.steps, state)
            self.ckpt.wait()
        return state, losses
