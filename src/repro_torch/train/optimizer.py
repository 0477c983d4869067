"""AdamW and its schedule, hand-rolled (port of the reference
``train/optimizer.py``).

The state mirrors the params tree: float32 ``m`` and ``v`` per leaf,
beside an int32 ``step`` on the params' device, so nothing here syncs the
host.  Where the reference returns new arrays (and donates the old ones
to its jitted step), ``adamw_update`` writes the params, ``m`` and ``v``
in place under ``torch.no_grad()`` and returns the same trees: at full
width a second copy of the params and the moments would not fit beside
them.  Each leaf's update makes at most two temporaries of its size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: OptimizerConfig
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer tensor) -> lr (float32): linear warm-up over
    ``warmup_steps``, then a cosine down to ``min_lr_frac * lr`` at
    ``total_steps``."""
    def lr(step):
        step = step.to(torch.float32)
        warm = cfg.lr * (step + 1) / max(1, cfg.warmup_steps)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)
    return lr


def init_opt_state(params) -> dict:
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, on the first
    leaf's device (the leaves of a mesh's blocks may lie on several)."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x, dtype=torch.float32).to(dev)
         for x in leaves]))


def leaf_paths(tree, path: tuple = ()) -> list:
    """Each leaf's path of dict keys and list indices, in
    ``tree_leaves``' order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, path + (i,))]
    return [path]


def _decay_mask(path: tuple) -> bool:
    """No weight decay on norms / biases / 1-D params: the reference's
    test, a substring of the leaf's path joined by ``/`` (a dense
    layer's bias, ``b``, and the conv bias ``conv_b`` match none, so they
    decay, as in the reference)."""
    name = "/".join(str(k) for k in path)
    return not any(t in name for t in ("scale", "bias", "lam", "a_log",
                                       "dt_bias", "d_skip"))


@torch.no_grad()
def adamw_update(params, grads, opt, cfg: OptimizerConfig):
    """One AdamW step: gradients clipped by their global norm, bias
    corrected moments, decoupled weight decay.  Writes ``params``,
    ``opt["m"]`` and ``opt["v"]`` in place and returns (params, opt with
    ``step`` advanced, {"lr", "grad_norm"})."""
    step = opt["step"] + 1
    lr = cosine_schedule(cfg)(opt["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.betas
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    here = (scale, bc1, bc2, lr)
    by_device = {}
    for path, p, g, m, v in zip(leaf_paths(params), tree_leaves(params),
                                tree_leaves(grads), tree_leaves(opt["m"]),
                                tree_leaves(opt["v"])):
        if p.device not in by_device:   # blocks of a mesh on several
            by_device[p.device] = tuple(x.to(p.device) for x in here)
        s_, bc1_, bc2_, lr_ = by_device[p.device]
        g = g.float() * s_
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = torch.div(m, bc1_, out=g)       # g's storage, spent
        delta.div_((v / bc2_).sqrt_().add_(cfg.eps))
        if _decay_mask(path):
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr_).to(p.dtype))
    new_opt = {"m": opt["m"], "v": opt["v"], "step": step}
    return params, new_opt, {"lr": lr, "grad_norm": gnorm}
