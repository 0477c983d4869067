"""Train step builder: loss + grad + microbatch accumulation + AdamW
(port of the reference ``train/train_step.py``).

``build_train_step(model, opt_cfg, accum)`` returns ``step(state, batch)
-> (state, metrics)``.  The loss's gradients come from
``torch.autograd.grad`` over the params tree (the reference's
``jax.value_and_grad``); with ``accum`` > 1 the batch splits along dim 0
into microbatches whose gradients accumulate in float32 and are divided
by ``accum``.  The model's ``loss_fn`` takes the training route (no
hand-written kernel: none has a backward).  The update is in place
(``train/optimizer.py``).

Training runs in the float32 weight store, as the reference's does:
``init_train_state`` refuses a params tree with a 16-bit leaf
(``models/params.py``'s ``store=cfg.dtype``), since AdamW's small
updates vanish in a bf16 weight.  The reference's cross-pod
int8-compressed step (``build_dp_compressed_step``) waits for the LM's
sharding (ROADMAP A11.5).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)


def init_train_state(params) -> dict:
    """{"params", "opt"}; raises for a params tree held in a 16-bit
    store."""
    low = sorted({str(x.dtype) for x in tree_leaves(params)
                  if x.dtype in (torch.bfloat16, torch.float16)})
    if low:
        raise ValueError(
            f"init_train_state: params hold {', '.join(low)} leaves (the "
            "16-bit weight store, store=cfg.dtype); AdamW would lose its "
            "updates in them: train in the float32 store (store=None)")
    return {"params": params, "opt": init_opt_state(params)}


def _split_micro(batch: dict, n: int) -> dict:
    """Each leaf [B, ...] -> [n, B // n, ...]: microbatch i is rows
    i * B/n .. (i+1) * B/n - 1."""
    return tree_map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]),
                    batch)


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads): ``model.loss_fn`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same layout; a
    leaf the loss does not reach gets zeros), all detached."""
    req = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(req, batch)
    leaves = tree_leaves(req)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(x): torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda x: by_leaf[id(x)], req))


def build_train_step(model, opt_cfg: OptimizerConfig,
                     accum: int = 1) -> Callable:
    def step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            micro = _split_micro(batch, accum)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(accum):
                mb = tree_map(lambda x: x[i], micro)
                l, _, g = loss_and_grads(model, params, mb)
                for a, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(gi.float())
                loss = loss + l
                del g
            for a in tree_leaves(grads):
                a.div_(accum)
            loss = loss / accum
            metrics = {}
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg)
        new_state = dict(state, params=new_params, opt=new_opt)
        return new_state, {"loss": loss, **opt_metrics, **metrics}

    return step


def build_dp_compressed_step(model, opt_cfg: OptimizerConfig, mesh,
                             axis: str = "data") -> Callable:
    raise NotImplementedError(
        "the data-parallel step with the int8 error-feedback all-reduce "
        "waits for the LM's sharding (ROADMAP A11.5)")


def init_compressed_state(params, n_dev: int) -> dict:
    raise NotImplementedError(
        "per-device gradient residuals belong to the compressed "
        "data-parallel step, which waits for the LM's sharding (ROADMAP "
        "A11.5)")
