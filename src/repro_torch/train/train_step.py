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
updates vanish in a bf16 weight.

On a mesh the same ``build_train_step`` is the FSDP+TP step: the model
is built with ``activation_hints`` and the params (and so AdamW's
moments) are ``ShardedTensor``s, whose master blocks are the leaves the
tree helpers reach.  The forward reads each layer's blocks through
differentiable gathers, so the loss's gradients land on the blocks (the
reduce-scatter), and AdamW updates each block in place.

``build_dp_compressed_step``: the reference's pure data-parallel step
with the int8 error-feedback all-reduce (``distributed/compression.py``):
params replicated (held once a physical device), the batch split over a
mesh axis, each replica's local gradients reduced through
``compressed_grad_reduce``, the loss the mean over the axis.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.compression import (compress_grads,
                                                 reduce_codes)
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor, is_sharded,
                                              piece)
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


def _microbatch(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n``: rows i * B/n .. (i+1) * B/n - 1 of each
    leaf [B, ...]; a ``ShardedTensor`` leaf keeps its layout, each block
    assembled where it lives (``ShardedTensor.rows``)."""
    def one(x):
        if is_sharded(x):
            b = x.shape[0] // n
            return x.rows(i * b, (i + 1) * b)
        return _split_micro(x, n)[i]
    return tree_map(one, batch, is_leaf=is_sharded)


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
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(accum):
                mb = _microbatch(batch, i, accum)
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
    """Pure-DP train step with int8 error-feedback gradient all-reduce.

    ``model`` is the single-device model.  Replica ``i`` runs on the
    ``i``-th device along ``axis`` (the other axes at 0) with the params
    there (the same tensors where the device repeats), on rows
    ``i * B/n ..`` of the batch; its local gradients and its residual
    block go through ``compressed_grad_reduce`` (8x fewer all-reduce
    bytes, error carried forward) in its two halves: the replica's
    ``compress_grads`` right after its backward, so one replica's
    gradients are alive at a time, then ``reduce_codes``; AdamW updates
    the params with the reduced gradients.  The state's ``grad_residual`` tree is stacked
    ``[n_dev, ...]`` (``init_compressed_state``) and updated in place.
    The loss is the mean of the replicas' losses over the axis (the
    reference's ``pmean``)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)

    def step(state, batch):
        params = state["params"]
        losses, codes = [], []
        for i, dev in enumerate(devs):
            p_i = tree_map(lambda x: x.to(dev), params)
            b_i = tree_map(lambda x: piece(x, dev, [(
                i * x.shape[0] // n, (i + 1) * x.shape[0] // n)]), batch,
                is_leaf=is_sharded)
            loss, _, g = loss_and_grads(model, p_i, b_i)
            losses.append(loss)
            # row i of each stacked residual, a view of where it is held
            res = tree_map(lambda r: (r.piece(dev, [(i, i + 1)])[0]
                                      if is_sharded(r) else r[i]),
                           state["grad_residual"], is_leaf=is_sharded)
            # the replica's half of compressed_grad_reduce: its codes,
            # its new residual in place; its gradients go at once
            codes.append(compress_grads(g, res))
            del g
        home = tree_leaves(params)[0].device
        grads = reduce_codes(codes, params, [home])[0]
        del codes
        loss = spmd.psum(losses, devs)[0] / n
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg)
        new_state = dict(state, params=new_params, opt=new_opt)
        return new_state, {"loss": loss, **opt_metrics}

    return step


def init_compressed_state(params, n_dev: int, mesh=None,
                          axis: str = "data") -> dict:
    """``init_train_state`` plus per-device residuals, stacked
    ``[n_dev, ...]`` float32 zeros: with a ``mesh``, a ``ShardedTensor``
    split over ``axis`` (block ``r`` on the ``r``-th device along it),
    else one tensor on each leaf's device."""
    st = init_train_state(params)
    if mesh is None:
        st["grad_residual"] = tree_map(lambda p: torch.zeros(
            (n_dev, *p.shape), dtype=torch.float32, device=p.device), params)
        return st
    devs = mesh.axis_devices(axis)
    assert len(devs) == n_dev, (len(devs), n_dev)
    sh = NamedSharding(mesh, P(axis))
    st["grad_residual"] = tree_map(lambda p: ShardedTensor(
        sh, (n_dev, *p.shape), [torch.zeros((1, *p.shape),
                                            dtype=torch.float32, device=d)
                                for d in devs]), params)
    return st
