"""Collectives along one mesh axis, in one process.

The counterpart of the reference's ``shard_map`` bodies and their
``lax`` collectives.  Each function takes the per-device values along
one named mesh axis — ``xs[i]`` on ``devices[i]``, in the axis's order —
and returns the per-device results in the same order.  The work runs in
mesh order in this process: a collective is a set of copies
(``Tensor.to``, a no-op within one device) and sums.  Everything is
differentiable, so a backward pass runs the transposed collective
(``psum``'s gradient is a ``psum``, ``all_to_all``'s an
``all_to_all``).  Devices may repeat: a result is computed once per
physical device and the repeats share it.

Under an active ``launch.hlo_analysis.Recorder`` each function announces
itself (``psum``/``pmax`` as ``all-reduce``, ``psum_scatter`` as
``reduce-scatter``, ``all_gather`` as ``all-gather``, ``all_to_all`` as
``all-to-all``, ``ppermute`` as ``collective-permute``) with its group
and result bytes a device; its own copies and sums are then not counted
as ops.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.launch import hlo_analysis as _ha


def _devices(xs, devices):
    return list(devices) if devices is not None else [x.device for x in xs]


def _per_device(fn, devices):
    """``fn(device)`` once per distinct device, in ``devices``' order."""
    done, out = {}, []
    for d in devices:
        if d not in done:
            done[d] = fn(d)
        out.append(done[d])
    return out


def _announced(kind: str):
    """Record the wrapped collective under an active recorder."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(xs, *args, **kwargs):
            if _ha.ACTIVE is None:
                return fn(xs, *args, **kwargs)
            devices = kwargs.get("devices")
            if devices is None and len(args) == fn.__code__.co_argcount - 1:
                devices = args[-1]
            group = _devices(xs, devices)
            receivers = None
            if kind == "collective-permute":
                perm = args[0] if args else kwargs["perm"]
                receivers = [d for s, d in perm if group[s] != group[d]]
            return _ha.ACTIVE.collective(
                kind, group, lambda: fn(xs, *args, **kwargs), receivers,
                [x.device for x in xs])
        return run
    return wrap


@_announced("all-reduce")
def psum(xs, devices=None) -> list:
    """Sum over the axis on every device, in the axis's order (so every
    device holds the same bits)."""
    def total(d):
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = acc + x.to(d)
        return acc
    return _per_device(total, _devices(xs, devices))


@_announced("reduce-scatter")
def psum_scatter(xs, dim: int = -1, devices=None) -> list:
    """Sum over the axis, device ``i`` keeping only its part: positions
    ``size * i // n`` to ``size * (i + 1) // n`` along ``dim`` (the
    reference's ``psum_scatter(..., tiled=True)`` where ``n`` divides
    ``size``), summed in the axis's order."""
    devices = _devices(xs, devices)
    n, size = len(xs), xs[0].shape[dim]
    out = []
    for i, d in enumerate(devices):
        lo, hi = size * i // n, size * (i + 1) // n
        acc = xs[0].narrow(dim, lo, hi - lo).to(d)
        for x in xs[1:]:
            acc = acc + x.narrow(dim, lo, hi - lo).to(d)
        out.append(acc)
    return out


@_announced("all-reduce")
def pmax(xs, devices=None) -> list:
    """Elementwise maximum over the axis on every device."""
    def top(d):
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = torch.maximum(acc, x.to(d))
        return acc
    return _per_device(top, _devices(xs, devices))


@_announced("all-gather")
def all_gather(xs, dim: int = 0, devices=None) -> list:
    """Every device gets the axis's values concatenated along ``dim``
    (the reference's ``all_gather(..., tiled=True)``)."""
    return _per_device(lambda d: torch.cat([x.to(d) for x in xs], dim),
                       _devices(xs, devices))


@_announced("collective-permute")
def ppermute(xs, perm, devices=None) -> list:
    """``perm``: (source, destination) index pairs; a destination no pair
    names receives zeros."""
    devices = _devices(xs, devices)
    src = {dst: s for s, dst in perm}
    return [xs[src[i]].to(devices[i]) if i in src
            else torch.zeros_like(xs[i]) for i in range(len(xs))]


@_announced("all-to-all")
def all_to_all(xs, split_dim: int = 0, concat_dim: int = 0,
               devices=None) -> list:
    """Device ``i`` splits its value into ``n`` equal chunks along
    ``split_dim`` and sends chunk ``j`` to device ``j``, which
    concatenates what it receives along ``concat_dim`` in source order
    (the reference's ``all_to_all(..., tiled=True)``)."""
    devices = _devices(xs, devices)
    n = len(xs)
    chunks = [torch.chunk(x, n, split_dim) for x in xs]
    return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)],
                      concat_dim) for j in range(n)]
