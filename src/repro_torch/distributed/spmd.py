"""Collectives along one mesh axis, in one process.

The counterpart of the reference's ``shard_map`` bodies and their
``lax`` collectives.  Each function takes the per-device values along
one named mesh axis — ``xs[i]`` on ``devices[i]``, in the axis's order —
and returns the per-device results in the same order.  The work runs in
mesh order in this process: a collective is a set of copies
(``Tensor.to``, a no-op within one device) and sums.

Each differentiable collective is one ``torch.autograd.Function`` whose
backward is the transposed collective, called through this module (so
it is announced like a forward one), as ``lax``'s transpose rules give
it:

    psum               -> psum
    all_gather(dim)    -> psum_scatter(dim), each input's length its part
    psum_scatter(dim)  -> all_gather(dim)
    all_to_all(s, c)   -> all_to_all(c, s)
    ppermute(perm)     -> ppermute(the inverse pairs)

each result landing on its input's device.  ``pmax`` is not
differentiable: it reads its inputs detached (a stabiliser's maximum,
whose gradient cancels).  Devices may repeat: a result is computed once
per physical device and each repeat gets its own view of it, so the
backward sees every position's gradient and sums them.  A sum of 16-bit
values (``psum``, ``psum_scatter``; the backward of an ``all_gather`` of
16-bit activations among them) accumulates in float32 and rounds once:
a 16-bit add would round at each step.

Under an active ``launch.hlo_analysis.Recorder`` each function announces
itself (``psum``/``pmax`` as ``all-reduce``, ``psum_scatter`` as
``reduce-scatter``, ``all_gather`` as ``all-gather``, ``all_to_all`` as
``all-to-all``, ``ppermute`` as ``collective-permute``) with its group
and result bytes a device; its own copies and sums are then not counted
as ops.  A backward's collective is announced the same way, not as
copies.
"""

from __future__ import annotations

import functools
import inspect

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
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def run(xs, *args, **kwargs):
            if _ha.ACTIVE is None:
                return fn(xs, *args, **kwargs)
            bound = sig.bind(xs, *args, **kwargs).arguments
            group = _devices(xs, bound.get("devices"))
            receivers = None
            if kind == "collective-permute":
                receivers = [d for s, d in bound["perm"]
                             if group[s] != group[d]]
            return _ha.ACTIVE.collective(
                kind, group, lambda: fn(xs, *args, **kwargs), receivers,
                [x.device for x in xs])
        return run
    return wrap


class _Collective(torch.autograd.Function):
    """``run(xs)`` -> per-position results; the backward is
    ``transpose(grads, the inputs' devices)``."""

    @staticmethod
    def forward(ctx, run, transpose, *xs):
        ctx.transpose = transpose
        ctx.sources = [x.device for x in xs]
        outs, seen = [], {id(x) for x in xs}
        for y in run(xs):
            # a position's own tensor: a repeat (or an input passed
            # through) becomes a view, so it keeps its own gradient slot
            if id(y) in seen:
                y = y.view_as(y)
            seen.add(id(y))
            outs.append(y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.transpose(list(grads), ctx.sources))


def _collective(run, transpose, xs) -> list:
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
        return run(xs)
    return list(_Collective.apply(run, transpose, *xs))


def _wide(dtype) -> torch.dtype:
    """The type a sum of ``dtype`` values accumulates in."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _sum(parts, d, dtype):
    """``parts`` summed in order on ``d`` (in float32 for 16-bit parts,
    rounded once to ``dtype``)."""
    wide = _wide(dtype)
    acc = parts[0].to(d, wide)
    for x in parts[1:]:
        acc = acc + x.to(d, wide)
    return acc if wide == dtype else acc.to(dtype)


def _psum(xs, devices) -> list:
    return _per_device(lambda d: _sum(xs, d, xs[0].dtype), devices)


@_announced("all-reduce")
def psum(xs, devices=None) -> list:
    """Sum over the axis on every device, in the axis's order (so every
    device holds the same bits)."""
    devices = _devices(xs, devices)
    return _collective(lambda xs: _psum(xs, devices),
                       lambda gs, src: psum(gs, src), xs)


def _bounds(size: int, n: int, sizes) -> list:
    if sizes is None:
        return [(size * i // n, size * (i + 1) // n) for i in range(n)]
    assert len(sizes) == n and sum(sizes) == size, (sizes, size)
    ends = [sum(sizes[:i + 1]) for i in range(n)]
    return [(e - s, e) for s, e in zip(sizes, ends)]


@_announced("reduce-scatter")
def psum_scatter(xs, dim: int = -1, devices=None, sizes=None) -> list:
    """Sum over the axis, device ``i`` keeping only its part: positions
    ``size * i // n`` to ``size * (i + 1) // n`` along ``dim`` (the
    reference's ``psum_scatter(..., tiled=True)`` where ``n`` divides
    ``size``; ``layers.split_range``), or the ``sizes[i]`` positions
    after the first ``i`` parts, summed in the axis's order."""
    devices = _devices(xs, devices)
    parts = _bounds(xs[0].shape[dim], len(xs), sizes)

    def run(xs):
        return [_sum([x.narrow(dim, lo, hi - lo) for x in xs], d,
                     xs[0].dtype) for (lo, hi), d in zip(parts, devices)]
    return _collective(run, lambda gs, src: all_gather(gs, dim, src), xs)


@_announced("all-reduce")
def pmax(xs, devices=None) -> list:
    """Elementwise maximum over the axis on every device; not
    differentiable (its inputs are read detached)."""
    xs = [x.detach() for x in xs]

    def top(d):
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = torch.maximum(acc, x.to(d))
        return acc
    return _per_device(top, _devices(xs, devices))


@_announced("all-gather")
def all_gather(xs, dim: int = 0, devices=None) -> list:
    """Every device gets the axis's values concatenated along ``dim``
    (the reference's ``all_gather(..., tiled=True)``; the values may
    differ in length along ``dim``)."""
    devices = _devices(xs, devices)
    sizes = [x.shape[dim] for x in xs]
    return _collective(
        lambda xs: _per_device(lambda d: torch.cat([x.to(d) for x in xs],
                                                   dim), devices),
        lambda gs, src: psum_scatter(gs, dim, src, sizes), xs)


@_announced("collective-permute")
def ppermute(xs, perm, devices=None) -> list:
    """``perm``: (source, destination) index pairs; a destination no pair
    names receives zeros."""
    devices = _devices(xs, devices)
    src = {dst: s for s, dst in perm}
    inverse = [(d, s) for s, d in perm]
    return _collective(
        lambda xs: [xs[src[i]].to(devices[i]) if i in src
                    else torch.zeros_like(xs[i]) for i in range(len(xs))],
        lambda gs, srcs: ppermute(gs, inverse, srcs), xs)


@_announced("all-to-all")
def all_to_all(xs, split_dim: int = 0, concat_dim: int = 0,
               devices=None) -> list:
    """Device ``i`` splits its value into ``n`` equal chunks along
    ``split_dim`` and sends chunk ``j`` to device ``j``, which
    concatenates what it receives along ``concat_dim`` in source order
    (the reference's ``all_to_all(..., tiled=True)``)."""
    devices = _devices(xs, devices)

    def run(xs):
        n = len(xs)
        chunks = [torch.chunk(x, n, split_dim) for x in xs]
        return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)],
                          concat_dim) for j in range(n)]
    return _collective(
        run, lambda gs, src: all_to_all(gs, concat_dim, split_dim, src), xs)
