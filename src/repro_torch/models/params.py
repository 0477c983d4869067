"""Parameter specs: shapes + dtypes + logical axes + initializers.

Port of the reference ``models/params.py``.  A model is described as a
tree (nested dicts and lists) of ``LeafSpec``; ``init_params`` turns it
into a tree of the same layout holding tensors, so the reference's
params carry across leaf by leaf (``models/convert.py``).

The logical axes are kept for a later sharding slice (ROADMAP A9); the
port reads none of them yet.  ``abstract_params`` and ``axes_tree`` are
dry-run tools of the reference and are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32,
          "int64": torch.int64}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | dt_bias
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_leaf_spec(x) -> bool:
    return isinstance(x, LeafSpec)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (and of
    parallel trees ``rest`` with the same layout)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def param_bytes(spec_tree) -> int:
    return sum(math.prod(s.shape) * DTYPES[s.dtype].itemsize
               for s in tree_leaves(spec_tree, is_leaf_spec))


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape)
               for s in tree_leaves(spec_tree, is_leaf_spec))


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (the port never moves to the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return dev


def _uniform(spec, gen, dev, lo, hi):
    u = torch.empty(spec.shape, dtype=torch.float32, device=dev)
    return u.uniform_(lo, hi, generator=gen)


def _init_leaf(spec: LeafSpec, gen: torch.Generator, dev) -> torch.Tensor:
    dt = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=dev)
    if spec.init == "normal":
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(spec.scale).to(dt)
    if spec.init == "ssm_a":
        # mamba2 A init: -uniform[1, 16] stored as log
        return torch.log(_uniform(spec, gen, dev, 1.0, 16.0)).to(dt)
    if spec.init == "dt_bias":
        # mamba dt bias: softplus^-1 of uniform[1e-3, 1e-1]
        return torch.log(torch.expm1(
            _uniform(spec, gen, dev, 1e-3, 1e-1))).to(dt)
    raise ValueError(f"unknown init {spec.init!r} (rglru_a comes with the "
                     "recurrent block, ROADMAP A11)")


def init_params(spec_tree, seed: int = 0, device="cuda"):
    """Concrete initialization on ``device``: every leaf drawn in turn
    from one ``torch.Generator`` seeded with ``seed``, in the spec's
    order.  The numbers differ from ``jax.random``'s; tests carry the
    reference's weights across instead."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen, dev), spec_tree,
                    is_leaf=is_leaf_spec)


def normal(shape, axes, scale=None, dtype="float32") -> LeafSpec:
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    return LeafSpec(tuple(shape), tuple(axes), "normal", scale, dtype)


def zeros(shape, axes, dtype="float32") -> LeafSpec:
    return LeafSpec(tuple(shape), tuple(axes), "zeros", dtype=dtype)


def ones(shape, axes, dtype="float32") -> LeafSpec:
    return LeafSpec(tuple(shape), tuple(axes), "ones", dtype=dtype)


def stacked(n: int, spec_tree):
    """Prepend a ``layers`` dim to every leaf of a per-layer spec."""
    return tree_map(
        lambda s: LeafSpec((n, *s.shape), ("layers", *s.axes), s.init,
                           s.scale, s.dtype), spec_tree, is_leaf=is_leaf_spec)
