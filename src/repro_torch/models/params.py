"""Parameter specs: shapes + dtypes + logical axes + initializers.

Port of the reference ``models/params.py``.  A model is described as a
tree (nested dicts and lists) of ``LeafSpec``; ``init_params`` turns it
into a tree of the same layout holding tensors, so the reference's
params carry across leaf by leaf (``models/convert.py``).

The logical axes give each leaf's layout on a mesh
(``distributed/sharding.py``'s ``spec_for``; ``axes_tree`` lists them).
``abstract_params`` stands in for the reference's ``ShapeDtypeStruct``
tree with tensors on the ``meta`` device, which allocate nothing.

The store.  Every spec says float32, the reference's store, and
``init_params``/``params_from_reference`` keep it by default.  A leaf
marked ``cast`` is one that every path reads only through a cast to the
compute type (``cfg.dtype``): ``dense``'s weight and bias, the
embedding, the head and the experts' weights.  Rounding such a leaf once
when it is stored gives the bits that rounding it at each use gives, so
``store=cfg.dtype`` holds those leaves in the compute type and computes
exactly what the float32 store computes, at about half its bytes.  The
leaves read in float32 (the MoE router, the norms, the RG-LRU gates'
weights and decay, mamba2's ``a_log``/``dt_bias``/``d_skip`` and every
conv tap) are not marked and stay float32.
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
    init: str = "normal"  # normal | zeros | ones | rglru_a | ssm_a | dt_bias
    scale: float = 1.0
    dtype: str = "float32"
    # read only through a cast to the compute type, so it may be stored
    # in that type (``store_spec``)
    cast: bool = False

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
        # a ShardedTensor (a list of blocks) keeps its layout
        make = getattr(tree, "_tree_new", type(tree))
        return make(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
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


def store_spec(spec_tree, store: str | None = None):
    """``spec_tree`` as stored: each ``cast`` leaf's dtype set to
    ``store`` (a compute type, such as ``cfg.dtype``); ``None`` keeps
    the specs' float32."""
    if store is None:
        return spec_tree
    if store not in DTYPES:
        raise ValueError(f"unknown store dtype {store!r}")
    return tree_map(lambda s: dataclasses.replace(s, dtype=store)
                    if s.cast else s, spec_tree, is_leaf=is_leaf_spec)


def abstract_params(spec_tree):
    """The spec tree as ``meta`` tensors of its shapes and dtypes: no
    allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                          device="meta"),
                    spec_tree, is_leaf=is_leaf_spec)


def axes_tree(spec_tree):
    return tree_map(lambda s: s.axes, spec_tree, is_leaf=is_leaf_spec)


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


# elements of float32 draws a 16-bit leaf takes at once (512 MB); one
# slice of its leading dim at the least
_DRAW_ELEMS = 1 << 27


def _normal(spec: LeafSpec, gen: torch.Generator, dev, dt) -> torch.Tensor:
    """A float32 leaf in one draw.  A 16-bit leaf is drawn a run of
    leading-dim slices at a time into its own storage, so no float32
    copy of the whole leaf exists: moonshot-v1-16b-a3b's stacked expert
    leaf [48, 64, 2048, 1408] would need 35.4 GB for one."""
    if dt == torch.float32:
        return torch.randn(spec.shape, generator=gen, dtype=dt,
                           device=dev).mul_(spec.scale)
    out = torch.empty(spec.shape, dtype=dt, device=dev)
    step = max(1, _DRAW_ELEMS // math.prod(spec.shape[1:]))
    for i in range(0, spec.shape[0], step):
        part = out[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32,
                               device=dev).mul_(spec.scale))
    return out


def _init_leaf(spec: LeafSpec, gen: torch.Generator, dev) -> torch.Tensor:
    dt = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=dev)
    if spec.init == "normal":
        return _normal(spec, gen, dev, dt)
    if spec.init == "rglru_a":
        # RG-LRU Lambda init: a = sigmoid(Lambda) uniform in [0.9, 0.999]
        u = _uniform(spec, gen, dev, 0.9, 0.999)
        return torch.log(u / (1.0 - u)).to(dt)
    if spec.init == "ssm_a":
        # mamba2 A init: -uniform[1, 16] stored as log
        return torch.log(_uniform(spec, gen, dev, 1.0, 16.0)).to(dt)
    if spec.init == "dt_bias":
        # mamba dt bias: softplus^-1 of uniform[1e-3, 1e-1]
        return torch.log(torch.expm1(
            _uniform(spec, gen, dev, 1e-3, 1e-1))).to(dt)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(spec_tree, seed: int = 0, device="cuda",
                store: str | None = None):
    """Concrete initialization on ``device``: every leaf drawn in turn
    from one ``torch.Generator`` seeded with ``seed``, in the spec's
    order, and stored as ``store_spec(spec_tree, store)`` says.  The
    numbers differ from ``jax.random``'s (and a 16-bit leaf's from the
    same leaf drawn in float32); tests carry the reference's weights
    across instead."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen, dev),
                    store_spec(spec_tree, store), is_leaf=is_leaf_spec)


def normal(shape, axes, scale=None, dtype="float32",
           cast: bool = False) -> LeafSpec:
    if scale is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    return LeafSpec(tuple(shape), tuple(axes), "normal", scale, dtype, cast)


def zeros(shape, axes, dtype="float32", cast: bool = False) -> LeafSpec:
    return LeafSpec(tuple(shape), tuple(axes), "zeros", dtype=dtype,
                    cast=cast)


def ones(shape, axes, dtype="float32") -> LeafSpec:
    return LeafSpec(tuple(shape), tuple(axes), "ones", dtype=dtype)


def stacked(n: int, spec_tree):
    """Prepend a ``layers`` dim to every leaf of a per-layer spec."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n, *s.shape),
                                      axes=("layers", *s.axes)),
        spec_tree, is_leaf=is_leaf_spec)
