"""Divisibility-aware logical-axis -> mesh-axis sharding rules, the
layout they describe, and the fact engine's device list.

Port of the reference ``distributed/sharding.py``.  The production mesh
is ``(data=16, model=16)`` single-pod or ``(pod=2, data=16, model=16)``
multi-pod (``launch/mesh.py``).  Logical rules:

    embed / batch      -> FSDP over (pod, data)
    mlp / heads / kv /
    vocab / experts    -> TP / EP over model
    cache_seq          -> model (flash-decoding: split KV + LSE combine)
    layers             -> never sharded (the layer loop's dim)

Every mapping is checked for divisibility against the mesh — a dim that
does not divide falls back to replication (e.g. whisper's 51865 vocab),
and a mesh axis is used at most once per tensor (first dim wins; e.g.
MoE weights [E, d, ff] keep E->model and drop ff->model).

Attention-activation policy: head-count TP when ``n_heads % model == 0``;
otherwise the attention core stays replicated over ``model``.

Specs (``spec_for``, ``activation_hints``, ``batch_shardings``) need no
devices: a mesh is anything with ``axis_names`` and an ordered ``shape``
mapping, as in the reference.  ``P`` is a tuple, so a spec compares
with the reference's ``PartitionSpec`` as ``tuple(a) == tuple(b)``.

The layout (``NamedSharding``, ``ShardedTensor``) is the port's own: the
reference hands it to GSPMD, here it is held explicitly.  A mesh
(``launch/mesh.py``'s ``Mesh``) holds an array of ``torch.device``s,
which may repeat one device (``[cuda:0] * 8``, ``[cpu] * 8``).  A spec
cuts a tensor into a grid of blocks: dim ``i`` splits over the product
of its mesh axes' sizes, indexed row-major over those axes.  Mesh
devices whose coordinates agree on those axes hold copies of the same
block; a copy is held once per physical device.  ``place`` keeps one
master block per grid index (on the first device in mesh order that
holds it) as a leaf tensor of its own, so AdamW may write it in place;
every other copy is derived from the master where it is read
(``blocks``, ``piece``), so the copies can never drift, and autograd
sums the gradients of a master's copies into it.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.launch import hlo_analysis as _ha

# logical axis -> mesh axis group (tuples = composite FSDP axis)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("pod", "data"),
    "batch": ("pod", "data"),
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "heads3": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "cache_seq": ("model",),
    "layers": (),
}


def _norm_entry(e):
    """A spec entry as the reference's ``PartitionSpec`` holds it: a
    one-name group is the name, an empty one ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: one entry per leading dim — ``None``
    (replicated), a mesh axis name, or a tuple of names (split over
    their product, row-major) — trailing ``None``s optional.  Entries
    are normalized as the reference's ``PartitionSpec`` normalizes them
    (``("data",)`` is ``"data"``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm_entry(e) for e in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _present_axes(group: tuple[str, ...], mesh) -> tuple[str, ...]:
    return tuple(a for a in group if a in mesh.axis_names)


def _group_size(group: tuple[str, ...], mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in group], initial=1))


def spec_for(shape: tuple[int, ...], axes: tuple[str | None, ...],
             mesh, rules: dict | None = None) -> P:
    """Partition spec for one tensor. Divisibility + axis-reuse checked."""
    rules = rules or DEFAULT_RULES
    used: set[str] = set()
    parts = []
    for dim, ax in zip(shape, axes):
        entry: tuple[str, ...] | None = None
        composite = False
        if ax is not None and ax in rules:
            # composite rules (FSDP over (pod, data)) keep tuple form even
            # when the mesh only has one of the axes, so specs compare
            # equal across single- and multi-pod meshes
            composite = len(rules[ax]) > 1
            group = _present_axes(rules[ax], mesh)
            if group and not (set(group) & used):
                size = _group_size(group, mesh)
                if size > 1 and dim % size == 0:
                    entry = group
                    used.update(group)
        parts.append(entry if entry is None or composite
                     else entry[0])
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _is_leaf_spec(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "init")


def _spec_map(fn, tree):
    from repro_torch.models.params import tree_map
    return tree_map(fn, tree, is_leaf=_is_leaf_spec)


def shardings_for(spec_tree, mesh, rules: dict | None = None):
    """Tree of ``NamedSharding`` matching a ``LeafSpec`` tree."""
    return _spec_map(lambda s: NamedSharding(
        mesh, spec_for(s.shape, s.axes, mesh, rules)), spec_tree)


def sharded_abstract(spec_tree, mesh, rules: dict | None = None):
    """The dry run's stand-ins: each leaf a ``(meta tensor, NamedSharding)``
    pair — the reference's ``ShapeDtypeStruct`` with ``.sharding`` set.
    The meta tensor has the leaf's global shape and dtype and allocates
    nothing."""
    from repro_torch.models.params import DTYPES
    return _spec_map(lambda s: (
        torch.empty(s.shape, dtype=DTYPES[s.dtype], device="meta"),
        NamedSharding(mesh, spec_for(s.shape, s.axes, mesh, rules))),
        spec_tree)


# ---------------------------------------------------------------------------
# Activation hints


def _dp(mesh, batch: int) -> tuple[str, ...] | None:
    group = _present_axes(("pod", "data"), mesh)
    size = _group_size(group, mesh)
    if group and size > 1 and batch % size == 0:
        return group
    # try data alone (multi-pod with small batch)
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0 \
            and mesh.shape["data"] > 1:
        return ("data",)
    return None


def activation_hints(cfg, mesh, batch: int, kind: str = "train",
                     rules: dict | None = None):
    """The layout of the model's named activations, and the mesh the
    sharded forms run on (``models.layers.Hints``).

    kind: train | prefill (sequence form) or decode (one-token form).
    """
    from repro_torch.models.layers import Hints
    if mesh is None:
        return Hints()
    dp = _dp(mesh, batch)
    ms = mesh.shape.get("model", 1)
    head_tp = ms > 1 and cfg.q_heads() % ms == 0
    specs: dict[str, P] = {}
    if kind in ("train", "prefill"):
        sp = "model" if (cfg.seq_parallel and ms > 1) else None
        specs["residual"] = P(dp, sp, None)
        specs["attn_qflat"] = P(dp, None, "model")
        specs["attn_kvflat"] = P(dp, None, "model")
        if head_tp:
            specs["attn_q"] = P(dp, None, "model", None)
            specs["attn_out"] = P(dp, None, "model", None)
            if ms > 1 and cfg.n_kv_heads % ms == 0:
                specs["attn_kv"] = P(dp, None, "model", None)
            else:
                specs["attn_kv"] = P(dp, None, None, None)
        else:
            specs["attn_q"] = P(dp, None, None, None)
            specs["attn_kv"] = P(dp, None, None, None)
            specs["attn_out"] = P(dp, None, None, None)
        specs["mlp_hidden"] = P(dp, None, "model")
        specs["logits"] = P(dp, None, "model")
        specs["moe_buffer"] = P("model", None, None)
        specs["moe_hidden"] = P("model", None, None)
        specs["ssm_heads"] = P(dp, None, "model", None)
    else:  # decode: [B, 1, ...] activations
        specs["residual"] = P(dp, None, None)
        specs["attn_qflat"] = P(dp, None, "model")
        specs["attn_kvflat"] = P(dp, None, "model")
        specs["mlp_hidden"] = P(dp, None, "model")
        specs["moe_buffer"] = P("model", None, None)
        specs["moe_hidden"] = P("model", None, None)
    return Hints(specs=specs, mesh=mesh, kind=kind)


def cache_leaf_spec(leaf, mesh, dp) -> P:
    """The layout the mesh forms give a decode-cache leaf (a ``LeafSpec``
    whose dims are ``[layers,] batch, ...``): ``spec_for``'s, with the
    batch over ``dp`` (the activations' data axes, ``Hints.dp``)."""
    lead = 1 if leaf.axes[0] == "layers" else 0
    rest = tuple(spec_for(leaf.shape, leaf.axes, mesh))[lead + 1:]
    return P(*([None] * lead), dp, *rest)


def batch_shardings(input_tree, mesh, batch: int):
    """NamedShardings for a train/serve input batch: dim 0 = batch -> DP."""
    from repro_torch.models.params import tree_map
    dp = _dp(mesh, batch)

    def one(x):
        nd = len(x.shape)
        return NamedSharding(mesh, P(dp, *([None] * (nd - 1))))
    return tree_map(one, input_tree)


# ---------------------------------------------------------------------------
# The layout


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec over a mesh with devices: the blocks of a tensor and where
    each is held (module docstring)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self) -> int:
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    # -- geometry -----------------------------------------------------------
    def _groups(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec!r} has more entries than a "
                             f"{ndim}-d tensor")
        return [_entry_axes(self.spec[i] if i < len(self.spec) else None)
                for i in range(ndim)]

    def grid(self, ndim: int) -> tuple[int, ...]:
        """How many blocks each of the ``ndim`` dims splits into."""
        return tuple(_group_size(g, self.mesh) for g in self._groups(ndim))

    def block_shape(self, shape) -> tuple[int, ...]:
        out = []
        for n, g in zip(shape, self.grid(len(shape))):
            if n % g:
                raise ValueError(f"dim of {n} does not split {g} ways "
                                 f"under {self.spec!r}")
            out.append(n // g)
        return tuple(out)

    def index(self, coord: tuple[int, ...], ndim: int) -> tuple[int, ...]:
        """The grid index of the block a mesh coordinate holds."""
        names = self.mesh.axis_names
        out = []
        for g in self._groups(ndim):
            i = 0
            for a in g:
                i = i * self.mesh.shape[a] + coord[names.index(a)]
            out.append(i)
        return tuple(out)

    def _holders(self, ndim: int):
        """(mesh coordinate, device, flat grid index) in mesh order."""
        grid = self.grid(ndim)
        devs = self.mesh.devices
        for coord in np.ndindex(devs.shape):
            k = int(np.ravel_multi_index(self.index(coord, ndim), grid)) \
                if grid else 0
            yield coord, devs[coord], k

    def block_bytes(self, shape, itemsize: int) -> int:
        """Bytes of one block: what each mesh device holds of the tensor."""
        return math.prod(self.block_shape(shape)) * itemsize

    def device_bytes(self, shape, itemsize: int) -> dict:
        """{physical device: bytes it holds}: each block it holds counted
        once, however many of its mesh devices hold that block."""
        held: dict = {}
        for _, dev, k in self._holders(len(shape)):
            held.setdefault(dev, set()).add(k)
        b = self.block_bytes(shape, itemsize)
        return {dev: len(ks) * b for dev, ks in held.items()}

    # -- placement ------------------------------------------------------------
    @torch.no_grad()
    def place(self, x: torch.Tensor) -> "ShardedTensor":
        """``x`` laid out: one master block per grid index, a fresh
        contiguous leaf tensor on the first device that holds it."""
        grid = self.grid(x.ndim)
        bs = self.block_shape(x.shape)
        masters: list = [None] * math.prod(grid)
        for _, dev, k in self._holders(x.ndim):
            if masters[k] is None:
                g = np.unravel_index(k, grid) if grid else ()
                region = tuple(slice(i * b, (i + 1) * b)
                               for i, b in zip(g, bs))
                masters[k] = torch.empty(bs, dtype=x.dtype,
                                         device=dev).copy_(x[region])
        return ShardedTensor(self, x.shape, masters)

    def layout(self, shape, fetch) -> "ShardedTensor":
        """A tensor of ``shape`` laid out from its blocks:
        ``fetch(device, ranges)`` gives the master block of each grid
        index on the first device that holds it, ``ranges`` one (lo, hi)
        per dim."""
        grid = self.grid(len(shape))
        bs = self.block_shape(shape)
        masters: list = [None] * math.prod(grid)
        for _, dev, k in self._holders(len(shape)):
            if masters[k] is None:
                g = np.unravel_index(k, grid) if grid else ()
                masters[k] = fetch(dev, [(int(i) * b, (int(i) + 1) * b)
                                         for i, b in zip(g, bs)])
        return ShardedTensor(self, shape, masters)

    def shard(self, x: torch.Tensor) -> list:
        """The per-device blocks of ``x``, in mesh order, each on its
        device; copies of one block on one physical device are one
        tensor."""
        return self.place(x).blocks()

    def gather(self, blocks, device) -> torch.Tensor:
        """The whole tensor on ``device`` from its blocks (a
        ``ShardedTensor``, or ``shard``'s per-device list), through
        differentiable copies and concatenations: gradients reach the
        blocks through autograd."""
        if not isinstance(blocks, ShardedTensor):
            blocks = self._from_device_list(blocks)
        return blocks.gather(device)

    def _from_device_list(self, blocks: list) -> "ShardedTensor":
        first = blocks[0]
        ndim = first.ndim
        grid = self.grid(ndim)
        masters: list = [None] * math.prod(grid)
        for (_, _, k), b in zip(self._holders(ndim), blocks):
            if masters[k] is None:
                masters[k] = b
        shape = tuple(n * g for n, g in zip(first.shape, grid))
        return ShardedTensor(self, shape, masters)


class ShardedTensor(list):
    """A tensor held as blocks under a ``NamedSharding``: a list of the
    master blocks in row-major grid order, with the global ``shape``.

    Being a list, the port's tree helpers (``models/params.py``) reach
    the masters as leaves, so autograd, ``init_opt_state`` and AdamW's
    in-place update work on the blocks; ``tree_map`` keeps the layout
    (``_tree_new``)."""

    def __init__(self, sharding: NamedSharding, shape, blocks):
        super().__init__(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)

    def _tree_new(self, blocks) -> "ShardedTensor":
        return ShardedTensor(self.sharding, self.shape, list(blocks))

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.sharding!r}, "
                f"{len(self)} blocks)")

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def blocks(self) -> list:
        """The per-device blocks in mesh order: the master where the
        device is the master's, else a copy derived from it (one per
        physical device)."""
        out, copies = [], {}
        for _, dev, k in self.sharding._holders(self.ndim):
            m = self[k]
            if m.device == dev:
                out.append(m)
            else:
                if (k, dev) not in copies:
                    copies[(k, dev)] = m.to(dev)
                out.append(copies[(k, dev)])
        return out

    def gather(self, device) -> torch.Tensor:
        return self.piece(device, tuple((0, n) for n in self.shape))

    def rows(self, lo: int, hi: int) -> "ShardedTensor":
        """Rows ``lo:hi`` of the global tensor under the same layout, each
        block assembled on its master's device (``piece``)."""
        return self.sharding.layout(
            (hi - lo, *self.shape[1:]),
            lambda dev, r: self.piece(dev, [(lo + r[0][0], lo + r[0][1]),
                                            *r[1:]]))

    def piece(self, device, ranges) -> torch.Tensor:
        """``x[lo0:hi0, lo1:hi1, ...]`` of the global tensor on
        ``device``, ``ranges`` one ``(lo, hi)`` per leading dim (the rest
        whole), assembled from the masters it meets (a master's whole
        block as it is, a part of one as a view); differentiable."""
        ranges = list(ranges) + [(0, n) for n in self.shape[len(ranges):]]
        if any(hi <= lo for lo, hi in ranges):   # e.g. a device's rows of
            return self[0].new_empty(            # heads it has none of
                [max(0, hi - lo) for lo, hi in ranges], device=device)
        grid = self.sharding.grid(self.ndim)
        bs = self.sharding.block_shape(self.shape)
        per_dim = [[(i, max(lo, i * b) - i * b, min(hi, (i + 1) * b) - i * b)
                    for i in range(lo // b, (hi - 1) // b + 1)]
                   for (lo, hi), b in zip(ranges, bs)]
        strides = [math.prod(grid[d + 1:]) for d in range(self.ndim)]

        def block(parts):
            m = self[sum(i * st for (i, _, _), st in zip(parts, strides))]
            for d, (_, a, z) in enumerate(parts):
                if a or z != bs[d]:
                    m = m.narrow(d, a, z - a)
            return m

        def build(d, parts):
            if d == self.ndim:
                return block(parts).to(device)
            xs = [build(d + 1, parts + [p]) for p in per_dim[d]]
            return xs[0] if len(xs) == 1 else torch.cat(xs, d)
        if _ha.ACTIVE is None:
            return build(0, [])
        device = torch.device(device)
        remote, sources = 0, []
        for parts in itertools.product(*per_dim):
            m = self[sum(i * st for (i, _, _), st in zip(parts, strides))]
            if m.device != device:
                remote += math.prod(z - a for _, a, z in parts) \
                    * m.element_size()
                sources.append(m.device)
        if not remote:
            return build(0, [])
        # announced as an all-gather of the bytes other devices hold
        out = _ha.ACTIVE.quiet(lambda: build(0, []))
        _ha.ACTIVE.fetch("all-gather", device, sources, remote)
        return out


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def piece(x, device, ranges) -> torch.Tensor:
    """``x[ranges]`` on ``device``, for a ``ShardedTensor`` or a plain
    tensor alike (``ShardedTensor.piece``)."""
    if isinstance(x, ShardedTensor):
        return x.piece(device, ranges)
    return x[tuple(slice(lo, hi) for lo, hi in ranges)].to(device)


def whole(x, device) -> torch.Tensor:
    """All of ``x`` on ``device`` (gathered if it is sharded)."""
    if isinstance(x, ShardedTensor):
        return x.gather(device)
    return x.to(device)


def compute_grid(mesh, dp: tuple[str, ...] | None) -> np.ndarray:
    """The devices the sharded forms compute on, ``[R, M]``: row ``r``
    is the ``r``-th block of the batch (row-major over the ``dp`` axes),
    column ``j`` the ``j``-th index of ``model``; every other mesh axis
    at 0 (its devices would repeat the same work)."""
    names = mesh.axis_names
    dp = tuple(dp or ())
    dims = [mesh.shape[a] for a in dp]
    R = int(np.prod(dims, initial=1))
    M = mesh.shape.get("model", 1)
    out = np.empty((R, M), dtype=object)
    for r in range(R):
        coord = [0] * len(names)
        for a, c in zip(dp, np.unravel_index(r, dims) if dp else ()):
            coord[names.index(a)] = int(c)
        for j in range(M):
            if "model" in names:
                coord[names.index("model")] = j
            out[r, j] = mesh.devices[tuple(coord)]
    return out


# ---------------------------------------------------------------------------
# Fact-table sharding (EngineConfig(shards=N))

FACT_AXIS = "shards"


def device_list(n: int, devices: Sequence | None = None,
                who: str = "fact_devices") -> list[torch.device]:
    """``n`` devices: an explicit list (which may repeat a device), or
    ``n`` distinct CUDA devices; too few raise instead of silently
    folding into a degenerate layout."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        devs = [torch.device("cuda", 0) if d.type == "cuda" and d.index
                is None else d for d in devs]
        if len(devs) != n:
            raise ValueError(f"{who}({n}) got {len(devs)} devices")
        return devs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"{who}({n}) needs {n} CUDA devices but torch sees {have}; "
            "pass an explicit device list to share one")
    return [torch.device("cuda", i) for i in range(n)]


def fact_devices(n_shards: int, devices: Sequence | None = None
                 ) -> list[torch.device]:
    """One device per shard of a hash-partitioned fact table.

    Each device owns the facts whose rank-1 key hashes to its index —
    the device generalization of the paper's derivation-tree parallel
    index writes (each writer owns a memory range).  With ``devices=None``
    the shards take ``n_shards`` distinct CUDA devices, and too few raise
    (as the reference's ``fact_mesh`` does when JAX sees too few
    devices).  An explicit list may repeat a device (``[cuda:0] * 4``,
    ``[cpu] * 8``): several shards then share it, the counterpart of the
    reference's forced host device count on the CPU.
    """
    return device_list(n_shards, devices, "fact_devices")


def fact_frontier_spec(axis: str = FACT_AXIS) -> P:
    """Partition spec of the packed per-shard frontier buffers: one send
    buffer row (``[n_shards * slot_cap]`` lanes) per mesh device."""
    return P(axis)
