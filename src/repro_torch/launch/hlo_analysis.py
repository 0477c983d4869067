"""Structural analysis of the port's program for the roofline report.

Port of the reference ``launch/hlo_analysis.py``.  The reference parses
XLA's optimized (post-SPMD) HLO text; nothing in the port produces HLO.
The port's per-device program is the sequence of aten ops its own eager
code dispatches on each device of a mesh, so that is what this module
records (``Recorder``, a ``TorchDispatchMode``; the counterpart of
``HloModule``) and analyses (``analyze_trace``, of ``analyze_hlo``):

* **no HLO text parser**: there is no text to parse, the recorder sees
  each op with its shapes, dtypes and device as it is dispatched;
* **no loop multipliers** (``multipliers``/``_trip_count``): eager code
  unrolls every Python loop into the trace, so a body that runs 5 times
  is recorded 5 times;
* **no fusion interiors**: eager PyTorch fuses nothing, so every op is
  top level and its traffic counts;
* **FLOPs**, per device: every product after dispatch (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``convolution``; ``einsum``, ``matmul`` and
  ``linear`` reach these), charged ``2 * prod(result) * prod(contracted
  dims)`` as ``dot_flops``/``conv_flops`` charge them; a hand-written
  kernel's launch is charged by its own formula (``kernel``, announced by
  the wrapper: ``kernels.launched``);
* **memory bytes**, per device: ``_op_traffic``'s model over aten ops
  (``op_traffic``);
* **collectives**: announced by the code that moves data between devices
  (``distributed/spmd.py``, ``ShardedTensor.piece``,
  ``core/distributed.py``'s exchange) with their kind, group and result
  bytes, timed by the ring model below.  Ops inside a collective are not
  counted again.  A cross-device copy outside any collective is reported
  as its own kind, ``copy``.  Ops on devices outside the mesh are counted
  apart (``outside``).

Per-op collective time on a ring of n devices with per-link bandwidth B:
    all-gather / reduce-scatter / all-to-all   t = bytes * (n-1)/n / B
    all-reduce                                 t = 2 * bytes * (n-1)/n / B
    collective-permute                         t = bytes / B
A ``ShardedTensor`` piece records the bytes it fetches from other
devices, which cross a link once (t = bytes / B), and so does a ``copy``.

``ACTIVE`` is the recorder in force, or ``None``: an announcement costs
one module-level ``None`` check when nothing records.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ACTIVE = None   # the Recorder in force

# the torch counterpart of each HLO element type of the reference's
# ``_DTYPE_BYTES``; each one's itemsize is that table's size (the tests
# hold ``shape_bytes`` to the reference's over every torch dtype), so a
# tensor's bytes are its ``nbytes``
HLO_TYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def shape_bytes(dtype: torch.dtype, shape) -> int:
    """Bytes of an array of ``shape`` and ``dtype``."""
    return math.prod(shape) * dtype.itemsize


def ring_factor(kind: str, n: int) -> float:
    """Bytes on the wire per result byte, on a ring of ``n`` devices."""
    f = (n - 1) / n
    return {"all-reduce": 2 * f, "all-gather": f, "reduce-scatter": f,
            "all-to-all": f, "collective-permute": 1.0}[kind]


# -- the traffic model ---------------------------------------------------------

# metadata queries (no op on the card)
_SKIP = frozenset({"device", "sym_size", "sym_stride", "sym_numel",
                   "sym_storage_offset", "dim", "is_contiguous",
                   "is_same_size", "_has_compatible_shallow_copy_type"})
# views and allocations: free, as HLO's bitcast and parameters are
FREE_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute", "t",
    "transpose", "slice", "select", "alias", "as_strided", "detach",
    "squeeze", "unsqueeze", "unbind", "split", "split_with_sizes",
    "diagonal", "unfold", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided"})
# gathers and slices that copy: 2x their result
SLICE_OPS = frozenset({"index", "index_select", "gather", "narrow_copy",
                       "embedding", "slice_copy"})
# in-place updates: 2x the update (the operand at this position)
UPDATE_OPS = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
              "scatter_": 3, "scatter": 3, "scatter_add_": 3,
              "scatter_add": 3, "index_add_": 3, "index_add": 3,
              "copy_": 1, "slice_scatter": 1, "select_scatter": 1,
              "masked_scatter_": 2}
# copies: 2x their result
COPY_OPS = frozenset({"clone", "_to_copy", "copy", "contiguous",
                      "_copy_from"})
PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution",
                      "_convolution", "mv", "addmv", "dot", "addbmm"})


def _first_tensor(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (list, tuple)):
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def product_flops(name: str, args, out) -> float:
    """``2 * prod(result) * prod(contracted dims)`` of one product."""
    if name not in PRODUCTS or not isinstance(out, torch.Tensor):
        return 0.0
    n_out = out.numel()
    if name in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addmv", "addbmm"):
        k = args[1].shape[-1]
    else:                       # convolution(input, weight, ...)
        k = math.prod(args[1].shape[1:])
    return 2.0 * n_out * k


def _sort_traffic(out, dim: int) -> float:
    """Sorts are multi-pass networks: ``log2(n)(log2(n)+1)/2`` read+write
    sweeps, not one.  The reference charges the TPU's sort so; the card's
    sorts are bitonic networks too (``csrc/bitonic_sort.cu``, and torch's
    segmented sort passes over the data several times)."""
    outs = out if isinstance(out, (list, tuple)) else (out,)
    b = sum(t.nbytes for t in outs if isinstance(t, torch.Tensor))
    t0 = outs[0]
    n = t0.shape[dim] if t0.dim() else 1
    lg = max(1, math.ceil(math.log2(max(2, n))))
    return 2.0 * b * lg * (lg + 1) / 2


def _shapes(xs) -> list:
    """(shape, dtype) of each tensor in ``xs`` (lists flattened)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), x.dtype))
        elif type(x) is list or type(x) is tuple:
            out.extend(_shapes(x))
    return out


def _nbytes(xs) -> int:
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.nbytes
        elif type(x) is list or type(x) is tuple:
            n += _nbytes(x)
    return n


def op_traffic(name: str, args, kwargs, out) -> float:
    """Approximate HBM bytes one op moves (the reference's
    ``_op_traffic`` over aten ops): views and allocations are free;
    gathers and copying slices move 2x their result; in-place updates 2x
    the update; copies 2x their result; a sort its network's passes;
    everything else reads its tensor operands and writes its result."""
    if name in FREE_OPS:
        return 0.0
    if name in SLICE_OPS or name in COPY_OPS:
        return 2.0 * _nbytes((out,))
    if name in UPDATE_OPS:
        i = UPDATE_OPS[name]
        upd = args[i] if len(args) > i else None
        if isinstance(upd, (list, tuple)):
            upd = None
        if upd is None:
            upd = kwargs.get("values", kwargs.get("src"))
        return 2.0 * upd.nbytes if isinstance(upd, torch.Tensor) else 0.0
    if name in ("sort", "argsort"):
        dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
            else kwargs.get("dim", -1)
        return _sort_traffic(out, dim)
    n = _nbytes(args) + _nbytes((out,))
    if kwargs:
        n += _nbytes(kwargs.values())
    return float(n)


# -- the recorder -------------------------------------------------------------


class DeviceStats:
    """What one device ran: ops by aten name, product FLOPs, traffic
    bytes, kernel launches by name and their charged work."""

    __slots__ = ("ops", "products", "product_flops", "mem_bytes",
                 "kernels", "kernel_flops", "kernel_bytes")

    def __init__(self):
        self.ops = Counter()
        self.products = Counter()   # FLOPs of one product -> how many
        self.product_flops = 0.0
        self.mem_bytes = 0.0
        self.kernels = Counter()
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0


class Recorder(TorchDispatchMode):
    """Records every dispatched op by the device of its result (the op's
    device), and the collectives and kernel launches the code under it
    announces.

    ``devices``: the mesh's devices (ops elsewhere count in ``outside``;
    ``None``: every device is the mesh's).  ``span``: a function of a
    collective's devices that names the link class it crosses (the dry
    run's ``link_spans``; ``None``: one class).  ``keep``: also keep each
    op as (aten name, device, result shapes and dtypes, operand shapes
    and dtypes) in ``ops`` (the counts above are what a long trace
    needs; a mesh-size trace has millions of ops).
    """

    def __init__(self, devices=None, span=None, keep: bool = False):
        super().__init__()
        self.ops: list | None = [] if keep else None
        self.mesh_devices = None if devices is None else set(
            torch.device(d) for d in devices)
        self.span = span
        self.stats: dict = {}
        self.outside = Counter()
        # (device, kind, span) -> [count, bytes, wire bytes]
        self.coll: dict = {}
        self.backward_copies = 0
        self._quiet = 0
        self._names: dict = {}
        self._prev = None

    def __enter__(self):
        global ACTIVE
        self._prev, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._prev
        return super().__exit__(*exc)

    def device_stats(self, dev) -> DeviceStats:
        st = self.stats.get(dev)
        if st is None:
            st = self.stats[dev] = DeviceStats()
        return st

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self.observe(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def feeding(self, mode):
        """Record the ops of ``mode`` (a ``launch.fake.ShapeMode``, which
        calls ``observe`` itself: one dispatch an op, not two) and take
        the announcements, without entering as a mode of its own."""
        global ACTIVE
        prev, ACTIVE = ACTIVE, self
        mode.recorder = self
        try:
            yield self
        finally:
            mode.recorder = None
            ACTIVE = prev

    def observe(self, func, args, kwargs, out):
        """Count one op (its result ``out``) on its device."""
        name = self._names.get(func)
        if name is None:
            name = self._names[func] = func.__name__.split(".")[0]
        if name in _SKIP:
            return
        t = out if isinstance(out, torch.Tensor) else _first_tensor((out,))
        if t is None:
            t = _first_tensor(args)
            if t is None:
                return
        dev = t.device
        if self.mesh_devices is not None and dev not in self.mesh_devices:
            self.outside[dev] += 1
            return
        st = self.device_stats(dev)
        st.ops[name] += 1
        if self.ops is not None:
            self.ops.append((name, dev, _shapes((out,)), _shapes(args)))
        if name in PRODUCTS:
            f = product_flops(name, args, out)
            st.products[f] += 1
            st.product_flops += f
        st.mem_bytes += op_traffic(name, args, kwargs, out)
        if name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            if isinstance(src, torch.Tensor) and src.device != dev:
                self._add(dev, "copy", src.nbytes, 1.0,
                          (src.device, dev))
                if torch._C._current_autograd_node() is not None:
                    self.backward_copies += 1

    # -- announcements --------------------------------------------------------
    def _add(self, dev, kind: str, nbytes: float, factor: float, group):
        span = self.span(group) if self.span is not None else None
        c = self.coll.get((dev, kind, span))
        if c is None:
            c = self.coll[(dev, kind, span)] = [0, 0.0, 0.0]
        c[0] += 1
        c[1] += nbytes
        c[2] += nbytes * factor

    def quiet(self, fn):
        """``fn()`` with op counting paused (a collective's own work)."""
        self._quiet += 1
        try:
            return fn()
        finally:
            self._quiet -= 1

    def collective(self, kind: str, group, fn, receivers=None,
                   sources=()):
        """Run ``fn()`` -> per-position results along ``group`` (the
        axis's devices, in order) and record ``kind`` on each distinct
        device that receives: ``receivers`` (positions) or every one.
        Nothing is recorded where the group and the inputs' devices
        (``sources``) are one physical device."""
        out = self.quiet(fn)
        devs = list(group)
        distinct = list(dict.fromkeys([*devs, *sources]))
        if len(distinct) < 2:
            return out
        n = len(devs)
        factor = ring_factor(kind, n)
        seen = set()
        for i in (range(n) if receivers is None else receivers):
            d = devs[i]
            if d in seen:
                continue
            seen.add(d)
            self._add(d, kind, out[i].nbytes, factor, distinct)
        return out

    def fetch(self, kind: str, device, sources, nbytes: float):
        """``nbytes`` brought to ``device`` from ``sources`` (other
        devices' blocks), each byte over a link once."""
        group = list(dict.fromkeys([device, *sources]))
        self._add(torch.device(device), kind, nbytes, 1.0, group)

    def kernel(self, names, device, flops: float, nbytes: float):
        """One launch of a hand-written kernel, charged its own work and
        counted under each of ``names`` (its ``kernels.LAUNCHES`` keys)."""
        dev = torch.device(device)
        if self.mesh_devices is not None and dev not in self.mesh_devices:
            self.outside[dev] += 1
            return
        st = self.device_stats(dev)
        for n in names:
            st.kernels[n] += 1
        st.kernel_flops += flops
        st.kernel_bytes += nbytes


def _bw(link_bw, span) -> float:
    if isinstance(link_bw, dict):
        return link_bw[span]
    return float(link_bw)


def analyze_trace(trace: Recorder, link_bw=50e9) -> dict:
    """Per-device figures and their maximum over the mesh's devices (the
    SPMD program's per-device figure), under the reference's keys:
    ``flops_per_device``, ``mem_bytes_per_device``, ``collectives`` (per
    kind: ``count``, ``bytes``, ``time_s``, each the maximum over the
    devices), ``collective_bytes``, ``collective_time_s``; plus
    ``per_device`` (one entry a device, in the mesh's order where known)
    and ``outside`` (op counts on devices outside the mesh).
    ``link_bw``: bytes/s of a link, or {span: bytes/s} for the recorder's
    span classes."""
    devs = list(trace.stats)
    for dev, _, _ in trace.coll:
        if dev not in trace.stats:
            devs.append(dev)
    per: dict = {}
    for d in devs:
        st = trace.stats.get(d, DeviceStats())
        per[d] = {"device": str(d), "ops": sum(st.ops.values()),
                  "product_flops": st.product_flops,
                  "products": {str(int(f)): n for f, n in
                               sorted(st.products.items())},
                  "kernel_flops": st.kernel_flops,
                  "flops": st.product_flops + st.kernel_flops,
                  "mem_bytes": st.mem_bytes + st.kernel_bytes,
                  "kernels": dict(st.kernels),
                  "collectives": {}, "collective_bytes": 0.0,
                  "collective_time_s": 0.0}
    for (d, kind, span), (count, nbytes, wire) in trace.coll.items():
        c = per[d]["collectives"].setdefault(
            kind, {"count": 0, "bytes": 0.0, "time_s": 0.0})
        t = wire / _bw(link_bw, span)
        c["count"] += count
        c["bytes"] += nbytes
        c["time_s"] += t
        per[d]["collective_bytes"] += nbytes
        per[d]["collective_time_s"] += t
    rows = list(per.values())

    def top(key):
        return max((r[key] for r in rows), default=0.0)
    coll: dict = {}
    for r in rows:
        for kind, c in r["collectives"].items():
            m = coll.setdefault(kind, {"count": 0, "bytes": 0.0,
                                       "time_s": 0.0})
            for k in m:
                m[k] = max(m[k], c[k])
    return {
        "flops_per_device": top("flops"),
        "mem_bytes_per_device": top("mem_bytes"),
        "collectives": coll,
        "collective_bytes": top("collective_bytes"),
        "collective_time_s": top("collective_time_s"),
        "per_device": rows,
        "outside": {str(d): n for d, n in trace.outside.items()},
    }
