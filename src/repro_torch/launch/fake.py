"""Shape-only tensors on numbered devices: the dry run's abstract values.

The counterpart of the reference's ``jax.ShapeDtypeStruct`` leaves and of
its 512 forced host devices.  A ``ShapeTensor`` has a shape, strides, a
dtype and a device (``dryrun.fake_devices`` in the dry run) and
no data.  Under ``ShapeMode`` every aten op the port's code dispatches
returns ``ShapeTensor``s: factories, products, copies between devices.
Nothing is allocated and nothing is computed.

Why not ``torch._subclasses.fake_tensor.FakeTensorMode``: it keeps the
device index too, but builds its cache key from every argument on each
op, and a full-size cell dispatches tens of millions of ops.
``ShapeMode`` caches each op's output metadata by its inputs' shapes,
strides, dtypes and scalar arguments, and calls the op's meta kernel
only on a miss; a hit costs a dictionary lookup and a wrapper.

Storage is tracked as the dry run's memory model needs it: each new
output gets a ``FakeStore`` (its bytes and device), views and in-place
results share their input's, and a store's bytes stay live on its device
until the last tensor holding it is freed (``MemoryTracker``).

Rules the card would enforce are kept: an op whose tensor operands lie
on two devices raises (a 0-d host tensor excepted, as in torch), and an
op whose result depends on data (``item``, ``nonzero``) raises.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# ops whose answer is a value, not a shape: the dry run cannot give one
_DATA_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero",
                       "equal", "nonzero", "masked_select", "unique_dim",
                       "_unique2", "tolist"})


_COPY_INTO = frozenset({aten.copy_.default, aten._copy_from.default,
                        aten._copy_from_and_resize.default})


class MemoryTracker:
    """Live and peak bytes of ``FakeStore``s by device."""

    def __init__(self):
        self.live: dict = {}
        self.peak: dict = {}

    def alloc(self, dev, n: int) -> None:
        v = self.live.get(dev, 0) + n
        self.live[dev] = v
        if v > self.peak.get(dev, 0):
            self.peak[dev] = v

    def free(self, dev, n: int) -> None:
        self.live[dev] -= n

    def reset_peak(self) -> dict:
        """Start a new peak at what is live now; returns that."""
        self.peak = dict(self.live)
        return dict(self.live)


class FakeStore:
    """The storage of one or more ``ShapeTensor``s (views share it)."""

    __slots__ = ("nbytes", "device", "tracker")

    def __init__(self, nbytes: int, device, tracker):
        self.nbytes = nbytes
        self.device = device
        self.tracker = tracker
        if tracker is not None:
            tracker.alloc(device, nbytes)

    def __del__(self):
        if self.tracker is not None:
            self.tracker.free(self.device, self.nbytes)


class ShapeTensor(torch.Tensor):
    """A tensor with metadata and a device, and no data."""

    _store: FakeStore
    _key: tuple     # (shape, strides, offset, dtype): the cache's key

    @staticmethod
    def __new__(cls, shape, stride, offset, dtype, device, store):
        r = torch.Tensor._make_wrapper_subclass(
            cls, shape, strides=stride, storage_offset=offset, dtype=dtype,
            device=device, requires_grad=False)
        r._store = store
        r._key = (shape, stride, offset, dtype)
        return r

    def __repr__(self, *, tensor_contents=None) -> str:
        return (f"ShapeTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.device})")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a ShapeTensor outside ShapeMode")


def is_fake(t) -> bool:
    """Whether ``t`` holds no data: a ``ShapeTensor``, or a
    ``FakeTensor`` of torch's own fake mode.  A real ``meta`` tensor is
    not fake."""
    if type(t) is torch.Tensor:
        return False
    if isinstance(t, ShapeTensor):
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _storage_bytes(shape, stride, offset, itemsize) -> int:
    if any(n == 0 for n in shape):
        return 0
    return (offset + 1 + sum((n - 1) * s for n, s in zip(shape, stride))) \
        * itemsize


def _scan(xs, ins: list) -> tuple:
    """The metadata cache's key for an argument list (each tensor's shape,
    strides, offset and dtype; devices as a marker; scalars as they are),
    appending its tensors to ``ins`` in order."""
    out = []
    for x in xs:
        t = type(x)
        if t is ShapeTensor:
            ins.append(x)
            out.append(x._key)
        elif t is int or t is bool or x is None:
            out.append(x)
        elif t is float:
            out.append("nan" if x != x else x)
        elif t is list or t is tuple:
            out.append(_scan(x, ins))
        elif isinstance(x, torch.Tensor):
            ins.append(x)
            out.append((tuple(x.shape), x.stride(), x.storage_offset(),
                        x.dtype))
        elif t is torch.device:
            out.append("dev")
        else:
            out.append(x)
    return tuple(out)


def _scan_kw(kwargs: dict, ins: list) -> tuple:
    """``_scan`` of keyword arguments, as (name, key) pairs."""
    out = []
    for k, v in kwargs.items():
        t = type(v)
        if t is ShapeTensor:
            ins.append(v)
            out.append((k, v._key))
        elif t is torch.device:
            out.append((k, "dev"))
        elif t is torch.dtype or t is int or t is bool or v is None:
            out.append((k, v))
        else:
            out.append((k, _scan((v,), ins)))
    return tuple(out)


def _meta_of(t: torch.Tensor) -> torch.Tensor:
    """A real ``meta`` tensor with ``t``'s metadata."""
    shape, stride, off = tuple(t.shape), t.stride(), t.storage_offset()
    n = _storage_bytes(shape, stride, off, 1)
    base = torch.empty(n, dtype=t.dtype, device="meta")
    return base.as_strided(shape, stride, off)


def _to_meta(x, metas: list):
    """``x`` with each tensor replaced by a ``meta`` stand-in (appended to
    ``metas`` in order) and each device by ``meta``."""
    if isinstance(x, torch.Tensor):
        m = _meta_of(x)
        metas.append(m)
        return m
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(y, metas) for y in x)
    if isinstance(x, torch.device):
        return torch.device("meta")
    return x


class ShapeMode(TorchDispatchMode):
    """Every op under this mode returns ``ShapeTensor``s (module
    docstring).  ``tracker``: the ``MemoryTracker`` the new stores
    report to (a fresh one by default)."""

    def __init__(self, tracker: MemoryTracker | None = None):
        super().__init__()
        self.tracker = tracker if tracker is not None else MemoryTracker()
        self._cache: dict = {}
        self.misses = 0
        self.recorder = None   # a Recorder fed each op (Recorder.feeding)

    def _device(self, func, args, kwargs, ins):
        dev = kwargs.get("device")
        if dev is not None:
            return torch.device(dev)
        if func in _COPY_INTO:      # dst.copy_(src): src may lie elsewhere
            return args[0].device
        common = scalar = None
        for t in ins:
            d = t.device
            if t.dim() == 0 and d.type == "cpu" and d.index is None:
                scalar = d      # a host scalar (not a fake cpu:k device)
                continue
            if common is None:
                common = d
            elif d != common:
                raise RuntimeError(
                    f"{func}: expected all tensors to be on the same device, "
                    f"but found at least two devices, {common} and {d}")
        if common is not None:
            return common
        if scalar is not None:
            return scalar
        return torch.device("cpu")

    def wrap(self, t: torch.Tensor, device=None) -> ShapeTensor:
        """A real tensor's metadata as a new ``ShapeTensor`` on ``device``
        (its own by default)."""
        shape, stride, off = tuple(t.shape), t.stride(), t.storage_offset()
        dev = t.device if device is None else torch.device(device)
        store = FakeStore(_storage_bytes(shape, stride, off,
                                         t.dtype.itemsize), dev, self.tracker)
        return ShapeTensor(shape, stride, off, t.dtype, dev, store)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: list = []
        key = (func, _scan(args, ins),
               _scan_kw(kwargs, ins) if kwargs else ())
        entry = self._cache.get(key)
        if entry is None:
            entry = self._special(func, args)
            if entry is not None:
                return entry[1]
            entry = self._cache[key] = self._describe(func, args, kwargs)
            self.misses += 1
        dev = self._device(func, args, kwargs, ins)
        if entry[0] == "one":
            out = self._build(entry[1], ins, dev)
        else:
            out = type(entry[1])(self._build(e, ins, dev) for e in entry[1])
        rec = self.recorder
        if rec is not None and not rec._quiet:
            rec.observe(func, args, kwargs, out)
        return out

    def _special(self, func, args):
        """(True, result) for the ops the cache must not describe."""
        name = func.__name__.split(".")[0]
        if name in _DATA_OPS:
            raise RuntimeError(
                f"{func}: the dry run has no data; this op's result depends "
                "on tensor values")
        if func is torch.ops.prim.device.default:
            return True, args[0].device
        if name in ("lift_fresh", "lift_fresh_copy", "lift"):
            return True, self.wrap(args[0])   # torch.tensor(...)'s tensor
        return None

    def _build(self, e, ins, dev):
        kind = e[0]
        if kind == "value":
            return e[1]
        if kind == "self":
            return ins[e[1]]
        _, src, shape, stride, off, dtype, nbytes = e
        if kind == "view":
            store = getattr(ins[src], "_store", None)
            if store is None or store.device != dev:
                store = FakeStore(nbytes, dev, self.tracker)
        else:
            store = FakeStore(nbytes, dev, self.tracker)
        return ShapeTensor(shape, stride, off, dtype, dev, store)

    def _describe(self, func, args, kwargs):
        if torch.Tag.inplace_view in func.tags:
            raise RuntimeError(f"{func}: an in-place view (it would change "
                               "a ShapeTensor's metadata)")
        metas: list = []
        margs = _to_meta(args, metas)
        mkw = {k: _to_meta(v, metas) for k, v in kwargs.items()}
        out = func(*margs, **mkw)
        if isinstance(out, (tuple, list)):
            return ("many", type(out)(self._entry(o, metas) for o in out))
        return ("one", self._entry(out, metas))

    @staticmethod
    def _entry(o, metas):
        if not isinstance(o, torch.Tensor):
            return ("value", o)
        for i, m in enumerate(metas):
            if o is m:
                return ("self", i)
        meta = (tuple(o.shape), o.stride(), o.storage_offset(), o.dtype,
                o.untyped_storage().nbytes())
        ptr = o.untyped_storage()._cdata
        for i, m in enumerate(metas):
            if m.untyped_storage()._cdata == ptr:
                return ("view", i, *meta)
        return ("new", None, *meta)
