"""Join-level structures and algorithms (paper §2.3).

* Intermediate join results come in two layouts: columnar ``CR`` (dict of
  tightly packed per-variable columns — compressible, vector friendly) and
  row-major ``RR`` (one ``[rows, vars]`` matrix) — the paper benchmarks both.
* Join algorithms: ``MJ`` (parallel sort-merge join — fork-join instance 2)
  and ``HJ`` (hash join).  TPU adaptation (see DESIGN.md): HJ keeps the hash
  as a *bucketizer* and probes with binary search on the hashed keys —
  pointer-chasing open addressing does not vectorize on TPU.
* ``SU`` unique filter: the paper's parallel sort-merge unique filter —
  lexsort + neighbor compare.

The bulk primitives themselves (merge join, unique filter, semi join) live
in ``repro.backend`` — ``NumpyOps`` holds the host twins that used to be
inline here, ``TorchOps`` routes them through the ``kernels/`` CUDA kernels
(tagged-key stable sorts: sorts and the SU dedup pick the same
representative rows on every backend; only join pair order is
backend-specific).  This module keeps the layout structures (CR/RR
bindings) plus thin module-level delegates so existing callers keep
working; everything that sits on the hot path accepts an ``ops`` argument
for backend dispatch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.backend import DeviceCol, Ops, get_backend, is_handle

_NUMPY_OPS = get_backend("numpy")

# ---------------------------------------------------------------------------
# Pair-producing join cores (module-level delegates onto the numpy backend)


def merge_join_pairs(lkeys: np.ndarray, rkeys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort-merge equi-join: all (li, ri) with lkeys[li] == rkeys[ri]."""
    return _NUMPY_OPS.join_pairs(lkeys, rkeys)


def hash_join_pairs(lkeys: np.ndarray, rkeys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Radix-hash join: bucketize by a 64-bit mix, binary-probe the hashed
    domain, verify exact key equality on the candidates."""
    return _NUMPY_OPS.hash_join_pairs(lkeys, rkeys)


def semi_join_rows(rows_keys: np.ndarray, bound_values: np.ndarray,
                   ops: Ops | None = None) -> np.ndarray:
    """Mask for ``rows_keys`` that appear in ``bound_values`` (AR-mode RNL:
    restrict a lookup to values already bound in the join buffer).
    Empty ``bound_values`` means nothing is bound -> all-False."""
    return (ops or _NUMPY_OPS).semi_join(rows_keys, bound_values)


def unique_rows_sorted(cols: list[np.ndarray],
                       ops: Ops | None = None) -> np.ndarray:
    """SU unique filter: indices selecting one representative of each
    distinct row of ``zip(*cols)`` (stable lexsort + neighbor compare; on
    the device backend the lexsort is a chain of tagged-key bitonic sorts,
    keeping the same first-occurrence representative as numpy)."""
    return (ops or _NUMPY_OPS).dedup_rows(cols)


# ---------------------------------------------------------------------------
# Intermediate join-result layouts (CR vs RR)


class Bindings:
    """Abstract intermediate join result: named variable columns."""

    layout = "?"

    def __init__(self) -> None:
        raise NotImplementedError

    # interface: n, names(), col(name), select(idx), merged(...)


class ColumnarBindings(Bindings):
    """CR: one tight int64 array per variable (paper's winning layout).

    A column is either a host numpy array or an opaque ``DeviceCol``
    handle (the device-pipeline executor builds binding tables whose
    columns live on the accelerator).  ``col()`` materializes a handle to
    host lazily — Python-side consumers (join tests, actions, decoding)
    pay the download only when they actually read, and the handle caches
    it so repeated reads are free.  ``handle()`` returns the device form
    (uploading a host column on demand), which is what the fused join /
    dedup paths consume.
    """

    layout = "CR"

    def __init__(self, cols: dict[str, "np.ndarray | DeviceCol"]) -> None:
        self.cols: dict[str, np.ndarray | DeviceCol] = {}
        self.n = 0
        for k, v in cols.items():
            if is_handle(v):
                self.cols[k] = v
                self.n = v.n
            else:
                v = np.asarray(v, np.int64)
                self.cols[k] = v
                self.n = len(v)

    @staticmethod
    def empty() -> "ColumnarBindings":
        b = ColumnarBindings.__new__(ColumnarBindings)
        b.cols, b.n = {}, 0
        return b

    def names(self) -> list[str]:
        return list(self.cols.keys())

    def col(self, name: str) -> np.ndarray:
        v = self.cols[name]
        return v.host() if is_handle(v) else v

    def handle(self, name: str, ops: Ops) -> DeviceCol:
        v = self.cols[name]
        if is_handle(v):
            return v
        # cache the upload: repeated reads at a fixed version must map to
        # the same uid or the backend's memoization never hits (upload
        # keeps the original array as the host mirror, so .col() stays
        # free)
        h = ops.upload(v)
        self.cols[name] = h
        return h

    def device_backed(self) -> bool:
        return any(is_handle(v) for v in self.cols.values())

    def select(self, idx: np.ndarray) -> "ColumnarBindings":
        idx = np.asarray(idx)
        if len(idx) == 0:  # don't materialize handles to build nothing
            return ColumnarBindings(
                {k: np.empty(0, np.int64) for k in self.cols})
        return ColumnarBindings({k: self.col(k)[idx] for k in self.cols})

    def merged(self, idx_self: np.ndarray, other: "Bindings",
               idx_other: np.ndarray) -> "ColumnarBindings":
        out = {k: self.col(k)[idx_self] for k in self.cols}
        for k in other.names():
            if k not in out:
                out[k] = other.col(k)[idx_other]
        return ColumnarBindings(out)


class RowBindings(Bindings):
    """RR: one ``[rows, vars]`` int64 matrix (the paper's row layout —
    kept for the internal evaluation; loses to CR on vector hardware)."""

    layout = "RR"

    def __init__(self, names: list[str], mat: np.ndarray) -> None:
        self._names = list(names)
        self.mat = np.asarray(mat, np.int64).reshape(-1, max(1, len(self._names)))
        self.n = self.mat.shape[0] if self._names else 0

    @staticmethod
    def from_cols(cols: dict[str, np.ndarray]) -> "RowBindings":
        names = list(cols.keys())
        if not names:
            return RowBindings([], np.empty((0, 1), np.int64))
        mat = np.stack([np.asarray(cols[k], np.int64) for k in names], axis=1)
        return RowBindings(names, mat)

    def names(self) -> list[str]:
        return self._names

    def col(self, name: str) -> np.ndarray:
        return self.mat[:, self._names.index(name)]

    def select(self, idx: np.ndarray) -> "RowBindings":
        return RowBindings(self._names, self.mat[idx])

    def merged(self, idx_self: np.ndarray, other: "Bindings",
               idx_other: np.ndarray) -> "RowBindings":
        names = list(self._names)
        blocks = [self.mat[idx_self]]
        extra = [k for k in other.names() if k not in names]
        if extra:
            blocks.append(np.stack([other.col(k)[idx_other] for k in extra], axis=1))
            names += extra
        return RowBindings(names, np.concatenate(blocks, axis=1) if len(blocks) > 1
                           else blocks[0])


def make_bindings(cols: dict[str, np.ndarray], layout: str) -> Bindings:
    if layout == "RR":
        return RowBindings.from_cols(cols)
    return ColumnarBindings(cols)


def join_bindings(left: Bindings, right: Bindings, keys: list[str],
                  algo: str = "MJ", ops: Ops | None = None) -> Bindings:
    """Equi-join two binding tables on shared variables.

    The first key drives the pair-producing join (dispatched through the
    execution backend); remaining keys are verified on the candidate pairs
    (exact, standard multi-key refinement).
    If there is no shared key the result is the cross product — the island
    planner avoids this unless the rule truly is a cross product.

    When either side carries ``DeviceCol`` columns the join runs through
    the backend's fused ``join_gather_h``: the pair-producing join, the
    multi-key verification, and the payload gathers execute in one
    device program and the merged binding table comes back as handles —
    the ``(li, ri)`` pair arrays are never materialized on host.
    """
    ops = ops or _NUMPY_OPS
    if left.n == 0 or right.n == 0:
        return left.select(np.empty(0, np.int64))
    if (isinstance(left, ColumnarBindings)
            and isinstance(right, ColumnarBindings)
            and (left.device_backed() or right.device_backed())):
        extra = [k for k in right.names() if k not in left.names()]
        lpay = [left.handle(k, ops) for k in left.names()]
        rpay = [right.handle(k, ops) for k in extra]
        if keys:
            lk = left.handle(keys[0], ops)
            rk = right.handle(keys[0], ops)
            verify = [(left.handle(k, ops), right.handle(k, ops))
                      for k in keys[1:]]
            lout, rout, _ = ops.join_gather_h(lk, rk, lpay, rpay,
                                              verify, algo)
        else:
            # keyless join = cross product (a test-bearing rule shape):
            # expanded on device so the chain stays resident
            lout, rout, _ = ops.cross_join_h(lpay, rpay, left.n, right.n)
        cols: dict[str, DeviceCol] = {}
        for name, h in zip(left.names(), lout):
            cols[name] = h
        for name, h in zip(extra, rout):
            cols[name] = h
        return ColumnarBindings(cols)
    if not keys:
        li = np.repeat(np.arange(left.n, dtype=np.int64), right.n)
        ri = np.tile(np.arange(right.n, dtype=np.int64), left.n)
    else:
        li, ri = ops.join(left.col(keys[0]), right.col(keys[0]), algo)
        for k in keys[1:]:
            if len(li) == 0:
                break
            ok = left.col(k)[li] == right.col(k)[ri]
            li, ri = li[ok], ri[ok]
    return left.merged(li, right, ri)


def dedup_bindings(b: Bindings, ops: Ops | None = None) -> Bindings:
    """Project-distinct over all columns (used for final query results)."""
    if b.n == 0:
        return b
    ops = ops or _NUMPY_OPS
    if isinstance(b, ColumnarBindings) and b.device_backed():
        handles = [b.handle(k, ops) for k in b.names()]
        idx, n = ops.dedup_select_h(handles)
        return ColumnarBindings(
            {k: ops.gather_h(h, idx, n)
             for k, h in zip(b.names(), handles)})
    keep = ops.dedup_rows([b.col(k) for k in b.names()])
    return b.select(keep)
