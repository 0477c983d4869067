"""Opaque column handles — the device tier of the ``Ops`` interface.

PR 2 made the *inputs* of the bulk primitives device-resident, but every
primitive still materialized its *output* on host, so a multi-condition
island chain round-tripped device→host→device at each join step — exactly
the intermediate-result materialization the paper's island processing is
designed to minimize (§2.3).  A ``DeviceCol`` wraps one backend-resident
int64 column so intermediate join state can flow between primitives
without touching the host:

* ``data``  — the backend array.  ``NumpyOps`` stores a plain numpy array
  (the host twin); ``TorchOps`` stores a device array padded to a
  power-of-two capacity whose **pad lanes are unspecified garbage** —
  every consumer masks by ``n``, never by sentinel value.  That single
  invariant is what lets one handle flow into a join's left side, a
  join's right side, and a sort without re-padding round-trips.
* ``n``     — the real length; ``data[:n]`` is the column.
* ``uid``   — process-unique, never reused.  Handles are immutable, so a
  uid identifies a *value*: device backends memoize derived results
  (joins, dedups, semi-joins) keyed by operand uids, which is how a
  repeated island evaluation at a fixed table version costs zero
  host<->device transfers and zero device work.
* ``lo/hi`` — conservative value bounds (exact at upload, inherited
  through gathers/joins).  Consumers use them for sentinel-collision
  guards and tagged-sort width checks without a device reduction.
* ``_host`` — lazily cached host materialization.  ``host()`` downloads
  once; repeated reads (action batches, decode) are free thereafter.

Handles are created and consumed only through their owning ``Ops``
instance — mixing handles across backends is a programming error.
"""

from __future__ import annotations

import itertools
from typing import Any

import numpy as np

_HANDLE_UID = itertools.count(1)


class DeviceCol:
    """Immutable handle to a backend-resident int64 column (see module
    docstring for the field contracts).

    ``stable`` marks handles that can recur across calls (uploads the
    caller may retain, cache-resident columns, and anything derived from
    only-stable operands).  Handles born from one-shot state — a
    semi-naive delta window, whose watermark never repeats — are
    *transient* (``stable=False``): device backends skip uid-keyed
    memoization for any op touching them, since the memo entry could
    never hit again."""

    __slots__ = ("_data", "n", "uid", "lo", "hi", "owner", "stable",
                 "_host", "codec", "codes", "_thunk")

    def __init__(self, data: Any, n: int, owner, lo: int | None = None,
                 hi: int | None = None,
                 host: np.ndarray | None = None,
                 stable: bool = True, *,
                 codec=None, codes: Any = None, thunk=None) -> None:
        self._data = data
        self.n = int(n)
        self.uid = next(_HANDLE_UID)
        self.lo = lo  # None when unknown/empty: guards treat as "assume worst"
        self.hi = hi
        self.owner = owner
        self.stable = stable
        self._host = host
        # Compressed-resident handles carry the code buffer + codec and
        # defer the value-domain materialization: ``thunk`` is a
        # device-side decode the owner runs at most once, on first
        # ``.data`` access.  Code-domain consumers (shared-dictionary
        # joins, memo hits at a fixed version) never trigger it.
        self.codec = codec
        self.codes = codes
        self._thunk = thunk

    @property
    def data(self):
        if self._data is None and self._thunk is not None:
            self._data = self._thunk()
            self._thunk = None
        return self._data

    def __len__(self) -> int:
        return self.n

    def host(self) -> np.ndarray:
        """Materialize to a host numpy array (cached; device backends
        count the first download in their ``TransferCounter``)."""
        if self._host is None:
            self._host = self.owner.materialize(self)
        return self._host

    def bounds_known(self) -> bool:
        return self.n == 0 or (self.lo is not None and self.hi is not None)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DeviceCol(n={self.n}, uid={self.uid}, "
                f"owner={getattr(self.owner, 'name', '?')})")


def is_handle(x) -> bool:
    return isinstance(x, DeviceCol)


def merge_bounds(*handles: DeviceCol) -> tuple[int | None, int | None]:
    """Conservative union of value bounds over non-empty handles."""
    lo: int | None = None
    hi: int | None = None
    for h in handles:
        if h.n == 0:
            continue
        if h.lo is None or h.hi is None:
            return None, None
        lo = h.lo if lo is None else min(lo, h.lo)
        hi = h.hi if hi is None else max(hi, h.hi)
    return lo, hi
