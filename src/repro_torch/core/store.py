"""Columnar fact store + rank-1 index backends (paper §2.2).

Storage is struct-of-arrays per fact type (strong typing, Def. 1): separate
namespaces avoid cross-type pattern matches and give the derivation-tree
executor disjoint write ranges (paper §2.4 "parallel index write").

Three rank-1 index backends mirror the paper's internal evaluation:

* ``AI``   — 3-level sparse-array index  → sorted-permutation index
             (searchsorted lookups; the TPU-native "tight array" take).
* ``HI``   — hashtable index             → radix-hash bucketized CSR index.
* ``LPIM`` — linked pages + memory pool  → sorted base + unsorted tail with
             page-granular pre-allocation; compaction amortized over pages.
* ``LPID`` — linked pages, dynamic mem   → same, but storage grows exactly
             (realloc per batch, no pool).

All backends expose the same API: exact/estimated ``count`` (the input to
condition cardinality CCar, Def. 6) and ``lookup`` returning row ids.
"""

from __future__ import annotations

import abc
import enum
import itertools

import numpy as np

from repro_torch.backend import Ops, get_backend, splitmix64  # noqa: F401  (re-export)
from repro_torch.core.facts import StringDictionary

PAGE_ROWS = 4096  # paper: pages pre-allocated by a memory pool

# The sharded engine redirects non-home conditions to hash-partitioned
# view tables named "__shard_view:<base type>:<tag>".  The prefix lives
# here (not in core.sharded) so layers below the sharded engine — e.g.
# derivation-tree construction — can recover the base fact type without
# importing the sharding machinery.
VIEW_PREFIX = "__shard_view:"


def base_fact_type(ftype: str) -> str:
    """Base fact type of a (possibly view-tagged) table name."""
    if ftype.startswith(VIEW_PREFIX):
        return ftype[len(VIEW_PREFIX):].split(":", 1)[0]
    return ftype


class Component(enum.IntEnum):
    ID = 0
    ATTR = 1
    VAL = 2


_COMP_NAMES = {Component.ID: "id", Component.ATTR: "attr", Component.VAL: "val"}


class Rank1Index(abc.ABC):
    """Per-fact-type inverted index over the three triple components.

    Index builds are permutation sorts (fork-join instance 4), so they run
    through the execution backend's ``sort_perm`` — stable on every
    backend (the device path tags the bitonic sort's keys with their lane
    index), so permutations are bit-identical across backends.

    Each build passes the owning table's ``(uid, version)`` as a cache
    identity: the device backend keeps the column and its (sorted, perm)
    mirrors resident across calls, uploading only appended tails when
    the version advances (columns are append-only; deletes are tombstones
    that never touch them) and maintaining the sorted mirror by delta-run
    *merge* rather than a full re-sort — so per-append index cost scales
    with the batch, not the table.
    """

    name: str = "?"

    def __init__(self, ops: Ops | None = None) -> None:
        self.ops = ops or get_backend("numpy")

    def _perm_sort(self, col: np.ndarray, table: "TypedFactTable | None" = None,
                   comp: "Component | int | None" = None, variant: str = ""
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(sorted column, permutation) via the backend's stable sort.

        With a table identity the backend keeps the column and its
        (sorted, perm) mirrors device-resident under ``(uid, comp,
        version)`` and *merge-maintains* them across appends: only the
        tail past the resident run is sorted and merged in.  The
        table's tombstone count rides along so heavy delete churn
        triggers the full-rebuild fallback instead of merging around
        dead weight; the alive mask lets full sorts and rebuilds
        *compact* — the mirror drops tombstoned rows instead of
        re-sorting them forever (perm values stay original row ids, so
        lookups see exactly the rows their own alive-filtering would
        keep)."""
        kw = {}
        if table is not None and comp is not None:
            # codec hints for the compressed resident tier: attribute
            # columns are low-cardinality (dictionary), id columns are
            # densely interned ranges (frame of reference); value
            # columns carry packed/float lanes — let the backend scan
            kw = {"cache_key": (table.uid, int(comp), variant),
                  "version": table.version, "n_dead": table.n_dead,
                  "alive": table.alive if table.n_dead else None,
                  "hint": {int(Component.ATTR): "dict",
                           int(Component.ID): "for"}.get(int(comp))}
        skeys, perm = self.ops.sort_perm(col, **kw)
        return skeys.astype(col.dtype, copy=False), perm.astype(np.int32)

    @abc.abstractmethod
    def rebuild(self, table: "TypedFactTable") -> None: ...

    @abc.abstractmethod
    def append(self, table: "TypedFactTable", start: int, stop: int) -> None:
        """Index newly appended rows ``[start, stop)``."""

    @abc.abstractmethod
    def lookup(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        """Exact row ids whose ``comp`` column equals ``value``."""

    @abc.abstractmethod
    def count(self, table: "TypedFactTable", comp: Component, value: int) -> int:
        """(Possibly estimated) cardinality for CCar (Def. 6)."""

    def lookup_batch(self, table: "TypedFactTable", comp: Component,
                     values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Bulk rank-1 probe: row ids for *every* value in one call.

        Returns ``(rows, offsets)`` in CSR form: rows for ``values[i]``
        are ``rows[offsets[i]:offsets[i+1]]``.  Backends with a sorted
        mirror override this with a single batched ``searchsorted``-style
        kernel call (see ``SortedArrayIndex``); the default loops.
        """
        values = np.asarray(values)
        parts = [self.lookup(table, comp, int(v)) for v in values]
        offsets = np.zeros(len(values) + 1, np.int64)
        if parts:
            np.cumsum([len(p) for p in parts], out=offsets[1:])
        rows = (np.concatenate(parts) if parts
                else np.empty(0, np.int32))
        return rows, offsets

    def memory_bytes(self) -> int:
        return 0


class SortedArrayIndex(Rank1Index):
    """``AI``: per component a sorted copy of the column + permutation.

    Lookup = two binary searches + one contiguous slice of the permutation —
    the searchsorted analogue of the paper's 3-level sparse array whose leaf
    is a tight array of matching facts.
    """

    name = "AI"

    def __init__(self, ops: Ops | None = None) -> None:
        super().__init__(ops)
        self._sorted: dict[Component, np.ndarray] = {}
        self._perm: dict[Component, np.ndarray] = {}

    def rebuild(self, table: "TypedFactTable") -> None:
        for comp in Component:
            col = table.column(comp)
            self._sorted[comp], self._perm[comp] = self._perm_sort(
                col, table, comp)

    def append(self, table: "TypedFactTable", start: int, stop: int) -> None:
        # AI has no incremental form in the paper (it is the load-time
        # winner / append-time loser): full per-component re-sort.
        self.rebuild(table)

    def _range(self, comp: Component, value: int) -> tuple[int, int]:
        s = self._sorted.get(comp)
        if s is None or len(s) == 0:
            return 0, 0
        lo = int(np.searchsorted(s, value, side="left"))
        hi = int(np.searchsorted(s, value, side="right"))
        return lo, hi

    def lookup(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        lo, hi = self._range(comp, value)
        return self._perm[comp][lo:hi] if hi > lo else np.empty(0, np.int32)

    def count(self, table: "TypedFactTable", comp: Component, value: int) -> int:
        lo, hi = self._range(comp, value)
        return hi - lo

    def lookup_batch(self, table: "TypedFactTable", comp: Component,
                     values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched probe: all values resolved by one ``batch_probe`` call
        against the index's sorted mirror — on the device backend that is
        a single kernel launch over the *resident* mirror (one upload for
        the probe batch, one download for the run bounds) instead of
        per-probe host bisection."""
        values = np.asarray(values, np.int64)
        s = self._sorted.get(comp)
        if s is None or len(s) == 0 or len(values) == 0:
            return (np.empty(0, np.int32),
                    np.zeros(len(values) + 1, np.int64))
        lo, hi = self.ops.batch_probe(
            s, values, cache_key=(table.uid, int(comp), ""),
            version=table.version)
        counts = hi - lo
        offsets = np.zeros(len(values) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        if total == 0:
            return np.empty(0, np.int32), offsets
        # expand [lo, hi) runs into one gather of the permutation
        probe = np.repeat(np.arange(len(values), dtype=np.int64), counts)
        within = np.arange(total, dtype=np.int64) - offsets[:-1][probe]
        rows = self._perm[comp][lo[probe] + within]
        return rows, offsets

    def memory_bytes(self) -> int:
        return sum(a.nbytes for a in self._sorted.values()) + sum(
            a.nbytes for a in self._perm.values()
        )


class HashIndex(Rank1Index):
    """``HI``: bucketized CSR index.

    The paper's two-level hashtable is pointer-heavy; the TPU-native
    adaptation keeps the *hash* (cheap bucketization) but stores each
    component as rows sorted by bucket id, so a probe is a binary search on
    bucket boundaries + an equality filter over one dense run.
    ``count`` returns the bucket size — an upper-bound estimate (documented
    trade-off: HI trades exact CCar for O(1) maintenance).
    """

    name = "HI"

    def __init__(self, n_buckets: int = 1 << 12, ops: Ops | None = None) -> None:
        super().__init__(ops)
        self.n_buckets = n_buckets
        self._bucket_sorted: dict[Component, np.ndarray] = {}
        self._perm: dict[Component, np.ndarray] = {}

    def _bucket_of(self, values: np.ndarray) -> np.ndarray:
        return (splitmix64(values.astype(np.int64).view(np.uint64)) % np.uint64(self.n_buckets)).astype(np.int64)

    def rebuild(self, table: "TypedFactTable") -> None:
        for comp in Component:
            col = table.column(comp)
            b = self._bucket_of(col)
            # the bucket-id column is a pure elementwise map of an
            # append-only column, so it is append-only too: safe to cache
            # under the same (uid, version) identity, distinct variant
            self._bucket_sorted[comp], self._perm[comp] = self._perm_sort(
                b, table, comp, variant="hash")

    def append(self, table: "TypedFactTable", start: int, stop: int) -> None:
        self.rebuild(table)  # CSR append == rebuild; see LPIM for amortization

    def _probe(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        bs = self._bucket_sorted.get(comp)
        if bs is None or len(bs) == 0:
            return np.empty(0, np.int32)
        b = int(self._bucket_of(np.asarray([value]))[0])
        lo = int(np.searchsorted(bs, b, side="left"))
        hi = int(np.searchsorted(bs, b, side="right"))
        return self._perm[comp][lo:hi]

    def lookup(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        rows = self._probe(table, comp, value)
        if len(rows) == 0:
            return rows
        col = table.column(comp)
        return rows[col[rows] == value]

    def count(self, table: "TypedFactTable", comp: Component, value: int) -> int:
        return len(self._probe(table, comp, value))

    def memory_bytes(self) -> int:
        return sum(a.nbytes for a in self._bucket_sorted.values()) + sum(
            a.nbytes for a in self._perm.values()
        )


class PagedIndex(Rank1Index):
    """``LPIM``/``LPID``: sorted base + unsorted tail, page-granular growth.

    The paper's linked-pages design avoids per-insert dynamic allocation by
    drawing pre-allocated pages from a pool (LPIM) or allocating on demand
    (LPID).  The array analogue: appended rows land in an unsorted *tail*
    (no data movement); once the tail exceeds ``compact_pages`` pages it is
    merged into the sorted base (amortized, page-granular).  Lookups combine
    a binary search over the base with a vectorized filter over the tail.
    """

    def __init__(self, pooled: bool = True, compact_pages: int = 4,
                 ops: Ops | None = None) -> None:
        super().__init__(ops)
        self.pooled = pooled
        self.name = "LPIM" if pooled else "LPID"
        self.compact_rows = compact_pages * PAGE_ROWS
        self._sorted: dict[Component, np.ndarray] = {}
        self._perm: dict[Component, np.ndarray] = {}
        self._base_n = 0
        self._n = 0

    def rebuild(self, table: "TypedFactTable") -> None:
        self._n = table.n
        self._base_n = table.n
        for comp in Component:
            col = table.column(comp)
            self._sorted[comp], self._perm[comp] = self._perm_sort(
                col, table, comp)

    def append(self, table: "TypedFactTable", start: int, stop: int) -> None:
        self._n = stop
        if self._n - self._base_n >= self.compact_rows or not self.pooled:
            # LPID compacts eagerly (dynamic memory, no pool to hide in);
            # LPIM defers until a pool page's worth of tail accumulated.
            self.rebuild(table)

    def _tail_rows(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        if self._n <= self._base_n:
            return np.empty(0, np.int32)
        tail = table.column(comp)[self._base_n : self._n]
        hit = np.nonzero(tail == value)[0].astype(np.int32)
        return hit + np.int32(self._base_n)

    def _base_range(self, comp: Component, value: int) -> tuple[int, int]:
        s = self._sorted.get(comp)
        if s is None or len(s) == 0:
            return 0, 0
        lo = int(np.searchsorted(s, value, side="left"))
        hi = int(np.searchsorted(s, value, side="right"))
        return lo, hi

    def lookup(self, table: "TypedFactTable", comp: Component, value: int) -> np.ndarray:
        lo, hi = self._base_range(comp, value)
        base = self._perm[comp][lo:hi] if hi > lo else np.empty(0, np.int32)
        tail = self._tail_rows(table, comp, value)
        return base if len(tail) == 0 else np.concatenate([base, tail])

    def count(self, table: "TypedFactTable", comp: Component, value: int) -> int:
        lo, hi = self._base_range(comp, value)
        return (hi - lo) + len(self._tail_rows(table, comp, value))

    def memory_bytes(self) -> int:
        return sum(a.nbytes for a in self._sorted.values()) + sum(
            a.nbytes for a in self._perm.values()
        )


INDEX_BACKENDS = {
    "AI": lambda ops=None: SortedArrayIndex(ops=ops),
    "HI": lambda ops=None: HashIndex(ops=ops),
    "LPIM": lambda ops=None: PagedIndex(pooled=True, ops=ops),
    "LPID": lambda ops=None: PagedIndex(pooled=False, ops=ops),
}


_TABLE_UID = itertools.count()


class TypedFactTable:
    """Append-only columnar table for one fact type + its rank-1 index.

    Deletions (paper actions ``delete``/``replace``) are tombstones in the
    ``alive`` column; lookups filter them out lazily.
    Capacity grows in page units (memory-pool discipline) so appends never
    reallocate per-row.

    ``version`` counts *column* mutations: it bumps on every append batch
    and is the invalidation token for device-resident index state (the
    engine's per-type counters advance in lock-step on writes).  Deletes
    are tombstones — columns are untouched, so the version (and any
    resident device copy of the columns) stays valid.  ``uid`` is a
    process-unique id namespacing cache keys across tables and engines.

    Signed-frontier state (counting-based incremental deletion):

    * ``support`` — per-row derivation count: how many rule derivations
      currently conclude this fact.  Maintained exactly by the counting
      engine (``eval_mode="delta"``/``"auto"``); full mode leaves it 0.
    * ``asserted`` — the row was explicitly inserted (a base fact), as
      opposed to concluded by a rule.  A fact dies only when it is not
      asserted *and* its support is 0.
    * ``dellog`` — exact, duplicate-free, append-only log of row ids
      that died, in death order.  ``(n, dellog_n)`` is a signed
      watermark: rows ``[n0, n)`` are the +frontier, ``dellog[d0:d1]``
      the −frontier.  A row appended then deleted inside one window
      appears in both and cancels (the +frontier is alive-filtered, and
      every dead row ``>= n0`` must have died inside the window).
    """

    __slots__ = ("ftype", "n", "_cap", "_id", "_attr", "_val", "_valtype",
                 "_alive", "_support", "_asserted", "index", "_key_set",
                 "version", "uid", "data_version", "n_dead",
                 "_dellog", "dellog_n")

    def __init__(self, ftype: str, index_backend: str = "AI",
                 ops: Ops | None = None) -> None:
        self.ftype = ftype
        self.n = 0
        self.version = 0
        # ``version`` tracks column appends only (deletes are tombstones
        # that leave columns — and any device-resident copy — valid);
        # ``data_version`` additionally bumps on deletes, so it is the
        # invalidation token for anything derived from *visible* rows
        # (e.g. the device pipeline's cached condition binding columns).
        self.data_version = 0
        self.n_dead = 0
        self.uid = next(_TABLE_UID)
        self._cap = PAGE_ROWS
        self._id = np.empty(self._cap, np.int32)
        self._attr = np.empty(self._cap, np.int32)
        self._val = np.empty(self._cap, np.int64)
        self._valtype = np.empty(self._cap, np.int8)
        self._alive = np.empty(self._cap, bool)
        self._support = np.empty(self._cap, np.int32)
        self._asserted = np.empty(self._cap, bool)
        self._dellog = np.empty(PAGE_ROWS, np.int32)
        self.dellog_n = 0
        self.index: Rank1Index = INDEX_BACKENDS[index_backend](ops=ops)
        # Host-side exact-membership map key -> alive row id, for
        # incremental dedup (HU path), idempotent inserts, and in-place
        # assertion/support maintenance on duplicate hits; the SU path
        # dedups in bulk before reaching here.
        self._key_set: dict[tuple[int, int, int], int] = {}

    # -- columns ----------------------------------------------------------
    def column(self, comp: Component) -> np.ndarray:
        if comp == Component.ID:
            return self._id[: self.n]
        if comp == Component.ATTR:
            return self._attr[: self.n]
        return self._val[: self.n]

    @property
    def ids(self) -> np.ndarray:
        return self._id[: self.n]

    @property
    def attrs(self) -> np.ndarray:
        return self._attr[: self.n]

    @property
    def vals(self) -> np.ndarray:
        return self._val[: self.n]

    @property
    def valtypes(self) -> np.ndarray:
        return self._valtype[: self.n]

    @property
    def alive(self) -> np.ndarray:
        return self._alive[: self.n]

    @property
    def support(self) -> np.ndarray:
        return self._support[: self.n]

    @property
    def asserted(self) -> np.ndarray:
        return self._asserted[: self.n]

    @property
    def dellog(self) -> np.ndarray:
        """Row ids that died, in death order (exact, duplicate-free)."""
        return self._dellog[: self.dellog_n]

    def _grow_to(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = self._cap
        while new_cap < need:
            new_cap = new_cap * 2 if new_cap >= PAGE_ROWS else PAGE_ROWS
        # round up to whole pages (pool discipline)
        new_cap = ((new_cap + PAGE_ROWS - 1) // PAGE_ROWS) * PAGE_ROWS
        for name in ("_id", "_attr", "_val", "_valtype", "_alive",
                     "_support", "_asserted"):
            old = getattr(self, name)
            new = np.empty(new_cap, old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)
        self._cap = new_cap

    # -- mutation ---------------------------------------------------------
    def insert(
        self,
        ids: np.ndarray,
        attrs: np.ndarray,
        vals: np.ndarray,
        valtypes: np.ndarray,
        dedup: bool = True,
        asserted: bool = True,
    ) -> int:
        """Append a batch; returns number of *new* facts inserted.

        ``asserted=False`` marks rule-concluded rows: they are born with
        support 0 (the counting write path adds the derivation counts
        right after) and die when their support returns to 0."""
        ids = np.asarray(ids, np.int32)
        attrs = np.asarray(attrs, np.int32)
        vals = np.asarray(vals, np.int64)
        valtypes = np.asarray(valtypes, np.int8)
        ks = self._key_set
        if dedup:
            keep_l = []
            dup_rows: list[int] = []
            j = self.n
            for k in zip(ids.tolist(), attrs.tolist(), vals.tolist()):
                r = ks.get(k)
                if r is not None:
                    keep_l.append(False)
                    dup_rows.append(r)
                else:
                    ks[k] = j
                    j += 1
                    keep_l.append(True)
            keep = np.asarray(keep_l, bool)
            if asserted and dup_rows:
                # re-asserting facts that already exist (possibly as
                # derived rows): pin them so support collapse alone
                # cannot kill them.  Batch-internal duplicates point at
                # pending rows (>= n) that insert with the right flag.
                dr = np.asarray(dup_rows, np.int64)
                dr = dr[dr < self.n]
                if len(dr):
                    self.mark_asserted(dr)
            if not keep.all():
                ids, attrs, vals, valtypes = (
                    ids[keep], attrs[keep], vals[keep], valtypes[keep])
        else:
            base = self.n
            for j, k in enumerate(zip(ids.tolist(), attrs.tolist(),
                                      vals.tolist())):
                ks[k] = base + j
        m = len(ids)
        if m == 0:
            return 0
        start = self.n
        self._grow_to(start + m)
        self._id[start : start + m] = ids
        self._attr[start : start + m] = attrs
        self._val[start : start + m] = vals
        self._valtype[start : start + m] = valtypes
        self._alive[start : start + m] = True
        self._support[start : start + m] = 0
        self._asserted[start : start + m] = asserted
        self.n = start + m
        self.version += 1  # before the index build: it caches under the
        self.data_version += 1
        self.index.append(self, start, self.n)  # post-append version
        return m

    def contains(self, iid: int, attr: int, val: int) -> bool:
        return (int(iid), int(attr), int(val)) in self._key_set

    def delete_rows(self, rows: np.ndarray) -> np.ndarray:
        """Tombstone ``rows``; returns the rows that actually died.

        Already-dead rows are filtered first, so ``n_dead`` is exact and
        the delete log is duplicate-free — both are load-bearing for the
        signed −frontier (``dellog``) consumed by the counting engine."""
        rows = np.asarray(rows, np.int64)
        if len(rows):
            rows = np.unique(rows)
            a = self._alive[rows]
            if not a.all():
                rows = rows[a]
        if len(rows) == 0:
            return rows.astype(np.int32)
        self._alive[rows] = False
        self._asserted[rows] = False
        self.data_version += 1
        self.n_dead += len(rows)
        self._log_deaths(rows)
        for r in rows:
            self._key_set.pop(
                (int(self._id[r]), int(self._attr[r]), int(self._val[r])),
                None)
        return rows.astype(np.int32)

    def _log_deaths(self, rows: np.ndarray) -> None:
        need = self.dellog_n + len(rows)
        if need > len(self._dellog):
            new_cap = len(self._dellog)
            while new_cap < need:
                new_cap *= 2
            new = np.empty(new_cap, np.int32)
            new[: self.dellog_n] = self._dellog[: self.dellog_n]
            self._dellog = new
        self._dellog[self.dellog_n : need] = rows
        self.dellog_n = need

    # -- counting-based support maintenance -------------------------------
    def add_support(self, rows: np.ndarray, counts: np.ndarray) -> None:
        """Add derivation counts to existing rows (duplicates in ``rows``
        accumulate)."""
        np.add.at(self._support, np.asarray(rows, np.int64),
                  np.asarray(counts, np.int32))

    def mark_asserted(self, rows: np.ndarray) -> None:
        self._asserted[np.asarray(rows, np.int64)] = True

    def retract_support(self, rows: np.ndarray,
                        counts: np.ndarray) -> np.ndarray:
        """Remove derivation counts; rows whose support reaches 0 and are
        not asserted die.  Returns the rows that died (already logged)."""
        rows = np.asarray(rows, np.int64)
        s = self._support[rows] - np.asarray(counts, np.int32)
        np.maximum(s, 0, out=s)  # clamp: stale counts only ever occur in
        self._support[rows] = s  # tainted regions, which scrub anyway
        dying = rows[(s <= 0) & ~self._asserted[rows] & self._alive[rows]]
        return self.delete_rows(dying)

    def retract_asserted(self, rows: np.ndarray) -> tuple[np.ndarray, int]:
        """Explicitly delete (un-assert) rows.  A row with surviving
        derivation support stays alive — a *compensated* delete: the
        visible fact set is unchanged, so ``data_version`` does not move
        and cached query version tokens stay valid.  Returns ``(rows
        that died, number of compensated rows)``."""
        rows = np.asarray(rows, np.int64)
        if len(rows):
            rows = rows[self._alive[rows]]
        self._asserted[rows] = False
        dying = rows[self._support[rows] <= 0]
        comp = len(rows) - len(dying)
        return self.delete_rows(dying), comp

    def scrub_derived(self) -> np.ndarray:
        """DRed over-delete: tombstone every non-asserted row and zero all
        support, so producer rules can rebuild exact counts from scratch.
        Returns the rows that died."""
        rows = np.flatnonzero(self.alive & ~self.asserted)
        dead = self.delete_rows(rows)
        self._support[: self.n] = 0
        return dead

    def filter_alive(self, rows: np.ndarray) -> np.ndarray:
        if self.n == 0 or len(rows) == 0:
            return rows
        a = self._alive[rows]
        return rows if a.all() else rows[a]

    def all_rows(self) -> np.ndarray:
        rows = np.arange(self.n, dtype=np.int32)
        return self.filter_alive(rows)

    def memory_bytes(self) -> int:
        per_row = 4 + 4 + 8 + 1 + 1 + 4 + 1
        return self._cap * per_row + self.index.memory_bytes()


class FactStore:
    """All fact types: {ftype -> TypedFactTable} + the string dictionary."""

    def __init__(self, index_backend: str = "AI",
                 ops: Ops | None = None) -> None:
        self.index_backend = index_backend
        self.ops = ops or get_backend("numpy")
        self.strings = StringDictionary()
        self.tables: dict[str, TypedFactTable] = {}

    def table(self, ftype: str) -> TypedFactTable:
        t = self.tables.get(ftype)
        if t is None:
            t = TypedFactTable(ftype, self.index_backend, ops=self.ops)
            self.tables[ftype] = t
        return t

    def num_facts(self) -> int:
        return sum(int(t.alive.sum()) for t in self.tables.values())

    def lookup_many(self, ftype: str, comp: Component,
                    values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Bulk point lookup: alive row ids for every probe value in CSR
        form — rows for ``values[i]`` are ``rows[offsets[i]:
        offsets[i+1]]``.  Routed through ``Rank1Index.lookup_batch`` →
        ``Ops.batch_probe``: on the torch backends an AI table resolves
        every probe in one kernel launch against the device-resident
        sorted mirror that ``sort_perm`` stashed (and now
        merge-maintains) under the table's ``(uid, comp, version)``
        identity — one upload for the probe batch, one download for the
        run bounds.  Tombstoned rows are filtered and offsets
        re-aligned; an unknown ``ftype`` returns an empty CSR."""
        values = np.asarray(values)
        t = self.tables.get(ftype)
        if t is None:
            return (np.empty(0, np.int32),
                    np.zeros(len(values) + 1, np.int64))
        rows, offsets = t.index.lookup_batch(t, comp, values)
        if len(rows) == 0 or t.n_dead == 0:
            return rows, offsets
        mask = t.alive[rows]
        kept_prefix = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(mask, out=kept_prefix[1:])
        return rows[mask], kept_prefix[offsets]

    def memory_bytes(self) -> int:
        return sum(t.memory_bytes() for t in self.tables.values())
