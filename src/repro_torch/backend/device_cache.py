"""Device residency for the inference hot path (paper §2.2).

The paper's premise is that rank-1 index storage and intermediate join
state live in cache-efficient contiguous structures.  PR 1 put the bulk
primitives on the accelerator but round-tripped every call host→device→
host, so the hottest state — per-fact-type columns, their packed join
keys, and the sorted-permutation indexes — was re-uploaded on every
primitive.  This module provides the two pieces that close that gap:

* ``TransferCounter`` — counts host→device / device→host transfers (calls
  and bytes).  Every conversion in ``TorchOps`` goes through it, so "zero
  intermediate transfers" is measurable, not aspirational.

* ``DeviceArrayCache`` — a small, thread-safe, LRU, *version-keyed* cache
  for device-resident values.  Keys are arbitrary hashables (the engine
  uses ``("col", ftype, component)``-style tuples); every entry carries
  the fact-table version it was built from.  A ``get`` with a stale
  version misses (the caller rebuilds, typically by uploading only the
  appended tail — fact-table columns are append-only), and ``put``
  replaces the stale entry.  Versions come from the engine's existing
  per-type counters, which is what makes invalidation exact rather than
  heuristic.

Capacity is bounded in bytes (default 256 MiB) so long-running engines
with many fact types cannot pin unbounded device memory; eviction is LRU.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Hashable


@dataclasses.dataclass
class TransferCounter:
    """Host<->device transfer accounting for one ``Ops`` instance."""

    h2d_calls: int = 0
    h2d_bytes: int = 0
    d2h_calls: int = 0
    d2h_bytes: int = 0

    def count_h2d(self, nbytes: int) -> None:
        self.h2d_calls += 1
        self.h2d_bytes += int(nbytes)

    def count_d2h(self, nbytes: int) -> None:
        self.d2h_calls += 1
        self.d2h_bytes += int(nbytes)

    def snapshot(self) -> "TransferCounter":
        return TransferCounter(self.h2d_calls, self.h2d_bytes,
                               self.d2h_calls, self.d2h_bytes)

    def delta(self, since: "TransferCounter") -> "TransferCounter":
        return TransferCounter(
            self.h2d_calls - since.h2d_calls,
            self.h2d_bytes - since.h2d_bytes,
            self.d2h_calls - since.d2h_calls,
            self.d2h_bytes - since.d2h_bytes)

    def reset(self) -> None:
        self.h2d_calls = self.h2d_bytes = 0
        self.d2h_calls = self.d2h_bytes = 0

    def __repr__(self) -> str:  # compact: shows up in bench reports
        return (f"TransferCounter(h2d={self.h2d_calls}x/{self.h2d_bytes}B, "
                f"d2h={self.d2h_calls}x/{self.d2h_bytes}B)")


@dataclasses.dataclass
class SortWorkCounter:
    """Device sort-work accounting for the resident index mirrors.

    ``sorted_bytes`` counts bytes fed through *full* mirror sorts
    (O(N log N) — cold builds, width-overflow/tombstone rebuilds, and
    compactions); ``merged_bytes`` counts bytes fed through the
    *delta-run* sorter on the incremental merge path (O(Δ log Δ) + a
    linear merge).  At a steady streaming-append state ``merged_bytes``
    per append is the delta bucket, not the column — the measurable form
    of "per-append index cost scales with Δ" (the bench transfer report
    carries both, next to the h2d/d2h counters)."""

    full_sorts: int = 0
    sorted_bytes: int = 0
    delta_merges: int = 0
    merged_bytes: int = 0
    compactions: int = 0
    rebuilds: int = 0  # forced full paths: tombstone churn, width overflow

    def count_full(self, nbytes: int, *, compaction: bool = False,
                   rebuild: bool = False) -> None:
        self.full_sorts += 1
        self.sorted_bytes += int(nbytes)
        self.compactions += bool(compaction)
        self.rebuilds += bool(rebuild)

    def count_merge(self, nbytes: int) -> None:
        self.delta_merges += 1
        self.merged_bytes += int(nbytes)

    def snapshot(self) -> "SortWorkCounter":
        return SortWorkCounter(self.full_sorts, self.sorted_bytes,
                               self.delta_merges, self.merged_bytes,
                               self.compactions, self.rebuilds)

    def delta(self, since: "SortWorkCounter") -> "SortWorkCounter":
        return SortWorkCounter(
            self.full_sorts - since.full_sorts,
            self.sorted_bytes - since.sorted_bytes,
            self.delta_merges - since.delta_merges,
            self.merged_bytes - since.merged_bytes,
            self.compactions - since.compactions,
            self.rebuilds - since.rebuilds)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __repr__(self) -> str:  # compact: shows up in bench reports
        return (f"SortWorkCounter(full={self.full_sorts}x/"
                f"{self.sorted_bytes}B, merge={self.delta_merges}x/"
                f"{self.merged_bytes}B, compact={self.compactions}, "
                f"rebuild={self.rebuilds})")


@dataclasses.dataclass
class MirrorRuns:
    """Run-tracking state for one resident ``(sorted, perm)`` index
    mirror — the value stored under a ``("runs", cache_key)`` entry.

    ``tagged`` is the resident sorted run in tagged form (``(key - kmin)
    << tag_bits | lane`` over the real prefix, per-lane pad codes above
    every real code past ``n``).  An append becomes a *pending delta
    run*: the tail is tagged-sorted on its own and merged into the
    resident run by the bounded two-run merge kernel.  Because every
    ``sort_perm`` call must hand back the complete mirror, pending runs
    are collapsed within the maintenance call that created them — the
    entry tracks how many merges the resident run has absorbed
    (``merges``) rather than a live run list.

    Maintenance policy (``TorchOps._mirror_sort_device``):

    * **merge** while the column grew append-only at an unchanged buffer
      capacity, the key span still fits the tagged width, and the run
      has absorbed fewer than the compaction threshold of merges;
    * **compaction** (full re-sort, ``merges`` reset) once the run count
      crosses the threshold — bounds re-base drift and keeps the merge
      chain shallow;
    * **full rebuild fallback** on tombstone *churn* — the mirror stays
      sound under tombstones (lookups alive-filter), so deletes ride
      the merge path as carried dead weight until it passes a quarter
      of the alive rows, at which point a full sort compacts it away —
      on width overflow, and on any non-append change (capacity
      growth, shrink, rewrite).

    ``n`` is the run's *lane* count; ``src_n`` is how many source rows
    the run has consumed.  They coincide for a full mirror, but every
    full-sort event on a tombstoned column **compacts**: the rebuilt
    run holds only the alive rows (``n = src_n - n_dead``) with their
    original row ids in the tag bits, so dead rows stop paying sort and
    merge cost forever after.  Appends merge the tail ``[src_n,
    table_n)`` into the compacted run.
    """

    tagged: Any
    n: int
    kmin: int
    cap: int
    tag_bits: int
    merges: int = 0
    # dead rows compacted OUT of the run (excluded at the last full
    # sort).  ``table.n_dead - n_dead`` is the dead weight the run still
    # carries; the maintenance policy bounds it.
    n_dead: int = 0
    src_n: int = -1  # -1 = uncompacted (src_n == n)
    # code-domain identity of the column the run was tagged over
    # (``ColumnCodec.cid``; 0 = raw int64).  A recode-rebuild renumbers
    # existing rows, so a run tagged in the old domain must never absorb
    # a new-domain tail — the maintenance path compares cids and falls
    # back to a full sort on mismatch.
    cid: int = 0

    def __post_init__(self) -> None:
        if self.src_n < 0:
            self.src_n = self.n


@dataclasses.dataclass
class CacheEntry:
    version: int
    value: Any
    nbytes: int
    gen: int = 0  # generation of the last touch (refresh() spill policy)


class DeviceArrayCache:
    """Thread-safe LRU cache of version-stamped device-resident values.

    ``get(key, version)`` hits only when the stored version matches
    exactly; ``get_any(key)`` returns whatever is stored (possibly stale)
    so callers can extend an append-only buffer instead of re-uploading.

    **Spill policy**: the byte-bounded LRU alone can silently thrash when
    several engines share one device cache — each engine's working set
    evicts the others' between iterations, and every re-entry is a full
    re-upload.  ``refresh()`` is the cooperative alternative: callers
    invoke it at a natural boundary (end of an ``infer()``, between
    benchmark phases) and entries not touched for ``max_idle`` refresh
    cycles are spilled *eagerly*, leaving LRU pressure for genuinely hot
    state.  A ``spill_hook(key, entry) -> bool`` (True = keep) overrides
    the idle rule per entry, e.g. to pin index mirrors while letting
    memoized intermediates go.  Spills and evictions are counted
    separately so the bench transfer report can tell cooperative
    spilling from capacity thrash.
    """

    def __init__(self, capacity_bytes: int = 256 << 20) -> None:
        self.capacity_bytes = capacity_bytes
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.extended = 0
        self.evictions = 0
        self.spilled = 0
        self.refreshes = 0
        self.generation = 0
        self.spill_hook = None  # (key, CacheEntry) -> bool keep
        self._bytes = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, CacheEntry]" = OrderedDict()

    # -- accounting --------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        total = self.hits + self.misses + self.stale
        # an extension reused the resident buffer in place (only the
        # appended tail was uploaded), so the lookup that was counted
        # ``stale`` did the job of a hit — fold it back in.  Extensions
        # are a subset of stales, so the rate stays <= 1.
        eff = self.hits + min(self.extended, self.stale)
        return {"hits": self.hits, "misses": self.misses,
                "stale": self.stale, "extended": self.extended,
                "evictions": self.evictions,
                "spilled": self.spilled, "refreshes": self.refreshes,
                "entries": len(self._entries), "bytes": self._bytes,
                "hit_rate": (eff / total) if total else 0.0}

    # -- operations --------------------------------------------------------
    def get(self, key: Hashable, version: int) -> Any | None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            if e.version != version:
                self.stale += 1
                return None
            self.hits += 1
            e.gen = self.generation
            self._entries.move_to_end(key)
            return e.value

    def get_any(self, key: Hashable) -> CacheEntry | None:
        """The stored entry regardless of version (None if absent).  Used
        by append-only buffer sync: a stale entry is a *prefix* of the new
        content, so the caller uploads only the tail."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.gen = self.generation
                self._entries.move_to_end(key)
            return e

    def delta_stats(self, since: dict) -> dict:
        """Per-run view of the counters: current ``stats()`` minus a
        prior snapshot for the monotone counters, with ``hit_rate``
        recomputed over the window (gauges pass through unchanged).
        Bench harnesses share one process-wide cache, so this is the
        only way to attribute traffic to a single engine run."""
        cur = self.stats()
        counters = ("hits", "misses", "stale", "extended", "evictions",
                    "spilled", "refreshes")
        out = {k: (cur[k] - since[k] if k in counters else cur[k])
               for k in cur}
        total = out["hits"] + out["misses"] + out["stale"]
        eff = out["hits"] + min(out["extended"], out["stale"])
        out["hit_rate"] = eff / total if total else 0.0
        return out

    def note_extended(self, key: Hashable = None) -> None:
        """Record that a stale entry was *extended* in place (append-only
        buffer sync uploaded only the tail) — the watermark-range form of
        a hit.  Callers invoke this after a successful extension so
        fixed-prefix entries stop being accounted as full rebuilds."""
        with self._lock:
            self.extended += 1

    def put(self, key: Hashable, version: int, value: Any,
            nbytes: int = 0) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = CacheEntry(version, value, int(nbytes),
                                            self.generation)
            self._bytes += int(nbytes)
            while self._bytes > self.capacity_bytes and len(self._entries) > 1:
                _, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                self.evictions += 1

    def refresh(self, max_idle: int = 1) -> dict:
        """Advance the generation and spill entries idle for more than
        ``max_idle`` refresh cycles (see class docstring).  Returns a
        summary: {"spilled", "spilled_bytes", "kept", "bytes"}."""
        with self._lock:
            self.generation += 1
            self.refreshes += 1
            spilled = spilled_bytes = 0
            for key in list(self._entries):
                e = self._entries[key]
                if self.spill_hook is not None:
                    keep = bool(self.spill_hook(key, e))
                else:
                    keep = (self.generation - e.gen) <= max_idle
                if not keep:
                    del self._entries[key]
                    self._bytes -= e.nbytes
                    self.spilled += 1
                    spilled += 1
                    spilled_bytes += e.nbytes
            return {"spilled": spilled, "spilled_bytes": spilled_bytes,
                    "kept": len(self._entries), "bytes": self._bytes}

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
