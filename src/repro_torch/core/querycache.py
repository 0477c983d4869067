"""Rank-2/3 condition-lookup result cache (paper §5 future work:
"dynamic caching of rank 2 and 3 query results, allowing fine grained
result [reuse] among queries (including rule conditions)").

RNL lookups (Def. 7) for rank>=2 conditions repeat across rule
evaluations and fixpoint iterations; their results only change when the
underlying fact type changes.  The cache keys on the *encoded* constant
slots (fact type + (component, value) pairs) and is invalidated by the
store's per-type version counters — the same counters the engine already
maintains for rule-input change detection, so invalidation is exact, not
heuristic.

Eviction: bounded LRU (the paper's "fine grained result reuse" without
unbounded RAM — exactly the P1 critique applied to our own cache).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.core.conditions import Condition, rl
from repro_torch.core.store import FactStore


class RankNCache:
    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._data: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(store: FactStore, c: Condition, version: int) -> tuple | None:
        consts = c.const_slots(store.strings)
        if len(consts) < 2:          # rank-1 is the index itself; no caching
            return None
        return (c.fact_type, version,
                tuple(sorted((int(comp), v) for comp, v in consts)))

    def lookup(self, store: FactStore, c: Condition,
               type_version: int) -> np.ndarray:
        """RL with caching for CR >= 2 conditions."""
        key = self._key(store, c, type_version)
        if key is None:
            return rl(store, c)
        hit = self._data.get(key)
        if hit is not None:
            self.hits += 1
            self._data.move_to_end(key)
            return hit
        self.misses += 1
        rows = rl(store, c)
        self._data[key] = rows
        if len(self._data) > self.max_entries:
            self._data.popitem(last=False)
        return rows

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data),
                "hit_rate": self.hits / total if total else 0.0}


class DeltaQueryNode:
    """Per-query signed-count state for delta-aware requery.

    A tracked query keeps, per decoded result row, the number of
    distinct derivations the query join produced for it — the same
    counting semantics PR 7 uses for derived-fact support, applied one
    level up at the query result.  A repeat query at moved watermarks
    then runs only the signed frontier windows (inclusion–exclusion
    over δ⁺ append tails and δ⁻ delete-log slices) and *folds* each
    pass into these counts with its sign; rows whose count reaches zero
    drop out, rows appearing with positive count join the result.  The
    rebuilt result is exactly what a full ``distinct=True`` evaluation
    at the new frontier would return — asserted by the serving parity
    matrix in ``tests/test_serving.py``.
    """

    __slots__ = ("marks", "counts")

    def __init__(self, marks: dict, rows: list) -> None:
        self.marks = marks                  # {ftype: (n, dellog_n)}
        self.counts: dict[tuple, int] = {}
        self.fold(rows, 1)

    def fold(self, rows: list, sign: int) -> None:
        """Apply one evaluation pass (decoded rows with multiplicity)."""
        counts = self.counts
        for r in rows:
            # canonical key: decoded dict ordering follows condition
            # evaluation order, which differs between full passes and
            # window-pinned passes — ± contributions must collide
            k = tuple(sorted(r.items()))
            c = counts.get(k, 0) + sign
            if c:
                counts[k] = c
            else:
                counts.pop(k, None)

    def result(self) -> list[dict]:
        """Distinct rows currently derivable (count > 0)."""
        return [dict(k) for k, c in self.counts.items() if c > 0]


class QueryNodeStore:
    """Bounded registry of ``DeltaQueryNode``s keyed by the conditions
    tuple, with the cumulative requery counters the serving tier and the
    bench validator read (``full_evals`` must go to zero at steady
    state).  Counters live here — not in ``InferStats`` — because
    ``infer()`` replaces ``last_infer`` wholesale and a serving writer
    re-infers between reads."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._nodes: OrderedDict[tuple, DeltaQueryNode] = OrderedDict()
        self.full_evals = 0     # tracked queries that (re)built from scratch
        self.delta_folds = 0    # requeries served by signed-window folding
        self.delta_passes = 0   # signed windows actually evaluated
        self.rebuilds = 0       # folds abandoned (table replaced / pass blowup)

    def get(self, key: tuple) -> "DeltaQueryNode | None":
        node = self._nodes.get(key)
        if node is not None:
            self._nodes.move_to_end(key)
        return node

    def put(self, key: tuple, node: DeltaQueryNode) -> None:
        self._nodes[key] = node
        if len(self._nodes) > self.max_entries:
            self._nodes.popitem(last=False)

    def drop(self, key: tuple) -> None:
        self._nodes.pop(key, None)

    def stats(self) -> dict:
        return {"tracked_queries": len(self._nodes),
                "full_evals": self.full_evals,
                "delta_folds": self.delta_folds,
                "delta_passes": self.delta_passes,
                "rebuilds": self.rebuilds}


class QueryResultCache:
    """Repeat-query fast path: decoded ``engine.query()`` results keyed
    by (conditions, input-table version token).

    Where ``RankNCache`` memoizes per-*condition* row sets inside
    evaluation, this memoizes the finished decoded result of a whole
    query: a query re-issued at unchanged ``(version, data_version)``
    for every input table never re-enters evaluation at all.  The
    version token is computed by the engine (plain per-table for the
    unsharded engine, per-worker for ``shards=N``), so one cache class
    serves both.  Entries are stored as immutable ``tuple``-of-items
    rows — ``put`` freezes the caller's rows once, and only the *hit*
    path pays a copy (``dict(items)`` per row) so a caller mutating a
    returned row cannot poison the cache.  The old scheme copied every
    row twice (once into the cache, once out); misses now store the
    frozen form directly and return the caller's own list untouched.
    Eviction is bounded LRU, invalidation exact via the token.
    """

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._data: OrderedDict[tuple, list] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(conditions, version_token: tuple) -> tuple | None:
        """Cache key, or ``None`` when the conditions are unhashable
        (e.g. a test carrying a callable const) — such queries are
        simply not cached."""
        k = (tuple(conditions), version_token)
        try:
            hash(k)
        except TypeError:
            return None
        return k

    def lookup(self, key: tuple) -> "tuple | None":
        """Frozen rows (tuple of item-tuples) or None; the caller
        rehydrates with ``[dict(r) for r in hit]`` — the single copy."""
        hit = self._data.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return hit

    def put(self, key: tuple, rows: list) -> None:
        """Freeze and store decoded rows (the caller's list is not
        retained, so no defensive copy is needed on the way in)."""
        self._data[key] = tuple(tuple(r.items()) for r in rows)
        if len(self._data) > self.max_entries:
            self._data.popitem(last=False)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data),
                "hit_rate": self.hits / total if total else 0.0}
