"""Island fact processing (paper §2.3, Algorithm 1) + sort keys.

Islands = all conditions of a rule bound to the same ``?id`` variable.
The planner orders islands by aggregated cardinality estimates (Eq. 1) and
conditions within an island by (cardinality, connected level); islands are
chained through shared variables, with the connecting condition ("hook
point") evaluated first when entering the next island.  This keeps every
intermediate join result as small as the rank-1 statistics allow — the
paper's replacement for Rete's static join order + memoized tokens.

Sort keys: the ordering metrics are packed into a single uint32
(9b inter-fact links | 11b island score | 2b rank | 10b min cardinality),
each field bucketized (std-dev capped) to fit its bit range, so ordering is
one integer sort instead of a tuple comparator (paper §Sort Keys).  Both the
"fixed sort" and "sort keys" modes are implemented and benchmarked.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.backend import Ops
from repro_torch.core.conditions import Condition, Rule, bindings_for_rows, ccar, rl
from repro_torch.core.joins import (Bindings, ColumnarBindings, dedup_bindings,
                                    join_bindings, make_bindings, semi_join_rows)
from repro_torch.core.store import Component, FactStore

# ---------------------------------------------------------------------------
# Sort keys

_BITS = (9, 11, 2, 10)  # inter-fact links | island score | rank | min card


def bucketize(values: list[float], bits: int) -> list[int]:
    """Rank-preserving bucket ids within ``bits`` bits (paper §Capping sort
    key buckets): ordinal ranks when they fit, otherwise std-dev windows of
    width ``sigma * mult`` with ``mult`` doubled until the range fits."""
    vals = np.asarray([0.0 if math.isinf(v) else float(v) for v in values])
    inf_mask = np.asarray([math.isinf(v) for v in values])
    cap = 1 << bits
    uniq = np.unique(vals[~inf_mask]) if (~inf_mask).any() else np.asarray([0.0])
    if len(uniq) < cap:  # reserve top bucket for inf
        ids = np.searchsorted(uniq, vals)
    else:
        sigma = float(vals[~inf_mask].std()) or 1.0
        mult = 0.05
        base = float(vals[~inf_mask].min())
        while True:
            width = max(sigma * mult, 1e-12)
            b = np.floor((vals - base) / width).astype(np.int64)
            b -= b.min()
            if b.max() < cap - 1:
                ids = b
                break
            mult *= 2.0
    ids = np.where(inf_mask, cap - 1, ids)
    return [int(x) for x in ids]


def pack_sort_keys(
    interfact: list[int], island_score: list[float], rank: list[int],
    min_card: list[float],
) -> np.ndarray:
    """uint32 keys; ascending sort yields the paper's priority order
    (more links first, cheaper island first, higher rank first, lower
    cardinality first)."""
    b_link = bucketize([float(x) for x in interfact], _BITS[0])
    b_isl = bucketize(island_score, _BITS[1])
    b_card = bucketize(min_card, _BITS[3])
    keys = []
    for bl, bi, r, bc in zip(b_link, b_isl, rank, b_card):
        k = ((511 - bl) << 23) | (bi << 12) | ((3 - r) << 10) | bc
        keys.append(k)
    return np.asarray(keys, np.uint32)


# ---------------------------------------------------------------------------
# Planner data


@dataclasses.dataclass
class CondStats:
    cond: Condition
    index: int              # position in the rule
    rank: int
    card: float             # CCar (Def. 6)
    connected_level: int    # #other conditions sharing a variable
    inter_links: int        # #vars shared with conditions in OTHER islands


@dataclasses.dataclass
class Island:
    key: str                       # the ?id variable (or per-condition const)
    stats: list[CondStats]
    total_cost: float = 0.0
    variables: set[str] = dataclasses.field(default_factory=set)


def _island_key(c: Condition, i: int) -> str:
    from repro_torch.core.conditions import is_var

    return c.id.name if is_var(c.id) else f"<const#{i}>"


def build_islands(store: FactStore, rule: Rule) -> list[Island]:
    """Phases 1+2 of Algorithm 1: per-condition stats, grouping by id-var,
    island cost aggregation (Eq. 1)."""
    conds = list(rule.conditions)
    all_vars = [set(c.variables().keys()) for c in conds]
    stats: list[CondStats] = []
    for i, c in enumerate(conds):
        level = sum(1 for j, vs in enumerate(all_vars)
                    if j != i and vs & all_vars[i])
        stats.append(CondStats(c, i, c.rank(), ccar(store, c), level, 0))
    groups: dict[str, list[CondStats]] = {}
    for i, st in enumerate(stats):
        groups.setdefault(_island_key(st.cond, i), []).append(st)
    islands = []
    for key, sts in groups.items():
        isl = Island(key, sts)
        isl.total_cost = sum(min(s.card, 1e18) for s in sts)
        for s in sts:
            isl.variables |= set(s.cond.variables().keys())
        islands.append(isl)
    # inter-fact links: vars shared with conditions of other islands
    for isl in islands:
        other_vars: set[str] = set()
        for o in islands:
            if o is not isl:
                other_vars |= o.variables
        for s in isl.stats:
            s.inter_links = len(set(s.cond.variables().keys()) & other_vars)
    return islands


def order_islands(islands: list[Island],
                  prefer: set[int] | None = None) -> list[Island]:
    """Phase 3 ordering: cheapest island first, then greedily the cheapest
    *connected* island (unconnected islands are delegated until a connection
    exists — the paper's TPC example).

    ``prefer`` (rule-condition indices) biases the entry point: a
    semi-naive delta pass starts from the island holding the delta
    condition, so the tiny append frontier is what the AR restriction
    propagates through the rest of the chain."""
    remaining = sorted(islands, key=lambda i: i.total_cost)
    if not remaining:
        return []
    if prefer:
        seeded = [i for i in remaining
                  if any(s.index in prefer for s in i.stats)]
        first = seeded[0] if seeded else remaining[0]
    else:
        first = remaining[0]
    remaining.remove(first)
    out = [first]
    bound = set(out[0].variables)
    while remaining:
        connected = [i for i in remaining if i.variables & bound]
        nxt = min(connected or remaining, key=lambda i: i.total_cost)
        remaining.remove(nxt)
        out.append(nxt)
        bound |= nxt.variables
    return out


def order_conditions(isl: Island, bound: set[str], sort_mode: str,
                     prefer: set[int] | None = None) -> list[CondStats]:
    """Within-island order: hook-point conditions (sharing already-bound
    vars) first, then by (cardinality, connected level) — either as a tuple
    sort ("fixed") or via packed uint32 sort keys ("sortkeys").
    ``prefer`` front-loads the named conditions (delta passes)."""
    sts = order_conditions_base(isl, bound, sort_mode)
    if prefer:
        sts = ([s for s in sts if s.index in prefer] +
               [s for s in sts if s.index not in prefer])
    return sts


def order_conditions_base(isl: Island, bound: set[str],
                          sort_mode: str) -> list[CondStats]:
    sts = list(isl.stats)
    if sort_mode == "sortkeys":
        keys = pack_sort_keys(
            interfact=[len(set(s.cond.variables().keys()) & bound) for s in sts],
            island_score=[isl.total_cost] * len(sts),
            rank=[s.rank for s in sts],
            min_card=[s.card for s in sts],
        )
        order = np.argsort(keys, kind="stable")
        return [sts[int(i)] for i in order]
    return sorted(
        sts,
        key=lambda s: (
            -len(set(s.cond.variables().keys()) & bound),
            min(s.card, 1e18),
            -s.rank,
            s.connected_level,
        ),
    )


# ---------------------------------------------------------------------------
# Sketch-driven cost-based planning (sort_mode="sketch")


class SketchPlanner:
    """Cardinality-sketch cost model for adaptive join ordering.

    Static planning uses ``ccar`` — the rank-1 index's per-constant
    count, frozen into sort keys at rule-add time.  The sketch planner
    instead estimates *intermediate-result* sizes: per join-key column
    it keeps a tiny ``Ops.sketch`` (row histogram + distinct count over
    ``splitmix64 % B`` buckets, computed on device over the resident
    coded columns and cached per ``(uid, data_version)``), and scores a
    candidate join as ``|acc| * |cond| / distinct(shared key)`` — the
    classic independence estimate, but from live data instead of static
    priors.  A planner instance memoizes sketches per
    ``(table uid, component)`` and counts ``hits``/``misses`` against
    the table's ``data_version`` (the engine drains them into
    ``InferStats.sketch_hits/misses``)."""

    def __init__(self, ops: Ops):
        self.ops = ops
        self._memo: dict[tuple, tuple] = {}  # (uid, comp) -> (dv, sketch)
        self.hits = 0
        self.misses = 0

    def table_sketch(self, table, comp: Component) -> dict:
        key = (table.uid, int(comp))
        cur = self._memo.get(key)
        if cur is not None and cur[0] == table.data_version:
            self.hits += 1
            return cur[1]
        self.misses += 1
        sk = self.ops.sketch(
            np.asarray(table.column(comp)[:table.n], np.int64),
            cache_key=key, version=table.data_version)
        self._memo[key] = (table.data_version, sk)
        return sk

    def cond_card(self, store: FactStore, c: Condition) -> float:
        """Estimated rows matching the condition's constant slots: the
        minimum histogram bucket over the constants (vs ``ccar``'s exact
        per-constant index count, this needs no index and prices *all*
        constants, not just the cheapest)."""
        from repro_torch.backend.base import sketch_bucket

        table = store.tables.get(c.fact_type)
        if table is None or table.n == 0:
            return 0.0
        est = float(table.n)
        for comp, v in c.const_slots(store.strings):
            if v == -1:
                return 0.0
            sk = self.table_sketch(table, comp)
            est = min(est, float(sk["hist"][sketch_bucket(v)]))
        return est


def _join_estimate(planner: SketchPlanner, store: FactStore, c: Condition,
                   bound: set[str], est_acc: "float | None") -> float:
    """Predicted size of ``acc ⋈ c``: per shared variable the
    condition contributes ``|c| / distinct(key column)`` rows per bound
    value (take the most selective); no shared variable is a cross
    product."""
    base = planner.cond_card(store, c)
    if est_acc is None:
        return base
    table = store.tables.get(c.fact_type)
    best = None
    for name, comp in c.variables().items():
        if name not in bound or table is None:
            continue
        sk = planner.table_sketch(table, comp)
        per_key = base / max(float(sk["distinct"]), 1.0)
        cand = est_acc * per_key
        if best is None or cand < best:
            best = cand
    return est_acc * base if best is None else best


def _plan_order(planner: SketchPlanner, store: FactStore,
                sts: list[CondStats], bound: set[str],
                est_acc: "float | None") -> list[tuple[CondStats, float]]:
    """Greedy order over the remaining conditions by predicted
    intermediate size (connected conditions before cross products),
    carrying the running estimate forward.  Returns
    ``[(stat, predicted size after its join), ...]``."""
    remaining = list(sts)
    b = set(bound)
    est = est_acc
    out: list[tuple[CondStats, float]] = []
    while remaining:
        connected = [s for s in remaining
                     if b and set(s.cond.variables()) & b] or remaining
        pred, nxt = min(
            ((_join_estimate(planner, store, s.cond, b, est), s)
             for s in connected), key=lambda t: t[0])
        out.append((nxt, pred))
        remaining.remove(nxt)
        b |= set(nxt.cond.variables().keys())
        est = pred
    return out


def _evaluate_adaptive(store: FactStore, rule: Rule, islands: list[Island],
                       *, join_algo: str, rnl_mode: str, layout: str,
                       distinct: bool, rl_fn, ops: "Ops | None",
                       pipeline: bool, stats: "dict | None",
                       planner: SketchPlanner) -> Bindings:
    """Adaptive execution: a sketch-estimated greedy plan, re-planned
    mid-rule whenever an observed intermediate size drifts more than 4x
    from its prediction (either direction) and joins remain — the
    estimate that misled the rest of the plan is replaced by the
    observation.  Re-plans are counted into ``stats["replans"]``.
    Full-relation passes only; the engine's delta passes keep the static
    frontier-pinned order (their intermediates are frontier-sized — the
    thing the planner exists to predict — by construction)."""
    sts = [s for isl in islands for s in isl.stats]
    gates = [s for s in sts if not s.cond.variables()]
    joins = [s for s in sts if s.cond.variables()]
    for st in gates:
        if len((rl_fn or rl)(store, st.cond)) == 0:
            return make_bindings({"_exists": np.empty(0, np.int64)}, layout)
    pending = [(t, c.valtype) for c in rule.conditions for t in c.tests]
    acc: Bindings | None = None
    bound: set[str] = set()
    plan = _plan_order(planner, store, joins, bound, None)
    replans = 0
    while plan:
        st, pred = plan.pop(0)
        rhs = _lookup_condition(store, st.cond, acc, rnl_mode, layout,
                                rl_fn, ops, pipeline, 0, stats)
        if acc is None:
            acc = rhs
        else:
            keys = [v for v in st.cond.variables() if v in bound]
            acc = join_bindings(acc, rhs, keys, join_algo, ops)
        bound |= set(st.cond.variables().keys())
        still = []
        for t, vt in pending:
            if t.var1 in bound and (t.is_const() or t.var2 in bound):
                if acc.n > 0:
                    acc = _apply_test(store, acc, t, vt, ops, pipeline)
            else:
                still.append((t, vt))
        pending = still
        if acc.n == 0:
            return acc
        obs = float(acc.n)
        lo, hi = max(pred, 1.0) / 4.0, max(pred, 1.0) * 4.0
        if plan and not (lo <= obs <= hi) and replans < len(joins):
            replans += 1
            if stats is not None:
                stats["replans"] = stats.get("replans", 0) + 1
            plan = _plan_order(planner, store, [s for s, _ in plan],
                               bound, obs)
    if acc is None:  # all conditions were existence checks and all passed
        acc = make_bindings({"_exists": np.zeros(1, np.int64)}, layout)
    return dedup_bindings(acc, ops) if distinct else acc


# ---------------------------------------------------------------------------
# Executor (Phases 3-5 of Algorithm 1)


def _frontier_rows(store: FactStore, c: Condition, start: int) -> np.ndarray:
    """O(Δ) fetch of a condition's append frontier: scan only the tail
    rows ``[start, n)`` with vectorized constant filters — never the
    rank-1 index over the full relation (``rl`` + a ``>= start`` filter
    would cost O(result) in the *full* table)."""
    table = store.tables.get(c.fact_type)
    if table is None or table.n <= start:
        return np.empty(0, np.int32)
    consts = c.const_slots(store.strings)
    if any(v == -1 for _, v in consts):
        return np.empty(0, np.int32)
    rows = np.arange(start, table.n, dtype=np.int32)
    for comp, v in consts:
        if len(rows) == 0:
            break
        rows = rows[table.column(comp)[rows] == v]
    return table.filter_alive(rows)


def _dead_window_rows(store: FactStore, c: Condition,
                      rows: np.ndarray) -> np.ndarray:
    """O(Δ) fetch of a condition's −frontier: const-filter an explicit
    row list taken from the table's delete log.  The rows are tombstoned
    *now* but their columns are intact (tombstones never touch columns),
    so the filters see the values the facts died with; there is no alive
    filter — being dead is the point."""
    table = store.tables.get(c.fact_type)
    if table is None or len(rows) == 0:
        return np.empty(0, np.int32)
    consts = c.const_slots(store.strings)
    if any(v == -1 for _, v in consts):
        return np.empty(0, np.int32)
    rows = np.asarray(rows, np.int32)
    for comp, v in consts:
        if len(rows) == 0:
            break
        rows = rows[table.column(comp)[rows] == v]
    return rows


def _probe_rows(store: FactStore, c: Condition, acc: Bindings,
                ) -> tuple[np.ndarray, str] | None:
    """AR restriction via the rank-1 index: when the accumulated buffer
    binds one of the condition's variables with a small value set, probe
    the index for exactly those values instead of fetching the full
    relation and semi-joining it down — O(Δ·fanout), not O(N).  Returns
    ``(rows, probed_var)`` or None when no bound variable exists."""
    table = store.tables.get(c.fact_type)
    if table is None:
        return None
    consts = c.const_slots(store.strings)
    if any(v == -1 for _, v in consts):  # unknown string constant
        return np.empty(0, np.int32), next(iter(c.variables()))
    for name, comp in c.variables().items():
        if name not in acc.names():
            continue
        vals = np.unique(np.asarray(acc.col(name), np.int64))
        rows, _ = table.index.lookup_batch(table, comp, vals)
        for comp2, v in consts:
            if len(rows) == 0:
                break
            rows = rows[table.column(comp2)[rows] == v]
        return table.filter_alive(rows), name
    return None


def _lookup_condition(
    store: FactStore, c: Condition, acc: Bindings | None, rnl_mode: str,
    layout: str, rl_fn=None, ops: Ops | None = None,
    pipeline: bool = False, delta_start: "int | np.ndarray" = 0,
    stats: dict | None = None,
) -> Bindings:
    """RL lookup for one condition -> its binding table.

    AR mode (adapted RNL): if the accumulated join buffer already binds one
    of the condition's variables, the fetched rows are semi-join restricted
    to the bound value set before the join — the paper's rank-raising lookup.
    DR performs the plain RL lookup.

    ``delta_start`` selects the condition's *signed frontier* (semi-naive
    evaluation).  An ``int`` start pins the +frontier: only rows
    ``>= delta_start`` — facts appended since the owning rule's
    watermark — are fetched (columns are append-only, so the window is
    exactly ``[watermark, n)``).  An ``ndarray`` pins the −frontier: the
    explicit row ids (from the table's delete log) of facts that *died*
    in the window; they are const-filtered but never alive-filtered.
    Every unpinned condition sees the current relation — the caller
    combines passes with inclusion–exclusion signs so the net change is
    exact under counting semantics.

    The RL fetch itself is a rank-1 index probe: with the device backend
    it binary-searches the index's cached host mirrors, so repeated
    lookups between fact writes issue zero host<->device transfers (see
    backend/README.md §Device residency).

    Device pipeline (``pipeline=True``, CR layout): the fetched binding
    columns are uploaded once per ``(table, data_version, condition,
    frontier)`` and cached as ``DeviceCol`` handles; full-relation
    columns go through ``ops.upload_resident`` so an append round
    uploads only the delta slice into the resident buffer.  The AR
    restriction then runs as a device semi-join + compaction on those
    handles, so the lookup result enters the join chain already
    device-resident.  Because the cached handles are stable at a fixed
    version, a repeated evaluation hits the backend's uid-keyed memos
    end to end.
    """
    table = store.tables.get(c.fact_type)
    pipeline = pipeline and layout == "CR" and ops is not None
    neg_rows = delta_start if isinstance(delta_start, np.ndarray) else None
    if neg_rows is not None:
        delta_start = -1  # cache-key tag; windows skip the handle cache
    # delta windows never recur (the watermark advances every round), so
    # they skip the handle cache entirely and upload as transient state
    cache = (getattr(ops, "cache", None)
             if pipeline and delta_start == 0 else None)
    handles = (cache.get(("bind", table.uid, c, delta_start),
                         table.data_version)
               if cache is not None and table is not None else None)
    probed_var = None
    if handles is None:
        # a cache hit implies the same rows (rl is deterministic at a
        # fixed data_version), so the RL fetch runs only on a miss
        if neg_rows is not None:
            rows = _dead_window_rows(store, c, neg_rows)
        elif delta_start and rl_fn is None:
            rows = _frontier_rows(store, c, delta_start)
        elif (not pipeline and rl_fn is None and rnl_mode == "AR"
              and acc is not None and table is not None
              and 0 < acc.n * 4 <= table.n and delta_start == 0
              and not getattr(ops, "prefer_handles", False)):
            # small bound set over a big relation: probe the rank-1
            # index for the bound values instead of full-scan+semi-join
            # (host backends only — a device backend would turn each
            # lookup into a batch_probe round trip)
            pr = _probe_rows(store, c, acc)
            if pr is not None:
                rows, probed_var = pr
            else:
                rows = rl(store, c)
        else:
            rows = (rl_fn or rl)(store, c)
            if delta_start:
                rows = rows[rows >= delta_start]
        if stats is not None:
            stats["rows_considered"] = (stats.get("rows_considered", 0)
                                        + len(rows))
        if table is None or len(rows) == 0:
            return make_bindings(
                {v: np.empty(0, np.int64) for v in c.variables()}, layout)
    elif stats is not None and handles:
        stats["rows_considered"] = (stats.get("rows_considered", 0)
                                    + next(iter(handles.values())).n)
    if pipeline:
        if handles is None:
            cols = bindings_for_rows(table, c, rows)
            # full-relation scans of tombstone-free tables extend
            # append-only (rows are arange(n)): skip the prefix memcmp
            vs = c.var_slots()
            assume_prefix = (delta_start == 0 and c.rank() == 0
                             and table.n_dead == 0
                             and len({n for n, _ in vs}) == len(vs))
            handles = {
                k: ops.upload_resident(
                    ("bindcol", table.uid, c, k, delta_start),
                    table.data_version, v, assume_prefix,
                    transient=delta_start != 0)
                for k, v in cols.items()}
            if cache is not None:
                cache.put(("bind", table.uid, c, delta_start),
                          table.data_version, handles,
                          sum(getattr(h.data, "nbytes", 0)
                              for h in handles.values()))
        b = ColumnarBindings(handles)
        if rnl_mode == "AR" and acc is not None and acc.n > 0 and b.n > 0:
            for name in c.variables():
                if name in acc.names():
                    mask = ops.semi_join_h(b.handle(name, ops),
                                           acc.handle(name, ops))
                    names = b.names()
                    sel, _ = ops.select_mask_h(
                        [b.handle(k, ops) for k in names], mask)
                    b = ColumnarBindings(dict(zip(names, sel)))
                    if b.n == 0:
                        break
        return b
    if rnl_mode == "AR" and acc is not None and acc.n > 0:
        for name, comp in c.variables().items():
            if name in acc.names() and name != probed_var:
                keys = table.column(comp)[rows].astype(np.int64)
                rows = rows[semi_join_rows(keys, acc.col(name), ops)]
                if len(rows) == 0:
                    break
    return make_bindings(bindings_for_rows(table, c, rows), layout)


def _apply_test(store: FactStore, acc: Bindings, t, vt, ops: Ops | None,
                pipeline: bool) -> Bindings:
    """Fire one join test (Def. 9) on the accumulated bindings.

    On the device pipeline the comparison (var⊕var or var⊕const) and the
    surviving-row compaction run on handles (``test_mask_h`` +
    ``select_mask_h``) so test-bearing rules stay device-resident; the
    host path is the original decode-and-compare."""
    if (pipeline and ops is not None and isinstance(acc, ColumnarBindings)
            and acc.device_backed()):
        a = acc.handle(t.var1, ops)
        if t.is_const():
            b = ops.const_h(t.const_lane(vt, store.strings), acc.n)
        else:
            b = acc.handle(t.var2, ops)
        mask = ops.test_mask_h(a, b, t.op, int(vt))
        names = acc.names()
        sel, _ = ops.select_mask_h([acc.handle(k, ops) for k in names],
                                   mask)
        return ColumnarBindings(dict(zip(names, sel)))
    if t.is_const():
        rhs = np.asarray([t.const_lane(vt, store.strings)], np.int64)
    else:
        rhs = acc.col(t.var2)
    ok = t.apply(acc.col(t.var1), rhs, vt)
    return acc.select(np.nonzero(ok)[0])


def evaluate_rule(store: FactStore, rule: Rule, *, join_algo: str = "MJ",
                  rnl_mode: str = "AR", layout: str = "CR",
                  sort_mode: str = "sortkeys", distinct: bool = False,
                  islands: list[Island] | None = None,
                  rl_fn=None, ops: Ops | None = None,
                  pipeline: bool | None = None,
                  delta_for: "dict[int, int | np.ndarray] | None" = None,
                  stats: dict | None = None,
                  planner: "SketchPlanner | None" = None) -> Bindings:
    """Full island-based evaluation of one rule -> final binding table.

    ``islands`` may be passed in pre-built (derivation-tree executor re-sorts
    keys once per level instead of per rule invocation — Algorithm 2 line 7).

    ``pipeline`` routes the whole island chain through the backend's
    handle tier (device-resident intermediates, fused join+gather, device
    dedup); ``None`` defers to ``ops.prefer_handles`` — on by default for
    device backends, off for the host backend.  CR layout only (RR is
    the paper's internal-evaluation loser and stays host-side).

    ``delta_for`` maps rule-condition indices to signed frontiers: an
    ``int`` append watermark (the condition sees only rows ``>=
    frontier``) or an ``ndarray`` of delete-log rows (the condition sees
    only facts that died in the window).  One pass evaluates with every
    named condition pinned to its window and every other condition on
    the full current relation; the engine combines such passes with
    inclusion–exclusion signs.  A pinned island is evaluated first so
    the AR restriction propagates the (small) frontier through the
    chain — this is what makes a fixpoint round cost O(Δ) instead of
    O(N).
    """
    if islands is None:
        islands = build_islands(store, rule)
    if pipeline is None:
        pipeline = bool(getattr(ops, "prefer_handles", False))
    pipeline = pipeline and layout == "CR" and ops is not None
    if delta_for is not None:
        delta_for = {i: s for i, s in delta_for.items()
                     if (len(s) if isinstance(s, np.ndarray) else s) > 0}
    if planner is not None and not delta_for:
        # sort_mode="sketch": cost-based adaptive execution replaces the
        # static island/condition ordering for full-relation passes
        return _evaluate_adaptive(
            store, rule, islands, join_algo=join_algo, rnl_mode=rnl_mode,
            layout=layout, distinct=distinct, rl_fn=rl_fn, ops=ops,
            pipeline=pipeline, stats=stats, planner=planner)
    prefer = set(delta_for) if delta_for else None
    ordered = order_islands(islands, prefer)
    # A join test (Def. 9) fires as soon as its operands are bound (the
    # var⊕const form needs only its left variable).
    pending = [(t, c.valtype) for c in rule.conditions for t in c.tests]
    acc: Bindings | None = None
    bound: set[str] = set()
    for isl in ordered:
        for st in order_conditions(isl, bound, sort_mode, prefer):
            ds = delta_for.get(st.index, 0) if delta_for else 0
            if not st.cond.variables():
                # variable-free (rank-3) condition == existence filter
                # (counting engines never pin these: existence is not a
                # multiplicity, so such rules take the full/scrub path)
                rows = (rl_fn or rl)(store, st.cond)
                if isinstance(ds, np.ndarray):
                    rows = _dead_window_rows(store, st.cond, ds)
                elif ds:
                    rows = rows[rows >= ds]
                if len(rows) == 0:
                    return make_bindings(
                        {v: np.empty(0, np.int64) for v in bound} or
                        {"_exists": np.empty(0, np.int64)}, layout)
                continue
            rhs = _lookup_condition(store, st.cond, acc, rnl_mode, layout,
                                    rl_fn, ops, pipeline, ds, stats)
            if acc is None:
                acc = rhs
            else:
                keys = [v for v in st.cond.variables() if v in bound]
                acc = join_bindings(acc, rhs, keys, join_algo, ops)
            bound |= set(st.cond.variables().keys())
            still = []
            for t, vt in pending:
                if t.var1 in bound and (t.is_const() or t.var2 in bound):
                    if acc.n > 0:
                        acc = _apply_test(store, acc, t, vt, ops, pipeline)
                else:
                    still.append((t, vt))
            pending = still
            if acc.n == 0:
                return acc
    if acc is None:  # all conditions were existence checks and all passed
        acc = make_bindings({"_exists": np.zeros(1, np.int64)}, layout)
    return dedup_bindings(acc, ops) if distinct else acc
