"""Sharded multi-device semi-naive fixpoint (``EngineConfig(shards=N)``).

The paper's derivation trees exist to give parallel read/write access to
the fact store: each writer owns a memory range (§2.4).  The device
generalization implemented here: each of N shard workers owns the facts
whose rank-1 key (the ``<id>`` component) hashes to its index.  Every
worker is a complete ``HiperfactEngine`` (same island executor, same
semi-naive delta fixpoint, same kernels, its own ``Ops``) over its
partition; the global fixpoint alternates local fixpoints with an
all-to-all *frontier exchange* that moves only the derived rows whose
keys land on a foreign shard (``distributed.pipeline.FrontierExchange``
— ``bucket_scatter`` and a slot permute of three packed int64 lanes over
the shards' devices, or a host permute when the process has fewer CUDA
devices than shards and no device list was given).

The workers' ``Ops`` all run on the backend's one device (``torch``: the
default CUDA device); the exchange alone spreads over its device list.

Partitioned joins.  Conditions that share an ``<id>`` variable (an
*island*, §2.3) are co-located for free: all rows of one id hash to one
shard.  Cross-island joins are localized by rewriting each rule against
*view tables* — system-maintained copies of a base table re-partitioned
by a different component:

* the **home island** H (highest locality score) keeps its conditions on
  the owner partition;
* in every other island, one condition that binds H's id variable at
  component ``comp`` becomes a **hashed view** (rows of its table living
  at ``hash(row[comp])`` — for transitive closure this is exactly the
  delta re-partitioning of ``core.distributed.closure_step``);
* remaining conditions become **replicated views** (full copy on every
  shard).  Replication cannot double derivations: every binding is
  anchored through the home island's owner rows, which exist on exactly
  one shard.  Rules with no variable-keyed island run on shard 0 only.

View tables are fed eagerly: whenever a row of a base table is inserted
(loaded or derived), copies for every registered view ride the same
exchange round as the owner copy, so no multi-hop forwarding rounds are
needed — duplicates die in the destination table's write-side dedup.
Traffic per round is O(Δ) — proportional to the round's derived rows,
never to table size.

``shards=1`` never constructs this class (``HiperfactEngine.__new__``
dispatches only for N > 1), so the single-shard path is the unsharded
engine.  The port's copy of the reference's ``core/sharded.py``: the
same routing, exchange rounds and byte accounting, so ``exchange_log``
agrees with the reference's row for row.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib

import numpy as np

from repro_torch.backend import fresh_backend, is_handle, splitmix64
from repro_torch.core.conditions import Condition, Rule, is_var
from repro_torch.core.engine import (EngineConfig, HiperfactEngine,
                                     InferStats, _resolve_shards,
                                     decode_bindings)
from repro_torch.core.facts import ValueType, decode_value
from repro_torch.core.islands import evaluate_rule
from repro_torch.core.store import (VIEW_PREFIX, Component, FactStore,
                                    base_fact_type)

# exchange row kinds (meta lane bits 8..15): asserted insert, explicit
# delete, derived (non-asserted) insert, signed support delta (net count
# in meta bits 32..63)
_ADD, _DEL, _ADD_DERIVED, _SUP = 0, 1, 2, 3


def view_name(ftype: str, comp: "Component | None") -> str:
    """Name of the view of ``ftype`` re-partitioned by ``comp`` (``None``
    = replicated).  Views are shared across rules: two rules needing the
    same (table, component) re-partition feed one table."""
    tag = "rep" if comp is None else str(int(comp))
    return f"{VIEW_PREFIX}{ftype}:{tag}"


def shard_of(lanes: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per int64 lane — host twin of the device ``_mix64``
    route in ``core.distributed`` (same splitmix64 constants)."""
    h = splitmix64(np.asarray(lanes).astype(np.int64))
    return (h % np.uint64(n_shards)).astype(np.int32)


# ---------------------------------------------------------------------------
# Rule analysis: home island + view rewrite


def _island_groups(rule: Rule) -> dict:
    """Conditions grouped by island key: the ``<id>`` variable name, or a
    per-condition const marker (const-id conditions are their own
    islands, cf. ``islands.build_islands``)."""
    groups: dict[object, list[int]] = {}
    for i, c in enumerate(rule.conditions):
        key = c.id.name if is_var(c.id) else ("#const", i)
        groups.setdefault(key, []).append(i)
    return groups


def _binding_comp(c: Condition, var: str) -> "Component | None":
    """First non-ID component of ``c`` binding ``var`` (a home id variable
    can only reappear at ATTR/VAL — at ID it would be the same island)."""
    for comp, t in c.slots().items():
        if comp != Component.ID and is_var(t) and t.name == var:
            return comp
    return None


def _pick_home(rule: Rule) -> tuple[str, list[int]] | None:
    """Choose the home island: the id variable whose partition localizes
    the most foreign rows (conditions elsewhere binding it become hashed
    views; everything else must replicate)."""
    groups = _island_groups(rule)
    best, best_score = None, None
    for key, idxs in groups.items():
        if not isinstance(key, str):
            continue
        score = 0.01 * len(idxs)  # tie-break: keep big islands local
        for i, c in enumerate(rule.conditions):
            if i in idxs:
                continue
            comp = _binding_comp(c, key)
            if comp is None:
                score -= 1.0 if c.rank() < 2 else 0.25
            elif comp == Component.ATTR:
                score += 0.5  # attr domains are small: poor balance
            else:
                score += 2.0
        if best_score is None or score > best_score:
            best, best_score = (key, idxs), score
    return best


def _rewrite_rule(rule: Rule, home: tuple[str, list[int]] | None
                  ) -> tuple[Rule, list[tuple[str, "Component | None"]]]:
    """Rewrite non-home conditions onto view tables.

    Returns the rewritten rule plus the (base table, component) views it
    needs.  Per non-home island at most ONE condition becomes a hashed
    view (two hashed conditions of one island could land rows of the
    same island id on different shards and miss their intra-island
    join); the rest replicate.
    """
    groups = _island_groups(rule)
    home_key, home_idxs = home if home is not None else (None, [])
    new_conds = list(rule.conditions)
    views: list[tuple[str, Component | None]] = []
    for key, idxs in groups.items():
        if home_key is not None and key == home_key:
            continue
        anchor = None  # (cond idx, comp) — prefer VAL/ID-width keys
        if home_key is not None:
            for i in idxs:
                comp = _binding_comp(rule.conditions[i], home_key)
                if comp is None:
                    continue
                if anchor is None or (comp != Component.ATTR
                                      and anchor[1] == Component.ATTR):
                    anchor = (i, comp)
        for i in idxs:
            c = rule.conditions[i]
            comp = anchor[1] if anchor is not None and i == anchor[0] else None
            views.append((c.fact_type, comp))
            new_conds[i] = dataclasses.replace(
                c, fact_type=view_name(c.fact_type, comp))
    if not views:
        return rule, []
    return (Rule(rule.name, tuple(new_conds), rule.actions, rule.priority),
            views)


# ---------------------------------------------------------------------------
# Shard worker


class _ShardWorker(HiperfactEngine):
    """One shard: a full engine over the owner partition + its views.

    Non-view writes and deletes are routed through the parent — local
    owner rows (and local view copies) apply immediately so the local
    fixpoint keeps running; foreign-owned rows land in the parent's
    outbox for the next frontier exchange.  Arrivals are applied by the
    parent via the *unbound* base-class methods, bypassing this router.
    """

    def __init__(self, config: EngineConfig, shard: int, n_shards: int,
                 parent: "ShardedEngine") -> None:
        super().__init__(config)
        self.shard = shard
        self.n_shards = n_shards
        self.parent = parent
        # the parent materializes demand cones globally (with frontier
        # exchange) before delegating a query; a worker-local pass would
        # be redundant at best, a local full infer() at worst
        self._demand_skip = True
        # per-shard counters + device-array cache: a fresh Ops instance
        # (get_backend shares one per process; jit caches stay shared)
        self.ops = fresh_backend(config.backend,
                                 compress=config.compress)
        self.store = FactStore(config.index_backend, ops=self.ops)
        self.store.strings = parent.store.strings  # ONE dictionary
        self._result_cache = None  # the parent caches query results

    def _insert_columns(self, ftype, ids, attrs, vals, valtypes,
                        asserted: bool = True) -> int:
        ids, attrs, vals = (x.host() if is_handle(x) else x
                            for x in (ids, attrs, vals))
        ids = np.asarray(ids, np.int32)
        attrs = np.asarray(attrs, np.int32)
        vals = np.asarray(vals, np.int64)
        valtypes = np.asarray(valtypes, np.int8)
        if len(ids) == 0:
            return 0
        return self.parent._route_add(ftype, ids, attrs, vals, valtypes,
                                      src=self.shard, asserted=asserted)

    def _delete_matching(self, ftype, ids, attrs, vals) -> int:
        ids = np.asarray(ids, np.int32)
        attrs = np.asarray(attrs, np.int32)
        vals = np.asarray(vals, np.int64)
        if len(ids) == 0:
            return 0
        return self.parent._route_del(ftype, ids, attrs, vals,
                                      src=self.shard)

    def _apply_counts(self, ftype, ids, attrs, vals, valtypes, net):
        # signed support counts are owner state: rows hashing home apply
        # immediately, foreign rows ride the exchange as _SUP entries
        # (net count packed into the meta lane)
        return self.parent._route_counts(ftype, ids, attrs, vals, valtypes,
                                         net, src=self.shard)

    def _on_deaths(self, ftype, table, d0) -> None:
        # support collapse / scrub killed owner rows outside the delete
        # router: their view copies on every shard must die too
        if not ftype.startswith(VIEW_PREFIX):
            self.parent._route_view_dels(self.shard, ftype, table, d0)

    def _scrub(self, rules_reset, out_types, stats) -> None:
        # derived rows of the scrubbed types live on EVERY shard — a
        # local over-delete/re-derive would leave the other partitions
        # (and their view copies) stale, so scrubs are global
        self.parent._global_scrub(self.shard, rules_reset, out_types, stats)


# ---------------------------------------------------------------------------
# Sharded engine


class ShardedEngine(HiperfactEngine):
    """Hash-partitioned engine over N shard workers + frontier exchange.

    Constructed automatically by ``HiperfactEngine(config)`` whenever
    ``config.shards`` resolves to N > 1.  The public API is unchanged;
    ``self.store`` holds only the shared string dictionary (fact rows
    live in ``self.workers[*].store``).
    """

    def __init__(self, config: EngineConfig | None = None) -> None:
        config = config or EngineConfig()
        super().__init__(dataclasses.replace(config, shards=1))
        self.config = config
        self.n_shards = _resolve_shards(config)
        wcfg = dataclasses.replace(config, shards=1)
        self.workers = [_ShardWorker(wcfg, s, self.n_shards, self)
                        for s in range(self.n_shards)]
        # ftype -> registered view components (None = replicated)
        self._views: dict[str, set] = {}
        self._table_ids: dict[str, int] = {}
        self._table_names: list[str] = []
        self._outbox: list[list] = [[] for _ in range(self.n_shards)]
        self._lock = threading.Lock()
        from repro_torch.distributed.pipeline import FrontierExchange
        # the device transport takes CUDA devices only: ``torch-cpu``
        # and ``numpy`` permute on the host (a caller may replace the
        # exchange with one given an explicit device list)
        self.exchange = FrontierExchange(
            self.n_shards, prefer_device=config.backend == "torch",
            compress=config.compress)
        self.exchange_log: list[dict] = []
        # per-types-tuple memo of gathered snapshots, invalidated by the
        # shard version-token vector (repeat non-decomposable queries
        # skip the re-gather)
        self._gather_memo: dict[tuple, tuple] = {}
        self._scrub_sync = False   # inside _global_scrub: view dels apply
        self._scrub_round = False  # a scrub reset rules this round
        self._worker_requery = False  # delta query nodes live on workers

    # ------------------------------------------------------------------ API
    def add_rule(self, rule: Rule) -> None:
        self._intern_rule_constants(rule)
        self.rules.append(rule)  # originals, for introspection
        home = _pick_home(rule)
        wrule, views = _rewrite_rule(rule, home)
        self._register_views(views)
        if home is None:
            # no variable-keyed island: every condition replicated, so
            # one shard must own the (constant-anchored) derivation
            self.workers[0].add_rule(wrule)
        else:
            for w in self.workers:
                w.add_rule(wrule)

    def infer(self) -> InferStats:
        """Global fixpoint: local fixpoints + frontier exchanges until no
        shard derives anything that changes any other shard."""
        t0 = time.perf_counter()
        agg = InferStats()
        rounds = 0
        while rounds < self.config.max_iterations:
            rounds += 1
            worker_secs = []
            for w in self.workers:
                st = w.infer()
                worker_secs.append(st.seconds)
                agg.rules_evaluated += st.rules_evaluated
                agg.rules_skipped_inactive += st.rules_skipped_inactive
                agg.rules_skipped_unchanged += st.rules_skipped_unchanged
                agg.facts_inferred += st.facts_inferred
                agg.facts_deleted += st.facts_deleted
                agg.rows_considered += st.rows_considered
                agg.rows_emitted += st.rows_emitted
                agg.delta_passes += st.delta_passes
                agg.neg_passes += st.neg_passes
                agg.full_evals += st.full_evals
                agg.facts_retracted += st.facts_retracted
                agg.compensated_deletes += st.compensated_deletes
                agg.dred_scrubs += st.dred_scrubs
                agg.replans += st.replans
                agg.sketch_hits += st.sketch_hits
                agg.sketch_misses += st.sketch_misses
            fresh, changed, log = self._flush_outbox("infer")
            agg.facts_inferred += log["owner_fresh"]
            agg.facts_deleted += log["owner_deleted"]
            agg.facts_retracted += log["retracted"]
            agg.rounds.append({
                "round": rounds,
                "worker_seconds": worker_secs,
                "critical_path_s": max(worker_secs) if worker_secs else 0.0,
                "a2a_rows": log["rows"],
                "a2a_payload_bytes": log["payload_bytes"],
                "a2a_padded_bytes": log["padded_bytes"],
                "a2a_bytes_raw": log["payload_bytes"],
                "a2a_bytes_wire": log.get("payload_bytes_wire",
                                          log["payload_bytes"]),
                "applied_fresh": changed,
            })
            if changed == 0 and not self._scrub_round:
                # a scrub resets rules on ALL workers, including ones
                # that already ran this round — force one more round so
                # their counting re-init happens before convergence
                break
            self._scrub_round = False
        agg.iterations = rounds
        agg.seconds = time.perf_counter() - t0
        self.last_infer = agg
        return agg

    def _demand_materialize(self, conditions: list[Condition]) -> None:
        """Sharded demand cone: one ``DemandEvaluator`` per worker
        (demand keys through ``base_fact_type``, so the workers'
        view-rewritten rules restrict like the originals), alternating
        local propagate+evaluate sweeps with frontier exchanges.  Only
        cone facts are ever routed, so the exchange rounds carry cone
        deltas instead of the full closure's frontier."""
        from repro_torch.core.demand import DemandEvaluator
        evs = [DemandEvaluator(w, list(conditions)) for w in self.workers]
        if not any(ev.cone_rules for ev in evs):
            return
        # deletes between queries: mirror the unsharded engine's demand
        # death-frontier check — a triggered worker escalates to the
        # global scrub, so no shard serves retracted derivations
        for w in self.workers:
            w._check_death_frontiers(self.last_infer)
        memo_key = self._result_cache.key(conditions, ()) \
            if self._result_cache is not None else None
        cone_types = set().union(*(ev.cone_types for ev in evs))
        if memo_key is not None:
            token = self._query_version_token(cone_types)
            if self._demand_done.get(memo_key) == token:
                return
        stats = self.last_infer
        fallback = next((ev.fallback for ev in evs
                         if ev.fallback is not None), None)
        if fallback is not None:
            self.infer()
            self.last_infer.demand_fallbacks += 1
        else:
            rounds = 0
            exchanged = 0
            while rounds < self.config.max_iterations:
                rounds += 1
                changed = sum(ev.round() for ev in evs)
                # demand frontiers discovered on one shard must reach
                # the shards owning the next hop's rows
                for a in evs:
                    for b in evs:
                        if a is not b and a.merge_from(b):
                            changed += 1
                fresh, applied, _log = self._flush_outbox("demand")
                exchanged += fresh
                with self._lock:
                    pending = any(self._outbox)
                if changed == 0 and applied == 0 and not pending:
                    break
            stats.demand_rounds += rounds
            stats.demand_cone_rows += (
                sum(ev.facts_written for ev in evs) + exchanged)
            stats.rows_considered += sum(ev.rows_considered for ev in evs)
            for w in self.workers:
                w._drain_sketch_counts(stats)
        if memo_key is not None:
            self._demand_done[memo_key] = self._query_version_token(
                cone_types)

    def query(self, conditions: list[Condition], decode: bool = True):
        rule = Rule("<adhoc>", tuple(conditions))
        if self.config.eval_mode == "demand" and self.rules:
            self._demand_materialize(list(conditions))
        key = None
        if decode and self._result_cache is not None:
            key = self._result_cache.key(
                conditions, self._query_version_token(rule.input_types()))
            hit = self._result_cache.lookup(key) if key is not None else None
            if hit is not None:
                self.last_infer.query_cache_hits += 1
                return [dict(r) for r in hit]
            if key is not None:
                self.last_infer.query_cache_misses += 1
        groups = _island_groups(rule)
        single_var_island = (len(groups) == 1 and
                             all(isinstance(k, str) for k in groups))
        if self._worker_requery and len(rule.conditions) == 1:
            # a single-condition query hits one owner-partitioned table:
            # per-shard results are disjoint regardless of island keys,
            # so the union route is sound — and it is the route that
            # engages the per-worker delta query nodes (the gathered
            # snapshot would re-gather on every moved watermark)
            single_var_island = True
        if decode and single_var_island:
            # one island == one id variable: each id's rows live on one
            # shard, so per-shard results are disjoint — a plain union
            rows = []
            for w in self.workers:
                rows.extend(HiperfactEngine.query(w, conditions, decode=True))
        else:
            cfg = self.config
            gst = self._gathered_store(sorted(rule.input_types()))
            bindings = evaluate_rule(
                gst, rule, join_algo=cfg.join, rnl_mode=cfg.rnl,
                layout=cfg.layout, sort_mode=cfg.sort_mode, distinct=True,
                ops=self.ops, pipeline=False,
                planner=self._sketch_planner())
            if not decode:
                return bindings
            rows = decode_bindings(gst, conditions, bindings)
        if key is not None:
            self._result_cache.put(key, rows)
        return rows

    def num_facts(self) -> int:
        """Alive owner-table facts across all shards (views excluded)."""
        return sum(int(t.alive.sum())
                   for w in self.workers
                   for name, t in w.store.tables.items()
                   if not name.startswith(VIEW_PREFIX))

    def resident_facts(self) -> int:
        """Total resident rows incl. view copies — the capacity metric
        that scales with shard count."""
        return sum(t.n for w in self.workers
                   for t in w.store.tables.values())

    def shard_bytes(self) -> list[int]:
        return [w.store.memory_bytes() for w in self.workers]

    def _query_version_token(self, types) -> tuple:
        out = []
        for t in sorted(types):
            for w in self.workers:
                tab = w.store.tables.get(t)
                out.append((t, w.shard) + ((tab.version, tab.data_version)
                                           if tab is not None else (-1, -1)))
        return tuple(out)

    def enable_delta_requery(self, on: bool = True) -> None:
        """Delta query nodes live per worker: the decomposable-query
        union path delegates to ``HiperfactEngine.query`` on each
        worker, whose node then folds only that shard's ±frontier
        windows.  The parent holds no fact tables, so it keeps no nodes
        of its own (its result cache still serves exact-token repeats)."""
        self._worker_requery = bool(on)
        for w in self.workers:
            w.enable_delta_requery(on)

    def requery_stats(self) -> dict:
        agg = {"tracked_queries": 0, "full_evals": 0, "delta_folds": 0,
               "delta_passes": 0, "rebuilds": 0}
        for w in self.workers:
            for k, v in w.requery_stats().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    # ---------------------------------------------------------------- write
    def _insert_columns(self, ftype, ids, attrs, vals, valtypes,
                        asserted: bool = True) -> int:
        ids, attrs, vals = (x.host() if is_handle(x) else x
                            for x in (ids, attrs, vals))
        ids = np.asarray(ids, np.int32)
        attrs = np.asarray(attrs, np.int32)
        vals = np.asarray(vals, np.int64)
        valtypes = np.asarray(valtypes, np.int8)
        if len(ids) == 0:
            return 0
        self._route_add(ftype, ids, attrs, vals, valtypes, src=None,
                        asserted=asserted)
        fresh, _deleted = self._flush_until_drained("load")
        if fresh:
            self._type_version[ftype] = self._type_version.get(ftype, 0) + 1
        return fresh

    def _delete_matching(self, ftype, ids, attrs, vals) -> int:
        ids = np.asarray(ids, np.int32)
        attrs = np.asarray(attrs, np.int32)
        vals = np.asarray(vals, np.int64)
        if len(ids) == 0:
            return 0
        self._route_del(ftype, ids, attrs, vals, src=None)
        # owner deaths fan out view retirements one exchange hop later,
        # so drain the outbox completely before returning
        _fresh, deleted = self._flush_until_drained("delete")
        return deleted

    def _flush_until_drained(self, phase: str) -> tuple[int, int]:
        fresh = deleted = 0
        while True:
            f, _changed, log = self._flush_outbox(phase)
            fresh += f
            deleted += log["owner_deleted"]
            with self._lock:
                pending = any(self._outbox)
            if not pending:
                return fresh, deleted

    # --------------------------------------------------------------- router
    def _targets(self, ftype, ids, attrs, vals):
        """(table name, owner shard per row | None=broadcast) for the
        owner copy + every registered view of ``ftype``."""
        D = self.n_shards
        targets = [(ftype, shard_of(ids, D))]
        for comp in self._views.get(ftype, ()):
            if comp is None:
                targets.append((view_name(ftype, None), None))
            else:
                col = (ids, attrs, vals)[int(comp)]
                targets.append((view_name(ftype, comp), shard_of(col, D)))
        return targets

    def _route_add(self, ftype, ids, attrs, vals, valtypes, src,
                   asserted: bool = True) -> int:
        """Partition an insert batch into owner + view copies.  Rows for
        shard ``src`` (the caller) apply immediately so its local
        fixpoint continues; the rest go to the outbox.  Returns the
        locally inserted fresh owner-row count.

        Counting state (support/asserted) lives on the OWNER row only:
        view copies always insert as plain asserted rows and are retired
        exclusively by ``_route_view_dels`` when their owner row dies."""
        wrote = 0
        okind = _ADD if asserted else _ADD_DERIVED
        for tname, owner in self._targets(ftype, ids, attrs, vals):
            is_view = tname != ftype
            kind = _ADD if is_view else okind
            for d in range(self.n_shards):
                if owner is None:
                    part = (ids, attrs, vals, valtypes)
                else:
                    m = owner == d
                    if not m.any():
                        continue
                    part = (ids[m], attrs[m], vals[m], valtypes[m])
                if src is not None and d == src:
                    n = HiperfactEngine._insert_columns(
                        self.workers[d], tname, *part,
                        asserted=is_view or asserted)
                    if not is_view:
                        wrote += n
                else:
                    self._enqueue(src or 0, d, tname, kind, part)
        return wrote

    def _route_del(self, ftype, ids, attrs, vals, src) -> int:
        """Route explicit deletes to the OWNER partition only.  The
        owner decides the outcome: a retraction absorbed by surviving
        derivation support (compensated delete) leaves the row — and
        therefore every view copy — alive; actual deaths fan out to the
        views via ``_route_view_dels``."""
        deleted = 0
        zeros = np.zeros(len(ids), np.int8)
        owner = shard_of(ids, self.n_shards)
        for d in range(self.n_shards):
            m = owner == d
            if not m.any():
                continue
            part = (ids[m], attrs[m], vals[m], zeros[:int(m.sum())])
            if src is not None and d == src:
                deleted += self._apply_del_local(
                    d, ftype, part[0], part[1], part[2])
            else:
                self._enqueue(src or 0, d, ftype, _DEL, part)
        return deleted

    def _apply_del_local(self, d, tname, ids, attrs, vals) -> int:
        """Apply an owner-table delete on shard ``d`` and fan the actual
        deaths (dellog growth) out to the registered views."""
        w = self.workers[d]
        tab = w.store.tables.get(tname)
        d0 = tab.dellog_n if tab is not None else 0
        n = HiperfactEngine._delete_matching(w, tname, ids, attrs, vals)
        if n and tab is not None and not tname.startswith(VIEW_PREFIX):
            self._route_view_dels(d, tname, tab, d0)
        return n

    def _route_counts(self, ftype, ids, attrs, vals, valtypes, net, src):
        """Partition a signed support batch by owner shard.  The local
        part applies immediately; foreign rows ride the exchange as
        ``_SUP`` entries with the net count packed into meta bits
        32..63.  Returns (fresh rows, dead rows) applied locally."""
        nn = nd = 0
        owner = shard_of(ids, self.n_shards)
        for d in range(self.n_shards):
            m = owner == d
            if not m.any():
                continue
            if src is not None and d == src:
                a, b = self._apply_counts_local(
                    d, ftype, ids[m], attrs[m], vals[m], valtypes[m], net[m])
                nn += a
                nd += b
            else:
                self._enqueue(src or 0, d, ftype, _SUP,
                              (ids[m], attrs[m], vals[m], valtypes[m],
                               net[m]))
        return nn, nd

    def _apply_counts_local(self, d, ftype, ids, attrs, vals, valtypes,
                            net) -> tuple[int, int]:
        """Apply signed support deltas to shard ``d``'s owner table and
        propagate the consequences: fresh derived rows get view copies
        enqueued; deaths reach the views via the worker's ``_on_deaths``
        override (fired inside the base ``_apply_counts``)."""
        if len(ids) > 1:
            # several workers may derive the same fact: their _SUP
            # batches concatenate in one exchange group, but the base
            # _apply_counts requires one row per fact — re-aggregate
            order = np.lexsort((vals, attrs, ids))
            ids, attrs, vals, valtypes, net = (
                x[order] for x in (ids, attrs, vals, valtypes, net))
            starts = np.empty(len(ids), bool)
            starts[0] = True
            starts[1:] = ((ids[1:] != ids[:-1]) | (attrs[1:] != attrs[:-1])
                          | (vals[1:] != vals[:-1]))
            first = np.flatnonzero(starts)
            net = np.add.reduceat(net, first).astype(np.int32)
            keep = net != 0
            first = first[keep]
            net = net[keep]
            ids, attrs, vals, valtypes = (x[first] for x in
                                          (ids, attrs, vals, valtypes))
        if len(ids) == 0:
            return 0, 0
        w = self.workers[d]
        tab = w.store.table(ftype)
        n0 = tab.n
        nn, nd = HiperfactEngine._apply_counts(
            w, ftype, ids, attrs, vals, valtypes, net)
        if tab.n > n0 and self._views.get(ftype):
            rows = np.arange(n0, tab.n)
            self._route_view_adds(d, ftype, tab.ids[rows], tab.attrs[rows],
                                  tab.vals[rows], tab.valtypes[rows])
        return nn, nd

    def _route_view_adds(self, src, ftype, ids, attrs, vals, valtypes
                         ) -> None:
        """Enqueue view copies (always plain asserted rows) of freshly
        materialized owner rows for every registered view of ``ftype``."""
        D = self.n_shards
        for comp in self._views.get(ftype, ()):
            vname = view_name(ftype, comp)
            if comp is None:
                owner = None
            else:
                owner = shard_of((ids, attrs, vals)[int(comp)], D)
            for d in range(D):
                if owner is None:
                    part = (ids, attrs, vals, valtypes)
                else:
                    m = owner == d
                    if not m.any():
                        continue
                    part = (ids[m], attrs[m], vals[m], valtypes[m])
                self._enqueue(src, d, vname, _ADD, part)

    def _route_view_dels(self, src, ftype, table, d0) -> None:
        """Owner rows ``table.dellog[d0:]`` just died on shard ``src``:
        enqueue matching deletes for every registered view copy.  View
        deaths then grow the destination worker's view-table dellog, so
        its own signed death frontier fires on the next local round.
        During a global scrub the deletes apply synchronously instead
        (a late-arriving copy of a scrub death would re-trigger the
        frontier detector and the scrub would never converge)."""
        comps = self._views.get(ftype)
        if not comps or table.dellog_n <= d0:
            return
        rows = table.dellog[d0:table.dellog_n].astype(np.int64)
        ids = table.ids[rows]
        attrs = table.attrs[rows]
        vals = table.vals[rows]
        zeros = np.zeros(len(rows), np.int8)
        D = self.n_shards
        for comp in comps:
            vname = view_name(ftype, comp)
            if comp is None:
                owner = None
            else:
                owner = shard_of((ids, attrs, vals)[int(comp)], D)
            for d in range(D):
                if owner is None:
                    part = (ids, attrs, vals, zeros)
                else:
                    m = owner == d
                    if not m.any():
                        continue
                    part = (ids[m], attrs[m], vals[m], zeros[:int(m.sum())])
                if self._scrub_sync:
                    HiperfactEngine._delete_matching(
                        self.workers[d], vname, part[0], part[1], part[2])
                else:
                    self._enqueue(src, d, vname, _DEL, part)

    def _global_scrub(self, src, rules_reset, out_types, stats) -> None:
        """DRed scrub across all shards.  The initiating worker hit an
        ambiguous death frontier; derived rows of the closure types are
        hash-scattered, so every worker over-deletes and resets.  Runs
        synchronously (in-process control — only data rows ride the
        exchange): view copies of scrub-killed rows are retired
        directly and their dellog cursors pre-acknowledged, mirroring
        the single-engine invariant that scrub deaths never re-trigger
        the frontier detector."""
        if self._scrub_sync:
            return  # re-entrant call from a worker being broadcast to
        self._scrub_sync = True
        try:
            closure = set(out_types)
            for w in self.workers:
                if w.shard == src:
                    rr, ot, st = rules_reset, out_types, stats
                else:
                    rr, ot = w.trees().downstream(out_types)
                    st = InferStats()  # counted once, on the initiator
                closure |= ot
                if rr or ot:
                    HiperfactEngine._scrub(w, rr, ot, st)
            for w in self.workers:
                for name, tab in w.store.tables.items():
                    if (name.startswith(VIEW_PREFIX)
                            and base_fact_type(name) in closure):
                        w._dellog_seen[name] = tab.dellog_n
        finally:
            self._scrub_sync = False
        self._scrub_round = True

    def _tid(self, name: str) -> int:
        tid = self._table_ids.get(name)
        if tid is None:
            tid = self._table_ids[name] = len(self._table_names)
            self._table_names.append(name)
        return tid

    def _enqueue(self, src: int, dest: int, tname: str, kind: int,
                 part: tuple) -> None:
        with self._lock:
            tid = self._tid(tname)
            self._outbox[src].append((dest, tid, kind) + part)

    def _register_views(self, views) -> None:
        for ftype, comp in views:
            have = self._views.setdefault(ftype, set())
            if comp in have:
                continue
            have.add(comp)
            self._backfill_view(ftype, comp)

    def _backfill_view(self, ftype, comp) -> None:
        """Seed a freshly registered view from rows already resident."""
        vname = view_name(ftype, comp)
        D = self.n_shards
        queued = False
        for w in self.workers:
            tab = w.store.tables.get(ftype)
            if tab is None or tab.n == 0:
                continue
            rows = tab.all_rows()
            if len(rows) == 0:
                continue
            ids = tab.ids[rows]
            attrs = tab.attrs[rows]
            vals = tab.vals[rows]
            valtypes = tab.valtypes[rows]
            if comp is None:
                owner = None
            else:
                owner = shard_of((ids, attrs, vals)[int(comp)], D)
            for d in range(D):
                if owner is None:
                    part = (ids, attrs, vals, valtypes)
                else:
                    m = owner == d
                    if not m.any():
                        continue
                    part = (ids[m], attrs[m], vals[m], valtypes[m])
                self._enqueue(w.shard, d, vname, _ADD, part)
                queued = True
        if queued:
            self._flush_outbox("backfill")

    # ------------------------------------------------------------- exchange
    def _flush_outbox(self, phase: str) -> tuple[int, int, dict]:
        """Run one frontier exchange over the queued rows and apply the
        arrivals.  Returns (fresh owner-table inserts, total applied
        changes incl. view tables, log dict)."""
        with self._lock:
            outbox, self._outbox = (self._outbox,
                                    [[] for _ in range(self.n_shards)])
        D = self.n_shards
        dest, key, val, meta = [], [], [], []
        for s in range(D):
            entries = outbox[s]
            if not entries:
                e64 = np.empty(0, np.int64)
                dest.append(np.empty(0, np.int32))
                key.append(e64)
                val.append(e64)
                meta.append(e64)
                continue
            ds, ks, vs, ms = [], [], [], []
            for entry in entries:
                d, tid, kind, ids, attrs, vals, valtypes = entry[:7]
                n = len(ids)
                ds.append(np.full(n, d, np.int32))
                ks.append((ids.astype(np.int64) << 32)
                          | (attrs.astype(np.int64) & 0xFFFFFFFF))
                vs.append(vals)
                mm = (np.full(n, (tid << 16) | (kind << 8), np.int64)
                      | (valtypes.astype(np.int64) & 0xFF))
                if len(entry) == 8:  # _SUP: signed net count, bits 32..63
                    mm |= entry[7].astype(np.int64) << 32
                ms.append(mm)
            dest.append(np.concatenate(ds))
            key.append(np.concatenate(ks))
            val.append(np.concatenate(vs))
            meta.append(np.concatenate(ms))
        recv, stats = self.exchange.exchange(dest, key, val, meta)
        owner_fresh = owner_deleted = retracted = changed = 0
        for d in range(D):
            k, v, m = recv[d]
            if len(k) == 0:
                continue
            tids = ((m >> 16) & 0xFFFF).astype(np.int64)
            kinds = ((m >> 8) & 0xFF).astype(np.int64)
            vts = (m & 0xFF).astype(np.int8)
            counts = (m >> 32).astype(np.int32)  # arithmetic: sign kept
            ids = (k >> 32).astype(np.int32)
            attrs = (k & 0xFFFFFFFF).astype(np.int32)
            gkey = tids * 4 + kinds
            for g in np.unique(gkey):
                sel = gkey == g
                tname = self._table_names[int(g) >> 2]
                kind = int(g) & 3
                is_view = tname.startswith(VIEW_PREFIX)
                if kind == _DEL:
                    if is_view:
                        n = HiperfactEngine._delete_matching(
                            self.workers[d], tname,
                            ids[sel], attrs[sel], v[sel])
                    else:
                        n = self._apply_del_local(
                            d, tname, ids[sel], attrs[sel], v[sel])
                        owner_deleted += n
                    changed += n
                elif kind == _SUP:
                    nn, nd = self._apply_counts_local(
                        d, tname, ids[sel], attrs[sel], v[sel],
                        vts[sel], counts[sel])
                    changed += nn + nd
                    owner_fresh += nn
                    owner_deleted += nd
                    retracted += nd
                else:  # _ADD / _ADD_DERIVED (view copies were enqueued
                    # by _route_add alongside this owner copy)
                    n = HiperfactEngine._insert_columns(
                        self.workers[d], tname, ids[sel], attrs[sel],
                        v[sel], vts[sel], asserted=(kind == _ADD))
                    changed += n
                    if not is_view:
                        owner_fresh += n
        log = {"phase": phase, **stats, "owner_fresh": owner_fresh,
               "owner_deleted": owner_deleted, "retracted": retracted,
               "applied": changed}
        self.exchange_log.append(log)
        return owner_fresh, changed, log

    # ---------------------------------------------------------------- query
    def _gathered_store(self, types: list[str]) -> FactStore:
        """Union of the owner partitions of ``types`` (multi-island
        ad-hoc queries evaluate against this; owner partitions are
        disjoint, so no dedup is needed).  Memoized per version token."""
        types = tuple(types)
        token = self._query_version_token(types)
        memo = self._gather_memo.get(types)
        if memo is not None and memo[0] == token:
            self.last_infer.gather_hits += 1
            return memo[1]
        self.last_infer.gather_misses += 1
        gst = FactStore(self.config.index_backend, ops=self.ops)
        gst.strings = self.store.strings
        for t in types:
            for w in self.workers:
                tab = w.store.tables.get(t)
                if tab is None or tab.n == 0:
                    continue
                rows = tab.all_rows()
                if len(rows) == 0:
                    continue
                gst.table(t).insert(tab.ids[rows], tab.attrs[rows],
                                    tab.vals[rows], tab.valtypes[rows],
                                    dedup=False)
        self._gather_memo[types] = (token, gst)
        return gst


# ---------------------------------------------------------------------------
# Parity helpers (tests + benchmarks)


def iter_decoded_facts(engine: HiperfactEngine):
    """Yield every alive fact fully decoded, from a plain or sharded
    engine (owner tables only — view copies are infrastructure)."""
    if isinstance(engine, ShardedEngine):
        stores = [w.store for w in engine.workers]
    else:
        stores = [engine.store]
    for st in stores:
        for ftype, tab in st.tables.items():
            if ftype.startswith(VIEW_PREFIX):
                continue
            for r in np.flatnonzero(tab.alive):
                vt = ValueType(int(tab.valtypes[r]))
                yield (ftype,
                       st.strings.lookup_id(int(tab.ids[r])),
                       st.strings.lookup_id(int(tab.attrs[r])),
                       repr(decode_value(int(tab.vals[r]), vt, st.strings)),
                       int(vt))


def decoded_fact_checksum(engine: HiperfactEngine) -> int:
    """Order-independent crc32 over the decoded fact set — identical for
    ``shards=1`` and ``shards=N`` runs of the same workload."""
    lines = sorted("\t".join(map(str, f)) for f in iter_decoded_facts(engine))
    return zlib.crc32("\n".join(lines).encode())
