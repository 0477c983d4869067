"""HiperfactEngine — the full inference + query loop (paper Fig. 5).

Pulls together: the rank-1 indexed fact store (§2.2), island fact processing
(§2.3), and derivation trees (§2.4) into the inference loop of Fig. 1:
facts modified -> active rules (re-)evaluated level by level -> inferred
facts written (deduplicated) -> repeat until fixpoint.

Configuration axes mirror the paper's internal evaluation (Table 1):
index backend (AI/HI/LPIM/LPID) × join (HJ/MJ) × RNL (AR/DR) × result layout
(CR/RR) × tree execution (PF/SF) × index write (PW/SW) × unique filter
(SU/HU) × condition ordering (sort keys / fixed sort).  Presets ``infer1``
(LPIM+HJ/AR/CR+PF/PW/SU) and ``query1`` (AI+MJ/AR/CR+PF/PW/SU) match Table 1.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.backend import Ops, get_backend, is_handle
from repro_torch.core.conditions import (AddAction, Condition, DeleteAction,
                                         ExternalAction, Rule, is_var)
from repro_torch.core.derivation import DerivationTrees, build_derivation_trees
from repro_torch.core.facts import (Fact, ValueType, decode_value, encode_value,
                                    facts_to_columns)
from repro_torch.core.islands import (_dead_window_rows, _frontier_rows,
                                      build_islands, evaluate_rule)
from repro_torch.core.joins import Bindings
from repro_torch.core.store import FactStore, TypedFactTable, base_fact_type


@dataclasses.dataclass
class EngineConfig:
    """Configuration axes of the engine (paper Table 1 + the repo's
    execution axes).

    The paper axes select *algorithms*: ``index_backend`` (rank-1 index
    family), ``join`` (sort-merge vs radix-hash), ``rnl`` (AR restricts
    each island chain by the bound set; DR defers all restriction to the
    join), ``layout`` (columnar vs row result buffers), ``tree_exec`` /
    ``index_write`` (parallel vs sequential derivation-tree levels and
    index writes), ``unique`` (bulk sort-merge dedup vs incremental
    hashtable), ``sort_mode`` (condition ordering by cardinality sort
    keys vs fixed order).

    The execution axes select *where* those algorithms run (see
    docs/ARCHITECTURE.md for the full matrix):

    * ``backend`` — which ``Ops`` implements the bulk primitives:
      ``torch`` (the default: ``TorchOps`` on the CUDA device, through
      the hand-written kernels; raises without one), ``torch-cpu`` (the
      same ``TorchOps`` on CPU tensors, running the kernels' plain
      PyTorch versions — the CPU test mode) or ``numpy`` host twins.
    * ``device_pipeline`` — route the island join chain and write-side
      dedup through device-resident ``DeviceCol`` handles (``auto``
      follows ``Ops.prefer_handles``: on for the torch backends).
    * ``eval_mode`` — fixpoint rounds re-evaluate rules in ``full``, or
      semi-naive over append frontiers (``delta``); ``auto`` picks per
      rule per round and reverts to full where semi-naive cannot win.
      ``demand`` is not ported yet (ROADMAP A7) and raises.
    * ``query_cache`` / ``lazy`` — the paper §5 rank-N result cache and
      Defs. 10/11 active-rule pruning.
    * ``shards`` — the hash-partitioned engine is not ported yet
      (ROADMAP A9): a count above 1 raises ``NotImplementedError``;
      ``"auto"`` resolves to ``torch.cuda.device_count()`` on the
      ``torch`` backend and 1 elsewhere.
    * ``result_cache`` — repeat-query fast path: decoded results of
      ``query()`` are memoized per (conditions, input-table versions)
      and re-served without re-entering evaluation.  Disabled when
      ``query_cache`` is on (the rank-N cache memoizes inside
      evaluation and must see every query to earn its hits).
    """

    index_backend: str = "AI"     # AI | HI | LPIM | LPID
    join: str = "MJ"              # MJ | HJ
    rnl: str = "AR"               # AR | DR
    layout: str = "CR"            # CR | RR
    tree_exec: str = "PF"         # PF (parallel level queries) | SF
    index_write: str = "PW"       # PW (parallel per-out-group) | SW
    unique: str = "SU"            # SU (sort-merge) | HU (incremental hash)
    sort_mode: str = "sortkeys"   # sortkeys | fixed | sketch
    backend: str = "torch"        # torch (CUDA) | torch-cpu | numpy
    device_pipeline: str = "auto"  # auto | on | off — handle-tier join core
    eval_mode: str = "auto"       # full | delta | auto — semi-naive rounds
    #                               ("demand" raises: ROADMAP A7)
    query_cache: bool = False     # rank-2/3 result cache (paper §5 fut. work)
    lazy: bool = False            # Defs. 10/11 active-rule pruning
    max_iterations: int = 1000
    max_workers: int = 8
    shards: int | str = 1         # 1 | N | "auto" — hash-partitioned engine
    result_cache: bool = True     # repeat-query (version-keyed) fast path
    compress: bool | None = None  # device-resident column codecs (None:
    #                               REPRO_COMPRESS env, default on)

    @staticmethod
    def infer1(backend: str = "torch") -> "EngineConfig":
        return EngineConfig(index_backend="LPIM", join="HJ", rnl="AR",
                            layout="CR", tree_exec="PF", index_write="PW",
                            unique="SU", backend=backend)

    @staticmethod
    def query1(backend: str = "torch") -> "EngineConfig":
        return EngineConfig(index_backend="AI", join="MJ", rnl="AR",
                            layout="CR", tree_exec="PF", index_write="PW",
                            unique="SU", backend=backend)

    def label(self) -> str:
        return (f"{self.index_backend}+{self.join}/{self.rnl}/{self.layout}"
                f"+{self.tree_exec}/{self.index_write}/{self.unique}"
                f"@{self.backend}")


@dataclasses.dataclass
class InferStats:
    """Observability record returned by ``HiperfactEngine.infer()``.

    ``iterations`` counts fixpoint rounds; ``rules_evaluated`` /
    ``rules_skipped_inactive`` / ``rules_skipped_unchanged`` decompose
    scheduling (Defs. 10/11 pruning and per-type version tracking);
    ``facts_inferred`` / ``facts_deleted`` are write-side outcomes
    *after* dedup.  The semi-naive fields below measure the delta
    machinery: backend-level transfer/sort-work counters live on the
    ``Ops`` instance (``ops.transfers``, ``ops.sort_work``,
    ``ops.cache.stats()``), not here.
    """

    iterations: int = 0
    rules_evaluated: int = 0
    rules_skipped_inactive: int = 0
    rules_skipped_unchanged: int = 0
    facts_inferred: int = 0
    facts_deleted: int = 0
    seconds: float = 0.0
    # semi-naive observability: how much each fixpoint round actually
    # touched (rows fetched by condition lookups) vs produced (facts
    # written), plus how evaluations split between delta passes and full
    # re-evaluations.  ``rounds`` holds one dict per iteration.
    rows_considered: int = 0
    rows_emitted: int = 0
    delta_passes: int = 0
    full_evals: int = 0
    rounds: list = dataclasses.field(default_factory=list)
    # signed-frontier observability: −frontier passes run, derived facts
    # that died when their support collapsed, explicit deletes absorbed
    # by surviving support (compensated — fact set unchanged), and
    # DRed-style over-delete/re-derive scrubs (recursive/tainted regions
    # where counting is ambiguous)
    neg_passes: int = 0
    facts_retracted: int = 0
    compensated_deletes: int = 0
    dred_scrubs: int = 0
    # repeat-query fast path (EngineConfig.result_cache): queries served
    # straight from the decoded-result cache vs evaluated
    query_cache_hits: int = 0
    query_cache_misses: int = 0
    # sharded non-decomposable queries: gathered-snapshot memo hits
    # (repeat query at unchanged per-shard version tokens skips the
    # re-gather) vs rebuilds
    gather_hits: int = 0
    gather_misses: int = 0
    # demand-driven evaluation (eval_mode="demand"): rows materialized
    # into the query's cone, propagate+evaluate sweeps to the joint
    # fixpoint, and queries that fell back to a full infer() because the
    # cone could not be restricted soundly
    demand_cone_rows: int = 0
    demand_rounds: int = 0
    demand_fallbacks: int = 0
    # sketch-driven adaptive planning (sort_mode="sketch"): mid-rule
    # re-plans after >4x cardinality drift, and cardinality-sketch cache
    # hits/misses in the planner
    replans: int = 0
    sketch_hits: int = 0
    sketch_misses: int = 0


def _pack_keys(ids: np.ndarray, attrs: np.ndarray) -> np.ndarray:
    return (np.asarray(ids).astype(np.int64) << 32) | (
        np.asarray(attrs).astype(np.int64) & 0xFFFFFFFF)


class _PackedKeyMemo:
    """Per-engine memo of each table's packed (id, attr) key column.

    The SU write path and the delete path anti-join every batch against
    the *whole* table's packed keys; without memoization that column is
    re-packed (host) and re-uploaded (device) per batch.  Columns are
    append-only and version-stamped, so the memo extends incrementally and
    the device backend keeps its copy resident under the same
    ``(table.uid, version)`` identity.
    """

    def __init__(self) -> None:
        self._memo: dict[int, tuple[int, np.ndarray]] = {}

    def keys_for(self, table: TypedFactTable) -> np.ndarray:
        cached = self._memo.get(table.uid)
        if cached is not None and cached[0] == table.version:
            return cached[1]
        if cached is not None and len(cached[1]) <= table.n:
            old = cached[1]
            keys = np.concatenate([
                old, _pack_keys(table.ids[len(old):],
                                table.attrs[len(old):])])
        else:
            keys = _pack_keys(table.ids, table.attrs)
        self._memo[table.uid] = (table.version, keys)
        return keys


def _match_rows(table: TypedFactTable, ids: np.ndarray, attrs: np.ndarray,
                vals: np.ndarray, ops: Ops | None = None,
                pk_memo: _PackedKeyMemo | None = None) -> np.ndarray:
    """SU-path bulk lookup against the table: vectorized sorted join on
    the packed (id, attr) key with exact val verification.  Returns, per
    batch row, the matching *alive* table row id (or -1): the write side
    uses it both as the dedup mask and as the target for support /
    asserted maintenance."""
    rowof = np.full(len(ids), -1, np.int64)
    if table.n == 0 or len(ids) == 0:
        return rowof
    ops = ops or get_backend("numpy")
    key_new = _pack_keys(ids, attrs)
    if pk_memo is not None:
        key_old = pk_memo.keys_for(table)
    else:
        key_old = _pack_keys(table.ids, table.attrs)
    li, ri = ops.join_pairs(key_new, key_old,
                            rkeys_key=("pk", table.uid),
                            rkeys_version=table.version)
    if len(li) == 0:
        return rowof
    ok = (vals[li] == table.vals[ri]) & table.alive[ri]
    rowof[li[ok]] = ri[ok]
    return rowof


def _mask_existing(table: TypedFactTable, ids: np.ndarray, attrs: np.ndarray,
                   vals: np.ndarray, ops: Ops | None = None,
                   pk_memo: _PackedKeyMemo | None = None) -> np.ndarray:
    """SU-path bulk dedup against the table (see ``_match_rows``)."""
    return _match_rows(table, ids, attrs, vals, ops, pk_memo) >= 0


def _resolve_shards(config: EngineConfig) -> int:
    """Resolve ``EngineConfig.shards`` to a concrete worker count."""
    s = config.shards
    if s is None or s == 1:
        return 1
    if s == "auto":
        if config.backend != "torch":
            return 1
        import torch
        return max(1, torch.cuda.device_count())
    n = int(s)
    if n < 1:
        raise ValueError(f"shards must be >= 1 or 'auto', got {s!r}")
    return n


class HiperfactEngine:
    def __init__(self, config: EngineConfig | None = None) -> None:
        self.config = config or EngineConfig()
        if self.config.eval_mode == "demand":
            raise NotImplementedError(
                "eval_mode='demand' is not ported yet (ROADMAP A7)")
        if self.config.eval_mode not in ("full", "delta", "auto"):
            raise ValueError(
                f"unknown eval_mode: {self.config.eval_mode!r}")
        if _resolve_shards(self.config) > 1:
            raise NotImplementedError(
                "the sharded engine (shards > 1) is not ported yet "
                "(ROADMAP A9)")
        self.ops = get_backend(self.config.backend,
                               compress=self.config.compress)
        self.store = FactStore(self.config.index_backend, ops=self.ops)
        self.rules: list[Rule] = []
        self._trees: DerivationTrees | None = None
        self._type_version: dict[str, int] = {}
        self._rule_seen_versions: dict[int, dict[str, int]] = {}
        # signed semi-naive watermarks: rule -> {ftype: (n, dellog_n)}
        # as of the rule's last evaluation.  The +frontier of a
        # condition is rows [n, table.n); the −frontier is the delete
        # log slice [dellog_n, table.dellog_n) capped below n (deaths of
        # rows the rule never saw alive cancel out of both frontiers).
        self._rule_watermarks: dict[int, dict[str, tuple[int, int]]] = {}
        # counting-mode bookkeeping: whether this engine maintains
        # per-fact support (delta/auto), which types carry *stale*
        # support (outputs of rules that took a non-counting full
        # fallback — deletes reaching them go through the DRed scrub),
        # and how far the scrub detector has read each delete log.
        self._counting = self.config.eval_mode in ("delta", "auto")
        self._count_tainted: set[str] = set()
        self._dellog_seen: dict[str, int] = {}
        self._n_compensated = 0
        self._comp_reported = 0
        self._pk_memo = _PackedKeyMemo()
        self.load_seconds = 0.0
        self.last_infer: InferStats = InferStats()
        from repro_torch.core.querycache import QueryResultCache, RankNCache
        self.query_cache = (RankNCache() if self.config.query_cache
                            else None)
        # the rank-N cache memoizes *inside* evaluation; when the user
        # opted into it, let it see every query instead of serving
        # repeats from the decoded-result layer above it
        self._result_cache = (QueryResultCache()
                              if self.config.result_cache
                              and not self.config.query_cache else None)
        # handle-tier join core: on device backends the island chain and
        # the write-side dedup run on DeviceCol handles end to end
        self._pipeline = (
            bool(getattr(self.ops, "prefer_handles", False))
            if self.config.device_pipeline == "auto"
            else self.config.device_pipeline == "on")
        # delta-aware query nodes (serving tier, opt-in via
        # enable_delta_requery): tracked queries keep signed result
        # counts so a requery at moved watermarks folds only the
        # ±frontier windows instead of re-evaluating the full join
        self._requery_nodes = None
        self._planner = None  # lazy SketchPlanner (sort_mode="sketch")
        self._sketch_seen = (0, 0)  # planner counters already drained

    # ------------------------------------------------------------------ API
    def _intern_rule_constants(self, rule: Rule) -> None:
        """Pre-intern every string constant a rule can touch.

        Evaluation and actions intern lazily, so without this the id a
        constant gets depends on evaluation order — across PF pool
        threads and across shard workers that would make encoded lanes
        (and decoded-fact checksums) order-dependent.  Interning at
        ``add_rule`` pins the assignment to rule-registration order.
        """
        strings = self.store.strings
        for c in rule.conditions:
            for slot in (c.id, c.attr):
                if slot is not None and not is_var(slot):
                    strings.intern(slot)
            if c.val is not None and not is_var(c.val):
                encode_value(c.val, c.valtype, strings)
            for t in c.tests:
                if t.is_const() and isinstance(t.const, str):
                    strings.intern(t.const)
        for a in rule.actions:
            if isinstance(a, ExternalAction):
                continue
            for slot in (a.id, a.attr):
                if slot is not None and not is_var(slot):
                    strings.intern(slot)
            if (a.val is not None and not is_var(a.val)
                    and getattr(a, "compute", None) is None):
                encode_value(a.val, a.valtype, strings)

    def add_rule(self, rule: Rule) -> None:
        self._intern_rule_constants(rule)
        self.rules.append(rule)
        self._trees = None  # derivation trees are rebuilt on rule changes
        self._rule_seen_versions.clear()

    def add_rules(self, rules: list[Rule]) -> None:
        for r in rules:
            self.add_rule(r)

    def insert_facts(self, facts: list[Fact]) -> int:
        t0 = time.perf_counter()
        n = 0
        for ftype, cols in facts_to_columns(facts, self.store.strings).items():
            n += self._insert_columns(
                ftype, cols["id"], cols["attr"], cols["val"], cols["valtype"])
        self.load_seconds += time.perf_counter() - t0
        return n

    def insert_columns(self, ftype: str, ids, attrs, vals, valtypes) -> int:
        t0 = time.perf_counter()
        n = self._insert_columns(ftype, np.asarray(ids, np.int32),
                                 np.asarray(attrs, np.int32),
                                 np.asarray(vals, np.int64),
                                 np.asarray(valtypes, np.int8))
        self.load_seconds += time.perf_counter() - t0
        return n

    def trees(self) -> DerivationTrees:
        if self._trees is None:
            self._trees = build_derivation_trees(self.rules)
        return self._trees

    # ---------------------------------------------------------------- write
    def _insert_columns(self, ftype: str, ids, attrs, vals, valtypes,
                        asserted: bool = True) -> int:
        table = self.store.table(ftype)
        if self.config.unique == "SU":
            if ((is_handle(ids) or is_handle(attrs) or is_handle(vals))
                    and table.n_dead == 0 and not asserted):
                # device pipeline: dedup + anti-join on handles; only
                # genuinely fresh rows are ever downloaded.  Tombstoned
                # tables take the host path (the alive filter is host
                # state the resident columns don't carry); asserted
                # inserts do too (existing matches must be re-marked).
                n = self._insert_handles(table, ids, attrs, vals, valtypes)
            else:
                ids, attrs, vals = (x.host() if is_handle(x) else x
                                    for x in (ids, attrs, vals))
                # parallel-sort-merge unique: batch-dedup then anti-join
                # vs table
                if len(ids) > 1:
                    keep = self.ops.dedup_rows([ids, attrs, vals])
                    ids, attrs, vals, valtypes = (
                        ids[keep], attrs[keep], vals[keep], valtypes[keep])
                rowof = _match_rows(table, ids, attrs, vals, self.ops,
                                    self._pk_memo)
                exists = rowof >= 0
                if exists.any():
                    if asserted:
                        # re-asserting a currently-derived fact: pin it
                        # so support collapse alone cannot kill it
                        table.mark_asserted(rowof[exists])
                    fresh = ~exists
                    ids, attrs, vals, valtypes = (
                        ids[fresh], attrs[fresh], vals[fresh],
                        valtypes[fresh])
                n = table.insert(ids, attrs, vals, valtypes, dedup=False,
                                 asserted=asserted)
        else:  # HU: incremental hashtable dedup inside the table
            ids, attrs, vals = (x.host() if is_handle(x) else x
                                for x in (ids, attrs, vals))
            n = table.insert(ids, attrs, vals, valtypes, dedup=True,
                             asserted=asserted)
        if n:
            self._type_version[ftype] = self._type_version.get(ftype, 0) + 1
        return n

    def _insert_handles(self, table: TypedFactTable, ids, attrs, vals,
                        valtypes, asserted: bool = False) -> int:
        """Write-side SU dedup/anti-join on ``DeviceCol`` handles.

        The batch dedup, the packed-key anti-join against the (resident)
        table columns, and the fresh-row compaction all run on device;
        the host sees only the surviving rows.  At a fixpoint evaluation
        every stage is a uid-keyed memo hit and the fresh count is zero,
        so the whole write costs zero transfers.
        """
        ops = self.ops
        h_ids, h_attrs, h_vals = (ops.as_handle(x)
                                  for x in (ids, attrs, vals))
        valtypes = np.asarray(valtypes, np.int8)
        n = h_ids.n
        if n == 0:
            return 0
        h_sel = ops.iota_h(n)  # surviving rows' positions in the batch
        if n > 1:
            idx, nk = ops.dedup_select_h([h_ids, h_attrs, h_vals])
            if nk < n:
                h_ids = ops.gather_h(h_ids, idx, nk)
                h_attrs = ops.gather_h(h_attrs, idx, nk)
                h_vals = ops.gather_h(h_vals, idx, nk)
                h_sel, n = idx, nk
        if table.n > 0:
            key_new = ops.pack_pairs_h(h_ids, h_attrs)
            fresh = ops.fresh_mask_h(
                key_new, h_vals, self._pk_memo.keys_for(table), table.vals,
                cache_uid=table.uid, version=table.version)
            (h_ids, h_attrs, h_vals, h_sel), n = ops.select_mask_h(
                [h_ids, h_attrs, h_vals, h_sel], fresh)
        if n == 0:
            return 0
        sel = h_sel.host()[:n]
        return table.insert(h_ids.host()[:n], h_attrs.host()[:n],
                            h_vals.host()[:n], valtypes[sel], dedup=False,
                            asserted=asserted)

    def _delete_matching(self, ftype: str, ids, attrs, vals) -> int:
        """Explicit retraction: drop the *assertion* on every matching
        alive row.  Rows whose support is zero die (and enter the delete
        log, so signed frontiers propagate the retraction); rows still
        carried by derivations survive as compensated deletes — the fact
        set, the data_version, and every downstream version token stay
        untouched."""
        table = self.store.tables.get(ftype)
        if table is None or table.n == 0 or len(ids) == 0:
            return 0
        key_t = self._pk_memo.keys_for(table)
        key_d = _pack_keys(ids, attrs)
        li, ri = self.ops.join_pairs(key_d, key_t,
                                     rkeys_key=("pk", table.uid),
                                     rkeys_version=table.version)
        if len(li) == 0:
            return 0
        ok = (np.asarray(vals, np.int64)[li] == table.vals[ri]) & table.alive[ri]
        rows = np.unique(ri[ok])
        if len(rows) == 0:
            return 0
        dead, comp = table.retract_asserted(rows)
        self._n_compensated += comp
        if len(dead):
            self._type_version[ftype] = self._type_version.get(ftype, 0) + 1
        return len(dead)

    def delete_columns(self, ftype: str, ids, attrs, vals) -> int:
        """Public retraction API (column form): delete every alive fact
        of ``ftype`` matching an (id, attr, val) triple.  Returns the
        number of rows that actually died; retractions absorbed by
        surviving derivations are counted in
        ``last_infer.compensated_deletes`` on the next ``infer()``."""
        return self._delete_matching(
            ftype, np.asarray(ids, np.int32), np.asarray(attrs, np.int32),
            np.asarray(vals, np.int64))

    def delete_facts(self, facts: list[Fact]) -> int:
        n = 0
        for ftype, cols in facts_to_columns(facts, self.store.strings).items():
            n += self._delete_matching(ftype, cols["id"], cols["attr"],
                                       cols["val"])
        return n

    # -------------------------------------------------------------- actions
    def _slot_column(self, slot, bindings: Bindings, n: int,
                     valtype: ValueType | None, handles: bool = False):
        """One action slot for all binding rows: a host column, or (on
        the device pipeline) a ``DeviceCol`` — variable slots pass the
        binding handle through untouched and constant slots come from the
        backend's memoized constant pool, so repeated evaluations reuse
        the exact same handles."""
        if is_var(slot):
            if handles:
                return bindings.handle(slot.name, self.ops)
            return np.asarray(bindings.col(slot.name), np.int64)
        if valtype is None:  # id/attr slot: string handle
            v = self.store.strings.intern(slot)
        else:
            v = encode_value(slot, valtype, self.store.strings)
        if handles:
            return self.ops.const_h(v, n)
        return np.full(n, v, np.int64)

    def _cat_parts(self, parts: list[tuple]) -> tuple:
        """Concatenate per-action column tuples, keeping handle columns
        on device (``concat_h``) and materializing only mixed batches."""
        out = []
        for pos, xs in enumerate(zip(*parts)):
            if len(xs) == 1:
                out.append(xs[0])
            elif pos < 3 and any(is_handle(x) for x in xs):
                out.append(self.ops.concat_h(list(xs)))
            else:
                out.append(np.concatenate(
                    [x.host() if is_handle(x) else x for x in xs]))
        return tuple(out)

    def _run_actions(self, rule: Rule, bindings: Bindings,
                     force_host: bool = False) -> tuple[dict, dict]:
        """Returns ({ftype: (ids, attrs, vals, valtypes)}, {ftype: (...)}) of
        adds and deletes derived from the bindings.  ``force_host``
        (counting passes) keeps every column on host: the device
        write-side dedup would collapse the per-derivation multiplicity
        the signed counts are made of."""
        adds: dict[str, list] = {}
        dels: dict[str, list] = {}
        n = bindings.n
        use_handles = ((not force_host) and self._pipeline and
                       getattr(bindings, "device_backed", lambda: False)())
        for a in rule.actions:
            if isinstance(a, ExternalAction):
                a.callback({k: bindings.col(k) for k in bindings.names()})
                continue
            if n == 0:
                continue
            # adds ride handles through the write-side device dedup;
            # deletes and computed values need host arrays anyway
            ha = (use_handles and isinstance(a, AddAction)
                  and a.compute is None)
            ids = self._slot_column(a.id, bindings, n, None, ha)
            attrs = self._slot_column(a.attr, bindings, n, None, ha)
            if isinstance(a, AddAction) and a.compute is not None:
                vals = np.asarray(
                    a.compute({k: bindings.col(k) for k in bindings.names()}),
                    np.int64)
            else:
                vals = self._slot_column(a.val, bindings, n, a.valtype, ha)
            valtypes = np.full(n, int(a.valtype), np.int8)
            bucket = adds if isinstance(a, AddAction) else dels
            bucket.setdefault(a.fact_type, []).append((ids, attrs, vals, valtypes))
        return ({t: self._cat_parts(p) for t, p in adds.items()},
                {t: self._cat_parts(p) for t, p in dels.items()})

    # ------------------------------------------------------------ inference
    def _rule_inputs_changed(self, ridx: int) -> bool:
        seen = self._rule_seen_versions.get(ridx)
        if seen is None:
            return True
        for t in self.rules[ridx].input_types():
            if self._type_version.get(t, 0) != seen.get(t, 0):
                return True
        return False

    def _note_rule_evaluated(self, ridx: int) -> None:
        self._rule_seen_versions[ridx] = {
            t: self._type_version.get(t, 0)
            for t in self.rules[ridx].input_types()}

    def _table_marks(self, rule: Rule) -> dict[str, tuple[int, int]]:
        out = {}
        for t in rule.input_types():
            tab = self.store.tables.get(t)
            out[t] = (tab.n, tab.dellog_n) if tab is not None else (0, 0)
        return out

    def _rule_delta_capability(self, ridx: int) -> str:
        """How far the signed-frontier machinery carries this rule:

        * ``"add"`` — all actions are adds and every condition binds at
          least one variable: derivation multiplicities are well defined,
          so counting passes (±frontiers, distinct=False) are exact.
        * ``"del"`` — all actions delete facts of the rule's own input
          types: delete effects are idempotent (a dead row cannot die
          again) and a scrub of the target type resets this rule too, so
          +frontier passes alone are sound.
        * ``"no"`` — external actions, variable-free (pure existence)
          conditions, or mixed/foreign-target deletes: full fallback.
        """
        rule = self.rules[ridx]
        if any(isinstance(a, ExternalAction) for a in rule.actions):
            return "no"
        if any(not c.variables() for c in rule.conditions):
            # an existence gate contributes no multiplicity: the join
            # emits one row whether 1 or k facts match, so per-derived-
            # fact support counts would under/over-shoot on its deltas
            return "no"
        if all(isinstance(a, AddAction) for a in rule.actions):
            return "add"
        inputs = {base_fact_type(t) for t in rule.input_types()}
        if (all(isinstance(a, DeleteAction) for a in rule.actions)
                and all(base_fact_type(a.fact_type) in inputs
                        for a in rule.actions)):
            return "del"
        return "no"

    def _taint_rule_outputs(self, ridx: int) -> None:
        """A non-counting full evaluation writes set-semantics facts with
        no support: mark its output types so later deletes reaching them
        take the DRed scrub (which rebuilds exact counts)."""
        if not self._counting:
            return
        for a in self.rules[ridx].actions:
            if isinstance(a, AddAction):
                self._count_tainted.add(base_fact_type(a.fact_type))

    def _begin_rule_eval(self, ridx: int) -> tuple | None:
        """Snapshot the rule's input watermarks and decide how this
        evaluation runs.  Returns one of:

        * ``None`` — one plain full pass (set semantics);
        * ``("init",)`` — counting full pass: ``distinct=False`` so every
          derivation contributes +1 support (first evaluation, or after a
          DRed scrub reset);
        * ``("delta", passes)`` — signed semi-naive passes;
          ``passes = [(sign, {cond_idx: frontier})]`` where a frontier is
          an int (append window start) or an ndarray (−frontier: rows
          from the delete log);
        * ``("delpass", {cond_idx: start})`` — +frontier passes for an
          idempotent delete rule.

        The signed decomposition is inclusion–exclusion over the changed
        conditions: with per-condition delta δᵢ = δ⁺ᵢ − δ⁻ᵢ,

            Δ(⋈ᵢ newᵢ) = Σ_{∅≠S} (−1)^{|S|−1} ⋈_{i∈S} δᵢ ⋈_{j∉S} newⱼ

        so every unpinned condition evaluates against the *current*
        table state — no old-view reconstruction anywhere.  Called from
        the scheduling thread *before* the (possibly pooled) evaluation,
        while table state is quiescent.
        """
        rule = self.rules[ridx]
        old = self._rule_watermarks.get(ridx)
        self._note_rule_evaluated(ridx)
        new = self._table_marks(rule)
        self._rule_watermarks[ridx] = new
        if self.config.eval_mode == "full":
            return None
        cap = self._rule_delta_capability(ridx)
        if cap == "no":
            self._taint_rule_outputs(ridx)
            return None
        if (self.config.eval_mode == "auto"
                and self.config.rnl != "AR"):
            # without the AR restriction a delta pass still joins the
            # full relations of the other conditions — k passes cost
            # more than one full evaluation, so auto stays full in DR
            self._taint_rule_outputs(ridx)
            return None
        if old is None:
            # first evaluation (or scrub reset): counting init for add
            # rules, plain full for delete rules (they keep no support)
            return ("init",) if self._counting and cap == "add" else None
        for t, (n1, d1) in new.items():
            n0, d0 = old.get(t, (0, 0))
            if n1 < n0 or d1 < d0:  # table replaced under us
                self._taint_rule_outputs(ridx)
                return None
        if cap == "del":
            wins = {}
            for i, c in enumerate(rule.conditions):
                n0 = old.get(c.fact_type, (0, 0))[0]
                if new.get(c.fact_type, (0, 0))[0] > n0:
                    wins[i] = n0
            return ("delpass", wins)
        passes = self._signed_passes(rule, old, new)
        if passes is None:
            self._taint_rule_outputs(ridx)
            return None
        if self.config.eval_mode == "auto" and passes:
            # semi-naive pays when the frontier is small relative to the
            # relations: a dense recursive closure (wordnet-style) grows
            # by ~half the table per round, and k delta-joins against
            # full relations then cost more than one full pass — auto
            # falls back (tainting its outputs); eval_mode="delta"
            # forces signed passes regardless
            grown = sum(abs(new[t][0] - old.get(t, (0, 0))[0])
                        + (new[t][1] - old.get(t, (0, 0))[1])
                        for t in rule.input_types())
            total = sum(new[t][0] for t in rule.input_types())
            if grown * 8 > total:
                self._taint_rule_outputs(ridx)
                return None
        return ("delta", passes)

    _MAX_SIGNED_PASSES = 64

    def _signed_passes(self, rule: Rule, old: dict, new: dict
                       ) -> "list[tuple[int, dict]] | None":
        """Expand the inclusion–exclusion sum into concrete passes.

        Per condition the options are: unpinned (current state), +window
        ``[n0, n)`` (appends since the watermark; the lookup's alive
        filter is exact because any window row that died also died
        in-window, so its +/− contributions cancel), and −window (delete
        log slice, capped to rows ``< n0`` — deaths of rows this rule
        never saw alive cancel out of both frontiers).  A −window pick
        flips the pass sign once more: δᵢ = δ⁺ᵢ − δ⁻ᵢ.
        Returns None when the pass count would exceed the cap.
        """
        opts: list[list] = []
        any_window = False
        for c in rule.conditions:
            t = c.fact_type
            n0, d0 = old.get(t, (0, 0))
            n1, d1 = new.get(t, (0, 0))
            o: list = [None]
            if n1 > n0:
                o.append((1, n0))
            if d1 > d0:
                tab = self.store.tables.get(t)
                if tab is not None:
                    w = tab.dellog[d0:d1]
                    w = w[w < n0]
                    if len(w):
                        o.append((-1, w.astype(np.int32)))
            if len(o) > 1:
                any_window = True
            opts.append(o)
        if not any_window:
            return []
        total = 1
        for o in opts:
            total *= len(o)
        if total - 1 > self._MAX_SIGNED_PASSES:
            return None
        passes: list[tuple[int, dict]] = []
        for combo in itertools.product(*opts):
            picked = [(i, x) for i, x in enumerate(combo) if x is not None]
            if not picked:
                continue
            nneg = sum(1 for _, x in picked if x[0] < 0)
            sign = (-1) ** (len(picked) - 1 + nneg)
            passes.append((sign, {i: x[1] for i, x in picked}))
        return passes

    def _rl_fn(self):
        if self.query_cache is None:
            return None
        cache = self.query_cache
        return lambda store, c: cache.lookup(
            store, c, self._type_version.get(c.fact_type, 0))

    def _window_nonempty(self, c: Condition, w) -> bool:
        """Cheap pre-check that a pinned frontier holds any rows matching
        the condition's constant slots: both this scan and the one inside
        ``_lookup_condition`` are O(Δ) tail filters, cheaper than setting
        up a dead pass."""
        if isinstance(w, np.ndarray):
            return len(_dead_window_rows(self.store, c, w)) > 0
        return len(_frontier_rows(self.store, c, w)) > 0

    def _collect_signed(self, rule: Rule, bindings: Bindings, sign: int,
                        parts: dict) -> None:
        """Run the rule's add actions over counting bindings and stash the
        emitted columns with the pass sign (multiplicity preserved)."""
        if bindings.n == 0:
            return
        adds, _dels = self._run_actions(rule, bindings, force_host=True)
        for t, cols in adds.items():
            parts.setdefault(t, []).append((sign, cols))

    def _eval_one(self, ridx: int, plan: tuple | None = None
                  ) -> tuple[int, dict, dict, dict, dict]:
        """Evaluate one rule under the plan from ``_begin_rule_eval``:
        a single full pass (``None`` set-semantics / ``("init",)``
        counting), the signed semi-naive decomposition (``("delta", …)``),
        or +frontier delete passes (``("delpass", …)``).  The union of
        the signed passes covers, with inclusion–exclusion multiplicity,
        exactly the derivations gained and lost since the watermark."""
        rule = self.rules[ridx]
        cfg = self.config
        estats: dict = {"rows_considered": 0}
        kw = dict(join_algo=cfg.join, rnl_mode=cfg.rnl, layout=cfg.layout,
                  sort_mode=cfg.sort_mode, distinct=True,
                  rl_fn=self._rl_fn(), ops=self.ops,
                  pipeline=self._pipeline, stats=estats,
                  planner=self._sketch_planner())
        signed: dict[str, list] = {}
        if plan is None:
            bindings = evaluate_rule(self.store, rule, **kw)
            adds, dels = self._run_actions(rule, bindings)
            estats["full_evals"] = 1
            estats["delta_passes"] = 0
            return ridx, adds, dels, signed, estats
        if plan[0] == "init":
            # counting initialization: one full pass with multiplicity
            # preserved — every derivation contributes +1 to its fact's
            # support counter
            kw["distinct"] = False
            bindings = evaluate_rule(self.store, rule, **kw)
            self._collect_signed(rule, bindings, 1, signed)
            estats["full_evals"] = 1
            estats["delta_passes"] = 0
            return ridx, {}, {}, signed, estats
        # delta passes start from a tiny frontier, so planner quality is
        # irrelevant — the cheap tuple sort beats re-packing sort keys
        # once per pass
        kw["sort_mode"] = "fixed"
        islands = None
        ran = 0
        if plan[0] == "delpass":
            # idempotent delete rule: +frontier passes only — one per
            # grown condition, each seeing that condition's appends and
            # every other condition's current relation.  Deaths never
            # un-fire a delete, so −frontiers are unnecessary.
            wins = plan[1]
            dels_parts: dict[str, list] = {}
            for i in sorted(wins):
                if not self._window_nonempty(rule.conditions[i], wins[i]):
                    continue
                if islands is None:
                    islands = build_islands(self.store, rule)
                ran += 1
                bindings = evaluate_rule(self.store, rule, islands=islands,
                                         delta_for={i: wins[i]}, **kw)
                if bindings.n == 0:
                    continue
                _adds, dels = self._run_actions(rule, bindings)
                for t, cols in dels.items():
                    dels_parts.setdefault(t, []).append(cols)
            estats["full_evals"] = 0
            estats["delta_passes"] = ran
            return (ridx, {},
                    {t: self._cat_parts(p) for t, p in dels_parts.items()},
                    signed, estats)
        # plan[0] == "delta": signed counting passes
        kw["distinct"] = False
        negs = 0
        for sign, windows in plan[1]:
            if not all(self._window_nonempty(rule.conditions[i], w)
                       for i, w in windows.items()):
                continue
            if islands is None:
                islands = build_islands(self.store, rule)
            ran += 1
            if any(isinstance(w, np.ndarray) for w in windows.values()):
                negs += 1
            bindings = evaluate_rule(self.store, rule, islands=islands,
                                     delta_for=dict(windows), **kw)
            self._collect_signed(rule, bindings, sign, signed)
        estats["full_evals"] = 0
        estats["delta_passes"] = ran
        estats["neg_passes"] = negs
        return ridx, {}, {}, signed, estats

    # ------------------------------------------------- counting application
    def _signed_counts(self, batches: list) -> tuple | None:
        """Aggregate signed per-derivation emissions into one net count
        per distinct fact (sorted segmented reduction); zero-net facts —
        a derivation lost and another gained in the same round — drop out
        here and never touch the table."""
        ids = np.concatenate([np.asarray(c[0], np.int64) for _, c in batches])
        if len(ids) == 0:
            return None
        attrs = np.concatenate([np.asarray(c[1], np.int64)
                                for _, c in batches])
        vals = np.concatenate([np.asarray(c[2], np.int64) for _, c in batches])
        valtypes = np.concatenate([np.asarray(c[3], np.int8)
                                   for _, c in batches])
        signs = np.concatenate([np.full(len(c[0]), s, np.int64)
                                for s, c in batches])
        key = _pack_keys(ids, attrs)
        order = np.lexsort((vals, key))
        k, v = key[order], vals[order]
        starts = np.flatnonzero(np.concatenate(
            ([True], (k[1:] != k[:-1]) | (v[1:] != v[:-1]))))
        net = np.add.reduceat(signs[order], starts)
        sel = order[starts]
        keep = net != 0
        sel = sel[keep]
        if len(sel) == 0:
            return None
        return (ids[sel].astype(np.int32), attrs[sel].astype(np.int32),
                vals[sel], valtypes[sel], net[keep].astype(np.int32))

    def _apply_counts(self, ftype: str, ids, attrs, vals, valtypes, net
                      ) -> tuple[int, int]:
        """Apply net derivation counts to a table: positive nets bump
        support (inserting unseen facts as derived rows), negative nets
        retract support — a fact whose support collapses to zero with no
        assertion left dies and enters the delete log."""
        table = self.store.table(ftype)
        rowof = _match_rows(table, ids, attrs, vals, self.ops, self._pk_memo)
        hit = rowof >= 0
        n_new = n_dead = 0
        pos = hit & (net > 0)
        if pos.any():
            table.add_support(rowof[pos], net[pos])
        fresh = ~hit & (net > 0)
        if fresh.any():
            start = table.n
            table.insert(ids[fresh], attrs[fresh], vals[fresh],
                         valtypes[fresh], dedup=False, asserted=False)
            table.add_support(np.arange(start, table.n, dtype=np.int64),
                              net[fresh])
            n_new = table.n - start
        neg = hit & (net < 0)
        if neg.any():
            d0 = table.dellog_n
            dead = table.retract_support(rowof[neg], -net[neg])
            n_dead = len(dead)
            if n_dead:
                self._on_deaths(ftype, table, d0)
        # negative net on a missing fact: stale support (tainted type) —
        # the DRed scrub path rebuilds it, nothing to do here
        if n_new or n_dead:
            self._type_version[ftype] = self._type_version.get(ftype, 0) + 1
        return n_new, n_dead

    def _on_deaths(self, ftype: str, table: TypedFactTable, d0: int) -> None:
        """Hook: rows ``table.dellog[d0:]`` just died outside the explicit
        delete router (support collapse or scrub).  The sharded engine
        overrides this to retire the dead rows' view copies; the local
        engine needs nothing."""

    # ------------------------------------------------------ DRed scrub path
    def _unsafe_delete_types(self, trees: DerivationTrees) -> set[str]:
        """Types whose deaths counting cannot propagate exactly: inputs
        of recursive rules (a fact may support its own rederivation),
        tainted types (stale support), and inputs of rules whose outputs
        are tainted (those rules run non-counting fallbacks)."""
        unsafe = trees.recursive_input_types() | set(self._count_tainted)
        if self._count_tainted:
            for r in self.rules:
                if any(isinstance(a, AddAction)
                       and base_fact_type(a.fact_type) in self._count_tainted
                       for a in r.actions):
                    unsafe.update(base_fact_type(t) for t in r.input_types())
        return unsafe

    def _check_death_frontiers(self, stats: InferStats) -> bool:
        """Detect deaths the signed frontiers cannot absorb and run the
        DRed-style over-delete/re-derive scrub.  In full mode every death
        reaching a consumer triggers it (that is how full mode gains
        retraction semantics at all); in counting mode only deaths in
        ambiguous regions (recursive inputs, tainted types) do — exact
        counting handles the rest as −frontier passes with zero scrubs."""
        trees = self.trees()
        fresh: set[str] = set()
        for name, tab in self.store.tables.items():
            if tab.dellog_n > self._dellog_seen.get(name, 0):
                fresh.add(base_fact_type(name))
        if not fresh:
            return False
        triggers = (fresh & self._unsafe_delete_types(trees)
                    if self._counting else fresh)
        rules_reset: set[int] = set()
        out_types: set[str] = set()
        if triggers:
            # downstream() seeds derived trigger types into the scrub
            # set, so a deleted fact that is still derivable comes back
            # when its (reset) producers re-run
            rules_reset, out_types = trees.downstream(triggers)
        if not rules_reset:
            # deaths nobody consumes (or absorbed by counting): just
            # advance the scrub detector — per-rule signed watermarks
            # still see them as −frontiers
            for name, tab in self.store.tables.items():
                self._dellog_seen[name] = tab.dellog_n
            return False
        self._scrub(rules_reset, out_types, stats)
        return True

    def _scrub(self, rules_reset: set[int], out_types: set[str],
               stats: InferStats) -> None:
        """Over-delete: tombstone every non-asserted row of the affected
        output types and zero their support; re-derive: reset the
        affected rules' watermarks so their next evaluation is a full
        counting init.  Scrub deaths are pre-acknowledged everywhere —
        the reset rules rebuild from scratch and every other rule, by
        construction of the downstream closure, never consumed the
        scrubbed types."""
        for name, tab in self.store.tables.items():
            if base_fact_type(name) in out_types:
                d0 = tab.dellog_n
                dead = tab.scrub_derived()
                if len(dead):
                    self._type_version[name] = (
                        self._type_version.get(name, 0) + 1)
                    self._on_deaths(name, tab, d0)
        for r in rules_reset:
            self._rule_watermarks.pop(r, None)
            self._rule_seen_versions.pop(r, None)
        self._count_tainted -= out_types
        for name, tab in self.store.tables.items():
            self._dellog_seen[name] = tab.dellog_n
        stats.dred_scrubs += 1

    def infer(self) -> InferStats:
        """Run the inference loop (Fig. 1) to fixpoint."""
        t0 = time.perf_counter()
        cfg = self.config
        trees = self.trees()
        active = trees.active_set(lazy=cfg.lazy)
        stats = InferStats()
        pool = (ThreadPoolExecutor(max_workers=cfg.max_workers)
                if (cfg.tree_exec == "PF" or cfg.index_write == "PW") else None)
        try:
            changed = True
            while changed and stats.iterations < cfg.max_iterations:
                changed = False
                stats.iterations += 1
                # deaths since the last round (or from deletes between
                # infer calls) that signed frontiers cannot absorb
                # trigger the DRed scrub before the round's evaluations
                if self._check_death_frontiers(stats):
                    changed = True
                round_rows = 0
                round_emitted = 0
                for level in trees.levels:
                    level_rules = []
                    for r in level:
                        if r not in active:
                            if not self.rules[r].is_query():
                                stats.rules_skipped_inactive += 1
                            continue
                        if self.rules[r].is_query():
                            continue  # queries run via .query()/.run_queries()
                        if not self._rule_inputs_changed(r):
                            stats.rules_skipped_unchanged += 1
                            continue
                        level_rules.append(r)
                    if not level_rules:
                        continue
                    # Algorithm 2: islands + sort keys rebuilt per level
                    # (cardinalities moved); groups own disjoint output types.
                    groups = trees.out_groups(level_rules, set(level_rules))
                    results: list[tuple[int, dict, dict, dict, dict]] = []
                    if pool is not None and cfg.tree_exec == "PF" and len(groups) > 1:
                        futs = []
                        for g in groups:
                            for r in g:
                                plan = self._begin_rule_eval(r)
                                futs.append(pool.submit(self._eval_one, r,
                                                        plan))
                        results = [f.result() for f in futs]
                    else:
                        for g in groups:
                            for r in g:
                                results.append(
                                    self._eval_one(r,
                                                   self._begin_rule_eval(r)))
                    stats.rules_evaluated += len(results)
                    for _, _, _, _, es in results:
                        round_rows += es.get("rows_considered", 0)
                        stats.delta_passes += es.get("delta_passes", 0)
                        stats.full_evals += es.get("full_evals", 0)
                        stats.neg_passes += es.get("neg_passes", 0)
                        stats.replans += es.get("replans", 0)
                    # Writes: PW = concurrent per disjoint fact type;
                    # SW = sequential in schedule order.  Set-semantics
                    # adds (full fallbacks), explicit deletes, then the
                    # signed counting application.
                    by_type_adds: dict[str, list] = {}
                    by_type_dels: dict[str, list] = {}
                    by_type_signed: dict[str, list] = {}
                    for _, adds, dels, signed, _es in results:
                        for t, cols in adds.items():
                            by_type_adds.setdefault(t, []).append(cols)
                        for t, cols in dels.items():
                            by_type_dels.setdefault(t, []).append(cols)
                        for t, batches in signed.items():
                            by_type_signed.setdefault(t, []).extend(batches)

                    def _write_type(t: str, parts: list) -> int:
                        return self._insert_columns(
                            t, *self._cat_parts(parts), asserted=False)

                    if pool is not None and cfg.index_write == "PW" and len(by_type_adds) > 1:
                        futs = {t: pool.submit(_write_type, t, p)
                                for t, p in by_type_adds.items()}
                        wrote = {t: f.result() for t, f in futs.items()}
                    else:
                        wrote = {t: _write_type(t, p)
                                 for t, p in by_type_adds.items()}
                    for t, parts in by_type_dels.items():
                        cols = self._cat_parts(parts)
                        ndel = self._delete_matching(t, cols[0], cols[1], cols[2])
                        stats.facts_deleted += ndel
                        changed |= ndel > 0
                    for t, batches in by_type_signed.items():
                        cnt = self._signed_counts(batches)
                        if cnt is None:
                            continue
                        nn, nd = self._apply_counts(t, *cnt)
                        stats.facts_inferred += nn
                        stats.facts_retracted += nd
                        round_emitted += nn
                        changed |= (nn + nd) > 0
                    n_new = sum(wrote.values())
                    stats.facts_inferred += n_new
                    round_emitted += n_new
                    changed |= n_new > 0
                stats.rows_considered += round_rows
                stats.rows_emitted += round_emitted
                stats.rounds.append({"iteration": stats.iterations,
                                     "rows_considered": round_rows,
                                     "rows_emitted": round_emitted})
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        # compensations since the last infer() — covers both in-round
        # DeleteAction absorptions and out-of-band delete_facts() calls
        stats.compensated_deletes = self._n_compensated - self._comp_reported
        self._comp_reported = self._n_compensated
        stats.seconds = time.perf_counter() - t0
        self._drain_sketch_counts(stats)
        self.last_infer = stats
        return stats

    # ------------------------------------------------- sketch planner
    def _sketch_planner(self):
        """Lazy cost-based planner (``sort_mode="sketch"``): estimates
        intermediate-result sizes from per-column cardinality sketches
        and re-plans the island chain when observations drift >4x.
        ``None`` under any other sort mode — the static paths stay
        byte-identical."""
        if self.config.sort_mode != "sketch":
            return None
        if self._planner is None:
            from repro_torch.core.islands import SketchPlanner
            self._planner = SketchPlanner(self.ops)
        return self._planner

    def _drain_sketch_counts(self, stats: InferStats) -> None:
        p = self._planner
        if p is None:
            return
        h0, m0 = self._sketch_seen
        stats.sketch_hits += p.hits - h0
        stats.sketch_misses += p.misses - m0
        self._sketch_seen = (p.hits, p.misses)

    # --------------------------------------------------------------- query
    def _query_version_token(self, types) -> tuple:
        """Hashable snapshot of the query's input-table versions — the
        repeat-query cache key invalidator (version covers appends,
        data_version covers tombstones)."""
        out = []
        for t in sorted(types):
            tab = self.store.tables.get(t)
            out.append((t,) + ((tab.version, tab.data_version)
                               if tab is not None else (-1, -1)))
        return tuple(out)

    def query(self, conditions: list[Condition], decode: bool = True):
        """Evaluate an ad-hoc query (a rule with no actions, Def. 10).

        A query re-issued at unchanged input-table versions is served
        from the decoded-result cache without re-entering evaluation
        (``EngineConfig.result_cache``; hits/misses are counted in
        ``last_infer``).
        """
        rule = Rule("<adhoc>", tuple(conditions))
        cfg = self.config
        key = None
        if decode and self._result_cache is not None:
            key = self._result_cache.key(
                conditions, self._query_version_token(rule.input_types()))
            if key is not None:
                hit = self._result_cache.lookup(key)
                if hit is not None:
                    self.last_infer.query_cache_hits += 1
                    # the single copy: cache entries are frozen tuples
                    return [dict(r) for r in hit]
                self.last_infer.query_cache_misses += 1
        if decode and self._requery_nodes is not None:
            rows = self._query_tracked(rule, conditions, key)
            if rows is not None:
                return rows
        qstats: dict = {"rows_considered": 0, "replans": 0}
        bindings = evaluate_rule(
            self.store, rule, join_algo=cfg.join, rnl_mode=cfg.rnl,
            layout=cfg.layout, sort_mode=cfg.sort_mode, distinct=True,
            rl_fn=self._rl_fn(), ops=self.ops, pipeline=self._pipeline,
            stats=qstats, planner=self._sketch_planner())
        self.last_infer.rows_considered += qstats["rows_considered"]
        self.last_infer.replans += qstats.get("replans", 0)
        self._drain_sketch_counts(self.last_infer)
        if not decode:
            return bindings
        rows = decode_bindings(self.store, conditions, bindings)
        if key is not None:
            self._result_cache.put(key, rows)
        return rows

    # ------------------------------------------- delta-aware query nodes
    def enable_delta_requery(self, on: bool = True) -> None:
        """Opt the engine into delta-aware query nodes (serving tier).

        Tracked decoded queries evaluate ``distinct=False`` once to
        build per-row derivation counts, then fold only the signed
        ±frontier windows on requery (see ``DeltaQueryNode``).  Off by
        default: untracked engines keep the seed single-shot query path
        byte for byte."""
        if on and self._requery_nodes is None:
            from repro_torch.core.querycache import QueryNodeStore
            self._requery_nodes = QueryNodeStore()
        elif not on:
            self._requery_nodes = None

    def requery_stats(self) -> dict:
        """Cumulative delta-requery counters (empty when tracking is
        off).  Lives outside ``InferStats`` because ``infer()`` replaces
        ``last_infer`` and serving interleaves writes with reads."""
        if self._requery_nodes is None:
            return {"tracked_queries": 0, "full_evals": 0,
                    "delta_folds": 0, "delta_passes": 0, "rebuilds": 0}
        return self._requery_nodes.stats()

    def _query_tracked(self, rule: Rule, conditions, key):
        """Serve a decoded query through its delta query node.

        Returns the decoded rows, or ``None`` when the query is not
        trackable (unhashable conditions, or an existence-gate condition
        whose join contributes no multiplicity — exactly the PR 7
        counting restriction) — the caller then takes the plain path.
        Requery folding additionally requires monotone watermarks and a
        bounded signed expansion; otherwise the node rebuilds."""
        from repro_torch.core.querycache import DeltaQueryNode
        nodes = self._requery_nodes
        nk = tuple(conditions)
        try:
            hash(nk)
        except TypeError:
            return None
        if any(not c.variables() for c in rule.conditions):
            return None
        cfg = self.config
        kw = dict(join_algo=cfg.join, rnl_mode=cfg.rnl, layout=cfg.layout,
                  distinct=False, rl_fn=self._rl_fn(), ops=self.ops,
                  pipeline=self._pipeline, planner=None)
        node = nodes.get(nk)
        new = self._table_marks(rule)
        if node is not None:
            monotone = all(
                n1 >= node.marks.get(t, (0, 0))[0]
                and d1 >= node.marks.get(t, (0, 0))[1]
                for t, (n1, d1) in new.items())
            passes = (self._signed_passes(rule, node.marks, new)
                      if monotone else None)
            if passes is not None:
                qstats: dict = {"rows_considered": 0, "replans": 0}
                islands = None
                ran = 0
                for sign, windows in passes:
                    if not all(self._window_nonempty(rule.conditions[i], w)
                               for i, w in windows.items()):
                        continue
                    if islands is None:
                        islands = build_islands(self.store, rule)
                    bindings = evaluate_rule(
                        self.store, rule, islands=islands,
                        delta_for=dict(windows), sort_mode="fixed",
                        stats=qstats, **kw)
                    ran += 1
                    if bindings.n:
                        node.fold(decode_bindings(self.store, conditions,
                                                  bindings), sign)
                node.marks = new
                self.last_infer.rows_considered += qstats["rows_considered"]
                nodes.delta_folds += 1
                nodes.delta_passes += ran
                rows = node.result()
                if key is not None:
                    self._result_cache.put(key, rows)
                return rows
            nodes.rebuilds += 1
        # first sighting (or fold abandoned): full counting build
        qstats = {"rows_considered": 0, "replans": 0}
        bindings = evaluate_rule(
            self.store, rule, sort_mode=cfg.sort_mode, stats=qstats,
            **kw)
        self.last_infer.rows_considered += qstats["rows_considered"]
        self.last_infer.replans += qstats.get("replans", 0)
        nodes.full_evals += 1
        node = DeltaQueryNode(new, decode_bindings(self.store, conditions,
                                                   bindings))
        nodes.put(nk, node)
        rows = node.result()
        if key is not None:
            self._result_cache.put(key, rows)
        return rows


def var_valtypes(conditions: list[Condition]) -> dict[str, ValueType | None]:
    """var -> valtype if bound from a <val> slot, None for id/attr (strings)."""
    from repro_torch.core.store import Component

    out: dict[str, ValueType | None] = {}
    for c in conditions:
        for name, comp in c.variables().items():
            if name not in out:
                out[name] = c.valtype if comp == Component.VAL else None
    return out


def decode_bindings(store: FactStore, conditions: list[Condition],
                    bindings: Bindings) -> list[dict]:
    """Materialize decoded result rows (strings resolved, floats un-punned)."""
    vts = var_valtypes(conditions)
    names = [n for n in bindings.names() if not n.startswith("_")]
    cols = {}
    for n in names:
        vt = vts.get(n)
        lanes = bindings.col(n)
        if vt is None or vt == ValueType.STRING:
            cols[n] = [store.strings.lookup_id(int(x)) for x in lanes]
        else:
            cols[n] = [decode_value(int(x), vt, store.strings) for x in lanes]
    return [{n: cols[n][i] for n in names} for i in range(bindings.n)]
