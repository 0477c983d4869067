"""Demand-driven (magic-set-style) evaluation: materialize only the
cone of the closure a query can observe.  Host code: the anchored
fetches reach the device through ``lookup_batch`` (the ``probe_sorted``
kernel on AI indexes) and ``evaluate_rule`` (the join and dedup sorts).

Forward inference (``infer()``) derives everything whether or not anyone
asks — the paper's problem (2).  With ``EngineConfig(eval_mode="demand")``
a query against a store with undischarged rules does *targeted* work
instead: the query's constants seed per-type **demand patterns**, the
patterns propagate backwards through the producing rules (an AddAction
slot holding a demanded constant keeps or kills the pattern; a variable
slot turns it into a **variable constraint** on the rule body), and each
cone rule evaluates with its constrained variables anchored by rank-1
index probes (``lookup_batch``) — the island executor's AR restriction
then carries the small anchor set through the rest of the chain.  A
forward **probe walk** over the rule body extends the demanded value
sets across shared variables (the magic-sets adornment, computed from
data instead of syntax), raising demand on the body's derived types;
propagation and evaluation interleave to a joint fixpoint: no demand
growth and no fact growth.

Soundness invariants (the reason this returns *exactly* what full
evaluation would):

* demand only ever **grows**, and a value set that would exceed
  ``PROBE_CAP`` escalates that slot (ultimately the type) to
  unrestricted demand — over-approximation is always legal, silent
  truncation never is;
* one evaluation per **distinct variable-constraint set**: constraints
  from different demand patterns are never conjoined (their conjunction
  would under-produce), same-signature patterns union per-slot (their
  conjunctive cross-product is a superset of the union — legal);
* anything the machinery cannot restrict soundly **falls back** to a
  full ``infer()``: cone rules with external actions or delete actions,
  variable-free existence gates (no multiplicity to restrict), delete
  rules outside the cone targeting cone types, queries with no usable
  constants, and unknown (never-interned) query constants — the signed
  delta fixpoint's fallback ladder, one level up.

Derived facts are written through the engine's normal insert path as
non-asserted rows with **no support counts** (the cone does not know the
full multiplicity), so the produced types are marked count-tainted:
a later deletion reaching them takes the DRed scrub, which rebuilds
exact counts.  ``infer()`` after a demand query re-evaluates rules in
full (watermarks were never advanced) and the write-side dedup absorbs
the rederivations.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.conditions import (AddAction, Condition,
                                         ExternalAction, Rule, is_var, rl)
from repro_torch.core.facts import encode_value
from repro_torch.core.islands import evaluate_rule
from repro_torch.core.store import Component, base_fact_type

# A demanded value set larger than this stops anchoring index probes and
# escalates to unrestricted demand (evaluating the producer in full is
# cheaper and always sound).
PROBE_CAP = 4096


class _Demand:
    """Demand on one fact type: a disjunction of conjunctive slot
    patterns ``{Component: value set}``, or the unrestricted marker."""

    __slots__ = ("patterns", "all")

    def __init__(self) -> None:
        self.patterns: dict[tuple, dict] = {}  # signature -> {comp: set}
        self.all = False

    def add(self, pat: dict) -> bool:
        """Merge one pattern; returns True when demand grew.  Patterns
        with the same slot signature union per slot (a sound
        over-approximation); an empty pattern means *everything*."""
        if self.all:
            return False
        if not pat:
            self.all = True
            return True
        sig = tuple(sorted(int(c) for c in pat))
        cur = self.patterns.get(sig)
        if cur is None:
            self.patterns[sig] = {c: set(v) for c, v in pat.items()}
            return True
        grew = False
        for c, v in pat.items():
            new = v - cur[c]
            if new:
                cur[c].update(new)
                grew = True
        if grew and any(len(v) > PROBE_CAP for v in cur.values()):
            # the set outgrew what index probes can anchor: unrestricted
            self.all = True
            self.patterns.clear()
        return grew

    def size(self) -> int:
        if self.all:
            return -1
        return sum(len(v) for p in self.patterns.values()
                   for v in p.values())


class DemandEvaluator:
    """One query's demand cone over one engine (or shard worker).

    ``fallback`` is a reason string when the cone cannot be restricted
    soundly (the caller runs a full ``infer()`` instead); otherwise
    ``round()`` interleaves one demand-propagation + restricted-
    evaluation sweep and returns the change count (facts written +
    demand growth events) — zero means joint fixpoint."""

    def __init__(self, engine, conditions: "list[Condition]") -> None:
        self.engine = engine
        self.conditions = list(conditions)
        self.rows_considered = 0
        self.facts_written = 0
        self.demand: dict[str, _Demand] = {}
        self._done: dict[int, tuple] = {}  # ridx -> last (inputs, demand) fp
        trees = engine.trees()
        self.producers = trees.producers
        # the cone: every rule that (transitively) produces a type the
        # query reads, keyed through normalized fact types so shard
        # workers' __shard_view: conditions land on their base type
        seed_types = {base_fact_type(c.fact_type) for c in self.conditions}
        cone: set[int] = set()
        frontier = set(seed_types)
        seen: set[str] = set()
        while frontier:
            t = frontier.pop()
            if t in seen:
                continue
            seen.add(t)
            for ridx in self.producers.get(t, ()):
                if ridx not in cone:
                    cone.add(ridx)
                    frontier.update(
                        base_fact_type(it)
                        for it in engine.rules[ridx].input_types())
        self.cone_rules = sorted(cone)
        self.cone_types = seen | {
            base_fact_type(t) for r in self.cone_rules
            for t in engine.rules[r].input_types()}
        # types any rule derives: the probe walk must not read value
        # sets out of them — they are incomplete while the cone is still
        # materializing, so a set snooped there would narrow demand
        # below what the query needs (unsound), unlike the always-
        # complete base relations
        self._derived = {t for t, rs in self.producers.items() if rs}
        self.fallback = self._check_fallback()
        if self.fallback is None:
            self._seed()

    # -- fallback ladder ---------------------------------------------------
    def _check_fallback(self) -> "str | None":
        if not self.cone_rules:
            return None  # pure base-table query: nothing to materialize
        strings = self.engine.store.strings
        usable = False
        for c in self.conditions:
            consts = c.const_slots(strings)
            if any(v == -1 for _, v in consts):
                return "unknown-constant"
            if consts:
                usable = True
        if not usable:
            return "no-constants"
        for ridx in self.cone_rules:
            rule = self.engine.rules[ridx]
            if any(isinstance(a, ExternalAction) for a in rule.actions):
                return "external-action"
            if not all(isinstance(a, AddAction) for a in rule.actions):
                return "delete-action"
            if any(not c.variables() for c in rule.conditions):
                return "existence-gate"
        for ridx, rule in enumerate(self.engine.rules):
            if ridx in self.cone_rules:
                continue
            for a in rule.actions:
                if (not isinstance(a, (AddAction, ExternalAction))
                        and base_fact_type(a.fact_type) in self.cone_types):
                    return "foreign-delete"
        return None

    # -- demand seeding + backward propagation -----------------------------
    def _seed(self) -> None:
        strings = self.engine.store.strings
        for c in self.conditions:
            bft = base_fact_type(c.fact_type)
            if not self.producers.get(bft):
                continue  # base type: nothing derives it
            pat = {comp: {v} for comp, v in c.const_slots(strings)}
            self._demand_for(bft).add(pat)

    def _demand_for(self, bft: str) -> _Demand:
        d = self.demand.get(bft)
        if d is None:
            d = self.demand[bft] = _Demand()
        return d

    def _encode_action_slot(self, a: AddAction, comp: Component,
                            slot) -> int:
        strings = self.engine.store.strings
        if comp == Component.VAL:
            return encode_value(slot, a.valtype, strings)
        sid = strings.lookup_str(slot) if isinstance(slot, str) else None
        return sid if sid is not None else -1

    def _rule_constraints(self, ridx: int) -> "list[dict] | None":
        """Variable-constraint sets for one cone rule, derived from the
        demand on its output types.  ``None`` — nothing demanded yet;
        ``[{}]`` — at least one demanded pattern leaves the rule
        unrestricted (one full evaluation covers everything)."""
        rule = self.engine.rules[ridx]
        vcs: list[dict] = []
        unrestricted = False
        for a in rule.actions:
            dem = self.demand.get(base_fact_type(a.fact_type))
            if dem is None:
                continue
            pats = [{}] if dem.all else list(dem.patterns.values())
            for p in pats:
                vc: dict[str, set] = {}
                ok = True
                for comp, slot in ((Component.ID, a.id),
                                   (Component.ATTR, a.attr),
                                   (Component.VAL, a.val)):
                    vals = p.get(int(comp)) if p else None
                    if vals is None:
                        vals = p.get(comp) if p else None
                    if vals is None:
                        continue
                    if is_var(slot):
                        name = slot.name
                        if name in vc:
                            vc[name] &= set(vals)
                            if not vc[name]:
                                ok = False
                                break
                        else:
                            vc[name] = set(vals)
                    elif (comp == Component.VAL
                          and getattr(a, "compute", None) is not None):
                        continue  # computed value: cannot invert
                    else:
                        if self._encode_action_slot(a, comp, slot) not in vals:
                            ok = False  # this action never produces the
                            break       # demanded constant
                if not ok:
                    continue
                if not vc or any(len(v) > PROBE_CAP for v in vc.values()):
                    unrestricted = True
                else:
                    vcs.append(vc)
        if unrestricted:
            return [{}]
        if not vcs:
            return None
        out: list[dict] = []
        seen: set = set()
        for vc in vcs:
            key = tuple(sorted((k, tuple(sorted(v)))
                               for k, v in vc.items()))
            if key not in seen:
                seen.add(key)
                out.append(vc)
        return out

    # -- anchored fetches --------------------------------------------------
    def _fetch(self, store, c: Condition, vc: dict) -> np.ndarray:
        """``rl`` twin with demand anchoring: a condition binding a
        constrained variable fetches exactly the demanded values by
        rank-1 probes instead of scanning the relation."""
        table = store.tables.get(c.fact_type)
        if table is None:
            return np.empty(0, np.int32)
        consts = c.const_slots(store.strings)
        if any(v == -1 for _, v in consts):
            return np.empty(0, np.int32)
        anchor = None
        for name, comp in c.variables().items():
            s = vc.get(name)
            if s and len(s) <= PROBE_CAP:
                anchor = (name, comp)
                break
        if anchor is None:
            return rl(store, c)
        name, comp = anchor
        vals = np.asarray(sorted(vc[name]), np.int64)
        rows, _ = table.index.lookup_batch(table, comp, vals)
        rows = np.asarray(rows, np.int32)
        for comp2, v in consts:
            if len(rows) == 0:
                break
            rows = rows[table.column(comp2)[rows] == v]
        for name2, comp2 in c.variables().items():
            if name2 == name or len(rows) == 0:
                continue
            s2 = vc.get(name2)
            if s2 and len(s2) <= PROBE_CAP:
                rows = rows[np.isin(
                    table.column(comp2)[rows].astype(np.int64),
                    np.asarray(sorted(s2), np.int64))]
        return table.filter_alive(rows)

    def _restricted_rl(self, vc: dict):
        bounded = {k: v for k, v in vc.items() if 0 < len(v) <= PROBE_CAP}
        return lambda store, c: self._fetch(store, c, bounded)

    # -- forward probe walk (demand growth) --------------------------------
    def _walk(self, rule: Rule, vc: dict) -> int:
        """Sweep the rule body, extending the demanded value sets across
        shared variables via index probes, and raise demand on the
        body's *derived* types.  Value sets that outgrow ``PROBE_CAP``
        become unbounded (no constraint — over-approximation)."""
        store = self.engine.store
        known: dict[str, "set | None"] = {
            k: set(v) for k, v in vc.items() if len(v) <= PROBE_CAP}
        for _ in range(2):
            for c in rule.conditions:
                if base_fact_type(c.fact_type) in self._derived:
                    # sideways information passing through base
                    # relations only (see ``_derived`` above)
                    continue
                table = store.tables.get(c.fact_type)
                if table is None or table.n == 0:
                    continue
                if not any(known.get(n) for n in c.variables()):
                    continue
                rows = self._fetch(store, c, {
                    k: v for k, v in known.items() if v})
                if len(rows) == 0:
                    continue
                for name, comp in c.variables().items():
                    if name in known and known[name] is None:
                        continue  # already unbounded
                    vals = np.unique(
                        table.column(comp)[rows].astype(np.int64))
                    s = known.setdefault(name, set())
                    if s is None:
                        continue
                    s.update(int(x) for x in vals)
                    if len(s) > PROBE_CAP:
                        known[name] = None
        grew = 0
        for c in rule.conditions:
            bft = base_fact_type(c.fact_type)
            if not (self.producers.get(bft)
                    and set(self.producers[bft]) & set(self.cone_rules)):
                continue
            pat: dict = {}
            bounded = overflow = False
            for comp, t in c.slots().items():
                if is_var(t):
                    if t.name not in known:
                        continue  # no linkage from the anchors
                    s = known[t.name]
                    if s is None:
                        overflow = True  # linked but past PROBE_CAP
                    elif s:
                        pat[int(comp)] = set(s)
                        bounded = True
                else:
                    consts = dict(
                        (cc, vv)
                        for cc, vv in c.const_slots(store.strings))
                    if comp in consts:
                        pat[int(comp)] = {consts[comp]}
            if not bounded and not overflow:
                # the anchors reach none of this condition's variables
                # (e.g. this shard owns no matching rows): the rule
                # instance can't fire on them, so it demands nothing —
                # a consts-only pattern here would escalate to
                # demand-everything
                continue
            if self._demand_for(bft).add(pat):
                grew += 1
        return grew

    # -- evaluation --------------------------------------------------------
    def _input_token(self, ridx: int) -> tuple:
        store = self.engine.store
        out = []
        for c in self.engine.rules[ridx].conditions:
            tab = store.tables.get(c.fact_type)
            out.append((tab.version, tab.data_version)
                       if tab is not None else (-1, -1))
        return tuple(out)

    def _demand_token(self, ridx: int) -> tuple:
        return tuple(
            (t, d.size()) for t, d in sorted(self.demand.items()))

    def _evaluate(self, ridx: int, vc: dict) -> int:
        engine = self.engine
        cfg = engine.config
        rule = engine.rules[ridx]
        estats: dict = {"rows_considered": 0, "replans": 0}
        bindings = evaluate_rule(
            engine.store, rule, join_algo=cfg.join, rnl_mode=cfg.rnl,
            layout=cfg.layout, sort_mode=cfg.sort_mode, distinct=True,
            rl_fn=self._restricted_rl(vc), ops=engine.ops,
            # the handle cache keys binding columns by (table, condition,
            # version) only — a demand-restricted fetch cached there
            # would poison later full evaluations, so the pipeline is off
            pipeline=False, stats=estats,
            planner=engine._sketch_planner())
        self.rows_considered += estats["rows_considered"]
        engine.last_infer.replans += estats.get("replans", 0)
        n = 0
        if bindings.n:
            adds, _dels = engine._run_actions(rule, bindings,
                                              force_host=True)
            for t, cols in adds.items():
                k = engine._insert_columns(t, *cols, asserted=False)
                n += k
                if k and engine._counting:
                    # demand rows carry no support counts: deletes
                    # reaching them must take the DRed scrub
                    engine._count_tainted.add(base_fact_type(t))
        self.facts_written += n
        return n

    def merge_from(self, other: "DemandEvaluator") -> bool:
        """Union another evaluator's demand into this one (sharded path:
        each worker walks only the rows it owns, so the frontiers they
        discover must be exchanged — a hop whose source row lives on
        shard A and target row on shard B is otherwise never demanded
        where it can be evaluated).  Returns True when demand grew."""
        grew = False
        for bft, od in other.demand.items():
            d = self._demand_for(bft)
            if od.all:
                grew |= d.add({})
                continue
            for p in od.patterns.values():
                grew |= d.add({c: set(v) for c, v in p.items()})
        return grew

    def round(self) -> int:
        """One propagate + evaluate sweep over the cone rules.  Skips
        rules whose inputs *and* demand are unchanged since their last
        evaluation; returns facts written + demand-growth events."""
        changed = 0
        for ridx in self.cone_rules:
            vcs = self._rule_constraints(ridx)
            if vcs is None:
                continue
            fp = (self._input_token(ridx), self._demand_token(ridx))
            if self._done.get(ridx) == fp:
                continue
            self._done[ridx] = fp
            rule = self.engine.rules[ridx]
            for vc in vcs:
                changed += self._walk(rule, vc)
                changed += self._evaluate(ridx, vc)
        return changed
