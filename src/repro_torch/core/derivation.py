"""Derivation trees (paper §2.4): lazy rule evaluation + parallel writes.

The derivation tree is a dependency graph over *fact types*: rule ``c`` is a
child of rule ``p`` when ``c`` consumes a fact type ``p``'s action produces.
It provides:

* **levels** — a top-down schedule (topological over the SCC condensation;
  cycles collapse into one level and are closed by the engine's outer
  fixpoint loop, paper §Recursive Execution);
* **out-groups** — rules of a level grouped by the fact types they write;
  groups have disjoint write sets, so they may run concurrently while each
  owns its rank-1 index ranges (parallel index write, PW);
* **active-rule pruning** (Defs. 10/11) — a derivation rule is evaluated
  only if a QUERY node is reachable below it (lazy evaluation).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.conditions import AddAction, Rule, is_var
from repro_torch.core.store import base_fact_type


def _may_feed(action: AddAction, c) -> bool:
    """Sound static check whether ``action`` can ever produce a fact that
    ``c`` matches: False only on a definite constant mismatch (same-typed
    constants on the same slot that differ).  Variables, computed values,
    and cross-valtype comparisons conservatively count as feeding."""
    for s_a, s_c, is_val in ((action.id, c.id, False),
                             (action.attr, c.attr, False),
                             (action.val, c.val, True)):
        if s_a is None or s_c is None or is_var(s_a) or is_var(s_c):
            continue
        if is_val and (getattr(action, "compute", None) is not None
                       or action.valtype != c.valtype):
            continue
        if type(s_a) is type(s_c) and s_a != s_c:
            return False
    return True


@dataclasses.dataclass
class DerivationTrees:
    rules: list[Rule]
    children: list[set[int]]     # children[p] = rules consuming p's outputs
    parents: list[set[int]]
    levels: list[list[int]]      # top-down schedule (rule indices)
    sccs: list[list[int]]
    # rules whose evaluation is recursive: member of a multi-rule SCC, or
    # consuming a fact type they produce.  Counting-based deletion is
    # ambiguous through these (a fact may support its own rederivation),
    # so deletions reaching their inputs take the DRed scrub path.
    recursive: set[int] = dataclasses.field(default_factory=set)
    # normalized fact type -> rules producing it
    producers: dict[str, set[int]] = dataclasses.field(default_factory=dict)

    # -- Defs. 10/11 --------------------------------------------------------
    def rule_type(self, r: int) -> str:
        """RT (Def. 10)."""
        return "DERIVATION_RULE" if self.children[r] else "QUERY"

    def active(self, r: int, _memo: dict | None = None, _stack: frozenset = frozenset()) -> bool:
        """AR (Def. 11): a rule is active when a QUERY is on some path below
        it.  Cycles contribute False unless a query hangs off the cycle."""
        if _memo is None:
            _memo = {}
        if self.rules[r].is_query():
            return True
        if r in _memo:
            return _memo[r]
        if r in _stack:
            return False
        st = _stack | {r}
        out = any(
            self.rules[x].is_query() or self.active(x, _memo, st)
            for x in self.children[r]
        )
        _memo[r] = out
        return out

    def active_set(self, lazy: bool = True) -> set[int]:
        if not lazy:
            return set(range(len(self.rules)))
        memo: dict[int, bool] = {}
        return {r for r in range(len(self.rules)) if self.active(r, memo)}

    # -- out-groups ---------------------------------------------------------
    def out_groups(self, level: list[int], active: set[int]) -> list[list[int]]:
        """Partition a level's active rules into groups with pairwise
        disjoint output-type sets (union-find over shared output types), so
        each group may own its tables' write ranges concurrently."""
        rules = [r for r in level if r in active]
        parent: dict[int, int] = {r: r for r in rules}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        by_type: dict[str, int] = {}
        for r in rules:
            for t in self.rules[r].output_types():
                if t in by_type:
                    ra, rb = find(r), find(by_type[t])
                    if ra != rb:
                        parent[ra] = rb
                else:
                    by_type[t] = r
        groups: dict[int, list[int]] = {}
        for r in rules:
            groups.setdefault(find(r), []).append(r)
        return list(groups.values())

    # -- signed-frontier helpers -------------------------------------------
    def recursive_input_types(self) -> set[str]:
        """Normalized fact types consumed by a recursive rule — deaths in
        these cannot be propagated by counting (DRed scrub instead)."""
        out: set[str] = set()
        for r in self.recursive:
            out.update(base_fact_type(t) for t in self.rules[r].input_types())
        return out

    def downstream(self, seed_types: set[str]) -> tuple[set[int], set[str]]:
        """Scrub closure of ``seed_types`` (normalized): the rules to
        reset and the fact types to over-delete so a DRed scrub rebuilds
        a consistent state.  The closure is mutual — a type is scrubbed
        when it is a *derived* seed or is written by a reset rule; a rule
        is reset when it reads a seed/scrubbed type **or writes a
        scrubbed type** (every producer of a scrubbed type must re-derive
        it, and every output of a reset rule must be scrubbed, else the
        rule's re-init would double-count support on the survivor)."""
        seed = {base_fact_type(t) for t in seed_types}
        scrubbed = {t for t in seed if self.producers.get(t)}
        rules: set[int] = set()
        changed = True
        while changed:
            changed = False
            touch = seed | scrubbed
            for i, r in enumerate(self.rules):
                if i in rules:
                    continue
                if (any(base_fact_type(t) in touch
                        for t in r.input_types())
                        or any(base_fact_type(t) in scrubbed
                               for t in r.output_types())):
                    rules.add(i)
                    changed = True
            for i in rules:
                for t in self.rules[i].output_types():
                    bt = base_fact_type(t)
                    if bt not in scrubbed:
                        scrubbed.add(bt)
                        changed = True
        return rules, scrubbed


def _tarjan_sccs(n: int, children: list[set[int]]) -> list[list[int]]:
    """Iterative Tarjan SCC (derivation trees may be cyclic, paper §2.4)."""
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, iter(children[root]))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if index[w] == -1:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(children[w])))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs


def build_derivation_trees(rules: list[Rule]) -> DerivationTrees:
    n = len(rules)
    # Producer/consumer linking is over *normalized* fact types: the
    # sharded engine's rewrite makes conditions consume "__shard_view:T:…"
    # tables while actions still produce "T", and without normalization
    # every view-consuming rule looks parentless/childless — which broke
    # lazy active-set pruning (every derivation rule was "QUERY"-typed)
    # and hid recursion from the scheduler.
    #
    # Scheduling edges (children/levels) cover add AND delete targets —
    # a delete rule should run after the producers of what it retracts.
    # Derivation edges (``producers``, recursion marking) are add-only:
    # a DeleteAction cannot re-derive its target, so a delete self-loop
    # is idempotent, not recursive, and must not widen the scrub set.
    sched_producers: dict[str, set[int]] = {}
    add_producers: dict[str, set[int]] = {}
    for i, r in enumerate(rules):
        for t in r.output_types():
            sched_producers.setdefault(base_fact_type(t), set()).add(i)
        for a in r.actions:
            if isinstance(a, AddAction):
                add_producers.setdefault(
                    base_fact_type(a.fact_type), set()).add(i)
    children: list[set[int]] = [set() for _ in range(n)]
    parents: list[set[int]] = [set() for _ in range(n)]
    add_children: list[set[int]] = [set() for _ in range(n)]
    recursive: set[int] = set()
    for i, r in enumerate(rules):
        for c in r.conditions:
            bt = base_fact_type(c.fact_type)
            for p in sched_producers.get(bt, ()):
                if p != i:
                    children[p].add(i)
                    parents[i].add(p)
            for p in add_producers.get(bt, ()):
                # derivation edge only if some add action of p can
                # actually produce a row this condition matches — a rule
                # writing T(x, seen, yes) does not recurse through its
                # own T(x, flag, on) condition
                if not any(isinstance(a, AddAction)
                           and base_fact_type(a.fact_type) == bt
                           and _may_feed(a, c)
                           for a in rules[p].actions):
                    continue
                if p == i:
                    recursive.add(i)
                else:
                    add_children[p].add(i)
    # Levels: longest-path depth over the SCC condensation (top-down).
    sccs = _tarjan_sccs(n, children)
    scc_of = {}
    for si, scc in enumerate(sccs):
        for v in scc:
            scc_of[v] = si
    scc_children: list[set[int]] = [set() for _ in sccs]
    for p in range(n):
        for c in children[p]:
            if scc_of[p] != scc_of[c]:
                scc_children[scc_of[p]].add(scc_of[c])
    scc_parents: list[set[int]] = [set() for _ in sccs]
    for p, cs in enumerate(scc_children):
        for c in cs:
            scc_parents[c].add(p)
    depth = [0] * len(sccs)
    # Kahn over condensation (it is a DAG)
    indeg = [len(ps) for ps in scc_parents]
    queue = [i for i, d in enumerate(indeg) if d == 0]
    topo = []
    while queue:
        v = queue.pop()
        topo.append(v)
        for c in scc_children[v]:
            depth[c] = max(depth[c], depth[v] + 1)
            indeg[c] -= 1
            if indeg[c] == 0:
                queue.append(c)
    max_d = max(depth, default=0)
    levels: list[list[int]] = [[] for _ in range(max_d + 1)]
    for si, scc in enumerate(sccs):
        levels[depth[si]].extend(sorted(scc))
    # multi-rule recursion over *derivation* edges only (see above)
    for scc in _tarjan_sccs(n, add_children):
        if len(scc) > 1:
            recursive.update(scc)
    return DerivationTrees(list(rules), children, parents, levels, sccs,
                           recursive, add_producers)
