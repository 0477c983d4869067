"""Classic Rete forward-inference engine (Forgy 1982) — the paper's baseline.

Deliberately implements the properties Hiperfact criticizes (Fig. 3):

* P1 — beta memories cache every partial join token;
* P2 — every rule is processed on every matching fact (no laziness);
* P3 — join order is fixed by rule/condition *definition order* at network
  build time (no cardinality awareness);
* P4 — the network is a pointer graph walked node by node per fact.

The port's copy of the reference's ``core/rete_baseline.py`` (numpy
only, no device code).  Used by tests as a semantics oracle: the port's
engines must derive what this network derives.  The reference's copy is
also the baseline of ``benchmarks/bench_vs_rete.py``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.core.conditions import (AddAction, Condition,
                                         DeleteAction, ExternalAction,
                                         JoinTest, Rule, is_var)
from repro_torch.core.facts import Fact, ValueType

_NUMERIC_OPS = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, "<": lambda a, b: a < b,
}


def _fact_slots(f: Fact) -> tuple:
    return (f.id, f.attr, f.val)


@dataclasses.dataclass
class _AlphaNode:
    """One condition's constant pattern + memory of matching facts."""

    cond: Condition
    memory: list[Fact] = dataclasses.field(default_factory=list)

    def matches(self, f: Fact) -> bool:
        c = self.cond
        if f.fact_type != c.fact_type or int(f.valtype) != int(c.valtype):
            return False
        seen: dict[str, object] = {}
        for patt, got in zip((c.id, c.attr, c.val), _fact_slots(f)):
            if is_var(patt):
                if patt.name in seen and seen[patt.name] != got:
                    return False
                seen[patt.name] = got
            elif patt != got:
                return False
        return True

    def bind(self, f: Fact) -> dict:
        c = self.cond
        out = {}
        for patt, got in zip((c.id, c.attr, c.val), _fact_slots(f)):
            if is_var(patt):
                out[patt.name] = got
        return out


class _JoinNode:
    """Joins the parent beta memory's tokens with an alpha memory."""

    def __init__(self, alpha: _AlphaNode, tests: tuple[JoinTest, ...],
                 valtype: ValueType) -> None:
        self.alpha = alpha
        self.tests = tests
        self.valtype = valtype
        self.tokens: list[dict] = []  # beta memory (P1: memoized)

    def consistent(self, token: dict, binding: dict) -> dict | None:
        merged = dict(token)
        for k, v in binding.items():
            if k in merged:
                if merged[k] != v:
                    return None
            else:
                merged[k] = v
        for t in self.tests:
            if t.var1 not in merged:
                continue
            if t.is_const():
                if not _NUMERIC_OPS[t.op](merged[t.var1], t.const):
                    return None
            elif t.var2 in merged:
                if not _NUMERIC_OPS[t.op](merged[t.var1], merged[t.var2]):
                    return None
        return merged


class ReteEngine:
    """Alpha network -> per-rule left-to-right beta chain -> production."""

    def __init__(self) -> None:
        self.rules: list[Rule] = []
        self._alpha: list[_AlphaNode] = []
        self._chains: list[list[_JoinNode]] = []  # per rule
        self._facts: set[tuple] = set()
        self._queue: deque[Fact] = deque()
        self.matches: dict[str, list[dict]] = {}
        self.facts_inferred = 0

    # -- network build (static, definition order — P3) ---------------------
    def add_rule(self, rule: Rule) -> None:
        self.rules.append(rule)
        chain = []
        for c in rule.conditions:
            a = _AlphaNode(c)
            self._alpha.append(a)
            chain.append(_JoinNode(a, c.tests, c.valtype))
        self._chains.append(chain)
        self.matches.setdefault(rule.name, [])

    # -- fact entry ---------------------------------------------------------
    def insert(self, facts: Iterable[Fact]) -> None:
        for f in facts:
            if f.key() in self._facts:
                continue
            self._facts.add(f.key())
            self._queue.append(f)

    def infer(self) -> int:
        """Forward chain to fixpoint; returns #inferred facts."""
        inferred = 0
        while self._queue:
            f = self._queue.popleft()
            # alpha activation: every alpha node tests every fact (P2/P4)
            for a in self._alpha:
                if a.matches(f):
                    a.memory.append(f)
            for rule, chain in zip(self.rules, self._chains):
                inferred += self._activate_rule(rule, chain, f)
        self.facts_inferred += inferred
        return inferred

    def _activate_rule(self, rule: Rule, chain: list[_JoinNode], f: Fact) -> int:
        new = 0
        # right-activate each join node whose alpha matched this fact
        for i, j in enumerate(chain):
            if not j.alpha.matches(f):
                continue
            binding = j.alpha.bind(f)
            lefts = [{}] if i == 0 else chain[i - 1].tokens
            for token in lefts:
                merged = j.consistent(token, binding)
                if merged is None:
                    continue
                new += self._propagate(rule, chain, i, merged)
        return new

    def _propagate(self, rule: Rule, chain: list[_JoinNode], i: int,
                   token: dict) -> int:
        j = chain[i]
        if token in j.tokens:
            return 0
        j.tokens.append(token)
        if i + 1 < len(chain):
            new = 0
            nxt = chain[i + 1]
            for f in nxt.alpha.memory:
                merged = nxt.consistent(token, nxt.alpha.bind(f))
                if merged is not None:
                    new += self._propagate(rule, chain, i + 1, merged)
            return new
        return self._fire(rule, token)

    def _fire(self, rule: Rule, token: dict) -> int:
        self.matches[rule.name].append(token)
        new = 0
        for a in rule.actions:
            if isinstance(a, ExternalAction):
                a.callback(token)
                continue
            if isinstance(a, DeleteAction):
                continue  # baseline scope: monotonic workloads only
            resolve = lambda s: token[s.name] if is_var(s) else s
            val = a.val
            if isinstance(a, AddAction) and a.compute is not None:
                cols = {k: np.asarray([v]) for k, v in token.items()}
                val = a.compute(cols)[0]
            else:
                val = resolve(val)
            nf = Fact(a.fact_type, resolve(a.id), resolve(a.attr), val,
                      a.valtype)
            if nf.key() not in self._facts:
                self._facts.add(nf.key())
                self._queue.append(nf)
                new += 1
        return new

    # -- query (for oracle comparisons) -------------------------------------
    def query(self, conditions: list[Condition]) -> list[dict]:
        qname = "<q>"
        probe = ReteEngine()
        probe.add_rule(Rule(qname, tuple(conditions)))
        probe.insert(Fact(*k[:3], k[3], ValueType(k[4]))
                     for k in sorted(self._facts))
        probe.infer()
        out, seen = [], set()
        for m in probe.matches[qname]:
            key = tuple(sorted(m.items()))
            if key not in seen:
                seen.add(key)
                out.append(m)
        return out
