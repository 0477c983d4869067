"""Conditions, rules, and rank-N lookups (paper Defs. 2–9).

A condition is a pattern over one fact type whose <id>/<attr>/<val> slots are
either constants or named logical variables (``?x``).  The *condition rank*
CR (Def. 4) counts constant slots; the rank-1 index answers CR=1 lookups
directly (R1L, Def. 5), higher ranks start from the most selective component
and filter (RNL, Def. 7), and CCar (Def. 6) estimates result cardinality for
the island planner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.facts import (Fact, StringDictionary, ValueType, decode_lane_array,
                                    encode_value)
from repro_torch.core.store import Component, FactStore, TypedFactTable

# ---------------------------------------------------------------------------
# Pattern terms


@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"?{self.name}"


def is_var(term) -> bool:
    return isinstance(term, Var)


def term(x):
    """'?name' strings become Vars; everything else is a constant."""
    if isinstance(x, str) and x.startswith("?"):
        return Var(x[1:])
    return x


_TEST_OPS: dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
}


@dataclasses.dataclass(frozen=True)
class JoinTest:
    """Join test (Def. 9): ``(<var1> <operator> <var2>)`` where the right
    operand is either a second bound variable (``var2``) or a constant
    (``const`` — the var⊕const form; ``var2`` is None then)."""

    var1: str
    op: str
    var2: str | None
    const: object = None

    def is_const(self) -> bool:
        return self.var2 is None

    def const_lane(self, valtype: ValueType,
                   strings: "StringDictionary") -> int:
        """The constant operand encoded into the int64 lane domain."""
        return encode_value(self.const, valtype, strings)

    def apply(self, a: np.ndarray, b: np.ndarray, valtype: ValueType) -> np.ndarray:
        """Elementwise comparison of two lane columns (``b`` may be a
        scalar lane array for the var⊕const form — numpy broadcasts)."""
        return _TEST_OPS[self.op](
            decode_lane_array(a, valtype), decode_lane_array(b, valtype)
        )


@dataclasses.dataclass(frozen=True)
class Condition:
    """Paper Def. 2.  Build via :func:`cond` for the '?var' sugar."""

    fact_type: str
    id: object
    attr: object
    val: object
    valtype: ValueType = ValueType.STRING
    tests: tuple[JoinTest, ...] = ()

    # -- structure ---------------------------------------------------------
    def slots(self) -> dict[Component, object]:
        return {Component.ID: self.id, Component.ATTR: self.attr,
                Component.VAL: self.val}

    def variables(self) -> dict[str, Component]:
        """var name -> first slot it appears in (id wins over attr over val)."""
        out: dict[str, Component] = {}
        for comp, t in self.slots().items():
            if is_var(t) and t.name not in out:
                out[t.name] = comp
        return out

    def var_slots(self) -> list[tuple[str, Component]]:
        return [(t.name, comp) for comp, t in self.slots().items() if is_var(t)]

    def rank(self) -> int:
        """Condition rank CR (Def. 4)."""
        return sum(0 if is_var(t) else 1 for t in self.slots().values())

    def const_slots(self, strings: StringDictionary) -> list[tuple[Component, int]]:
        """Encoded (component, value) pairs for the constant slots."""
        out = []
        for comp, t in self.slots().items():
            if not is_var(t):
                out.append((comp, _encode_slot(t, comp, self.valtype, strings)))
        return out


def _encode_slot(value, comp: Component, valtype: ValueType,
                 strings: StringDictionary) -> int:
    if comp == Component.VAL:
        return encode_value(value, valtype, strings)
    sid = strings.lookup_str(value) if isinstance(value, str) else None
    # unknown string => impossible match; encode as a sentinel no store holds
    return sid if sid is not None else -1


def cond(fact_type: str, id, attr, val, valtype: ValueType = ValueType.STRING,
         tests: Sequence[tuple[str, str, object]] = ()) -> Condition:
    """Sugar: cond("Person", "?p", "livesIn", "?c") with '?x' variables.
    A test's right operand is a variable when it is a '?x' string,
    otherwise a constant: ``tests=[("?age", ">=", 18)]``."""
    jt = []
    for (v1, op, v2) in tests:
        if isinstance(v2, str) and v2.startswith("?"):
            jt.append(JoinTest(v1.lstrip("?"), op, v2.lstrip("?")))
        else:
            jt.append(JoinTest(v1.lstrip("?"), op, None, v2))
    return Condition(fact_type, term(id), term(attr), term(val), valtype,
                     tuple(jt))


# ---------------------------------------------------------------------------
# Actions + rules


@dataclasses.dataclass(frozen=True)
class AddAction:
    """add(new <fact>): slots may reference bound variables or callables of
    the binding columns (for computed values, e.g. ``?p * ?f``)."""

    fact_type: str
    id: object
    attr: object
    val: object
    valtype: ValueType = ValueType.STRING
    compute: Callable[[dict[str, np.ndarray]], np.ndarray] | None = None


@dataclasses.dataclass(frozen=True)
class DeleteAction:
    fact_type: str
    id: object
    attr: object
    val: object
    valtype: ValueType = ValueType.STRING


@dataclasses.dataclass(frozen=True)
class ExternalAction:
    """Connects matches to an external sink; does not modify facts, so a rule
    with only external actions is a QUERY node (Def. 10)."""

    callback: Callable[[dict[str, np.ndarray]], None]


@dataclasses.dataclass(frozen=True)
class Rule:
    """Paper Def. 3."""

    name: str
    conditions: tuple[Condition, ...]
    actions: tuple = ()
    priority: int = 0

    def output_types(self) -> set[str]:
        return {a.fact_type for a in self.actions
                if isinstance(a, (AddAction, DeleteAction))}

    def input_types(self) -> set[str]:
        return {c.fact_type for c in self.conditions}

    def is_query(self) -> bool:
        """RT (Def. 10): no fact-modifying action => QUERY."""
        return not self.output_types()


# ---------------------------------------------------------------------------
# Rank lookups (Defs. 5-8)


def r1l(table: TypedFactTable, comp: Component, value: int) -> np.ndarray:
    """R1L (Def. 5): trivial fetch from the rank-1 inverted index."""
    return table.filter_alive(table.index.lookup(table, comp, value))


def ccar(store: FactStore, c: Condition) -> float:
    """Condition cardinality (Def. 6): min over constant components of the
    rank-1 counts; CR=0 conditions are de-prioritized with +inf."""
    table = store.tables.get(c.fact_type)
    if table is None:
        return 0.0
    consts = c.const_slots(store.strings)
    if not consts:
        return math.inf
    return float(min(table.index.count(table, comp, v) for comp, v in consts))


def rl(store: FactStore, c: Condition) -> np.ndarray:
    """Generic rank lookup RL (Def. 8) -> row ids of matching alive facts."""
    table = store.tables.get(c.fact_type)
    if table is None:
        return np.empty(0, np.int32)
    consts = c.const_slots(store.strings)
    if any(v == -1 for _, v in consts):
        return np.empty(0, np.int32)  # unknown string constant
    if not consts:  # CR = 0: full scan
        return table.all_rows()
    # RNL (Def. 7): start from the most selective component (== CCar),
    # then AND-filter the remaining constant components.
    consts.sort(key=lambda cv: table.index.count(table, cv[0], cv[1]))
    comp0, v0 = consts[0]
    rows = r1l(table, comp0, v0)
    for comp, v in consts[1:]:
        if len(rows) == 0:
            break
        rows = rows[table.column(comp)[rows] == v]
    return rows


def bindings_for_rows(
    table: TypedFactTable, c: Condition, rows: np.ndarray
) -> dict[str, np.ndarray]:
    """Materialize {var -> column} for the variable slots of ``c``.

    If the same variable occurs in several slots of one condition (e.g.
    ``(T ?x p ?x)``), rows where the slots differ are filtered out first.
    """
    vs = c.var_slots()
    seen: dict[str, Component] = {}
    for name, comp in vs:
        if name in seen:
            a = table.column(seen[name])[rows].astype(np.int64)
            b = table.column(comp)[rows].astype(np.int64)
            rows = rows[a == b]
        else:
            seen[name] = comp
    return {name: table.column(comp)[rows].astype(np.int64)
            for name, comp in seen.items()}
