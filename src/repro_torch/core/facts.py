"""Fact model for Hiperfact (paper Def. 1).

A fact is a strongly-typed quintuple::

    (<fact type> <id> <attr> <val> <value type>)

TPU adaptation: every component is encoded to a fixed-width integer so that a
fact table is a struct-of-arrays of dense device columns (the paper's "tight
arrays").  Strings go through a dictionary (paper §String Dictionary); the
paper uses a radix tree + id->string array — ingest runs on host here, so a
host dict + list gives the same fixed-size handles without the tree.

Value encoding: the ``val`` column is a single int64 lane.  Integers/bools are
stored directly; floats/doubles are stored by bit pattern (equi-joins and
grouping only need equality, and Def. 9 join tests decode before comparing).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Sequence

import numpy as np


class ValueType(enum.IntEnum):
    """Paper Def. 1: <value type> is one of these."""

    STRING = 0
    INT32 = 1
    INT64 = 2
    UINT32 = 3
    UINT64 = 4
    FLOAT = 5
    DOUBLE = 6
    BOOL = 7


_FLOATY = (ValueType.FLOAT, ValueType.DOUBLE)


def encode_value(value, valtype: ValueType, strings: "StringDictionary") -> int:
    """Encode a python value into the int64 ``val`` lane."""
    if valtype == ValueType.STRING:
        return strings.intern(value)
    if valtype == ValueType.BOOL:
        return int(bool(value))
    if valtype == ValueType.FLOAT:
        return int(np.float32(value).view(np.int32))
    if valtype == ValueType.DOUBLE:
        return int(np.float64(value).view(np.int64))
    if valtype == ValueType.UINT64:
        return int(np.uint64(value).view(np.int64))
    return int(value)


def decode_value(lane: int, valtype: ValueType, strings: "StringDictionary"):
    """Inverse of :func:`encode_value`."""
    if valtype == ValueType.STRING:
        return strings.lookup_id(int(lane))
    if valtype == ValueType.BOOL:
        return bool(lane)
    if valtype == ValueType.FLOAT:
        return float(np.int32(lane).view(np.float32))
    if valtype == ValueType.DOUBLE:
        return float(np.int64(lane).view(np.float64))
    if valtype == ValueType.UINT64:
        return int(np.int64(lane).view(np.uint64))
    return int(lane)


def encode_lane_array(values: np.ndarray, valtype: ValueType) -> np.ndarray:
    """Vectorized inverse of :func:`decode_lane_array` (numeric types only —
    strings must be interned individually)."""
    values = np.asarray(values)
    if valtype == ValueType.FLOAT:
        return values.astype(np.float32).view(np.int32).astype(np.int64)
    if valtype == ValueType.DOUBLE:
        return values.astype(np.float64).view(np.int64)
    if valtype == ValueType.UINT64:
        return values.astype(np.uint64).view(np.int64)
    return values.astype(np.int64)


def decode_lane_array(lanes: np.ndarray, valtype: ValueType) -> np.ndarray:
    """Vectorized decode of an int64 lane column to a comparable dtype.

    Used by variable join tests (Def. 9) which need ordered comparisons on the
    *decoded* values (bit patterns of floats do not order correctly).
    """
    lanes = np.asarray(lanes, dtype=np.int64)
    if valtype == ValueType.FLOAT:
        return lanes.astype(np.int32).view(np.float32)
    if valtype == ValueType.DOUBLE:
        return lanes.view(np.float64)
    if valtype == ValueType.UINT64:
        return lanes.view(np.uint64)
    return lanes


class StringDictionary:
    """str <-> uint32 handle dictionary (paper §2.2 "String Dictionary").

    All <id>/<attr> components and string <val> components are interned so
    facts become fixed-width.  Handles are dense and start at 0.
    """

    __slots__ = ("_to_id", "_to_str")

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = []

    def intern(self, s: str) -> int:
        sid = self._to_id.get(s)
        if sid is None:
            sid = len(self._to_str)
            self._to_id[s] = sid
            self._to_str.append(s)
        return sid

    def intern_many(self, xs: Iterable[str]) -> np.ndarray:
        return np.fromiter((self.intern(x) for x in xs), dtype=np.int32)

    def lookup_id(self, sid: int) -> str:
        return self._to_str[sid]

    def lookup_str(self, s: str) -> int | None:
        return self._to_id.get(s)

    def __len__(self) -> int:
        return len(self._to_str)


@dataclasses.dataclass(frozen=True)
class Fact:
    """A single decoded fact (paper Def. 1). Used at the API boundary only —
    storage is columnar (:mod:`repro.core.store`)."""

    fact_type: str
    id: str
    attr: str
    val: object
    valtype: ValueType = ValueType.STRING

    def key(self) -> tuple:
        return (self.fact_type, self.id, self.attr, self.val, int(self.valtype))


def facts_to_columns(
    facts: Sequence[Fact], strings: StringDictionary
) -> dict[str, dict[str, np.ndarray]]:
    """Group decoded facts by fact type and encode to columns.

    Returns {fact_type: {"id": int32[n], "attr": int32[n], "val": int64[n],
    "valtype": int8[n]}}.
    """
    by_type: dict[str, list[Fact]] = {}
    for f in facts:
        by_type.setdefault(f.fact_type, []).append(f)
    out: dict[str, dict[str, np.ndarray]] = {}
    for ftype, fs in by_type.items():
        ids = strings.intern_many(f.id for f in fs)
        attrs = strings.intern_many(f.attr for f in fs)
        vals = np.fromiter(
            (encode_value(f.val, f.valtype, strings) for f in fs), dtype=np.int64
        )
        valtypes = np.fromiter((int(f.valtype) for f in fs), dtype=np.int8)
        out[ftype] = {"id": ids, "attr": attrs, "val": vals, "valtype": valtypes}
    return out
