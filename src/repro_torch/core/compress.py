"""Type-aware compression for columnar join results (paper §2.3: "the
tightly packed inner array ... allows for techniques such as run-length
encoding (RLE) and delta encoding", §5 future work: "type-based
compression in the column-based join structures").

Codecs (picked per column by measured size):

* RAW    — the int64 column as-is (narrowed to int32 when it fits);
* RLE    — (values, run_lengths); join outputs are grouped by join key,
           so key columns are long runs;
* DELTA  — first value + int32 deltas; row-id columns from index lookups
           are sorted/near-sorted;
* DICT   — sorted distinct values + narrow rank codes; attribute-like
           columns repeat a handful of wide (interned-hash) values that
           neither RLE (interleaved) nor DELTA (wide jumps) captures.

Per Abadi et al. (paper ref [1]) some operations run directly on the
compressed form: ``rle_equals`` filters an RLE column without
decompression, and ``rle_count`` aggregates run lengths.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CompressedColumn:
    codec: str                   # raw | rle | delta
    n: int
    payload: tuple[np.ndarray, ...]

    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.payload)


def _narrow(a: np.ndarray) -> np.ndarray:
    if len(a) and a.min() >= np.iinfo(np.int32).min \
            and a.max() <= np.iinfo(np.int32).max:
        return a.astype(np.int32)
    return a


def _rle(a: np.ndarray):
    change = np.nonzero(np.diff(a))[0] + 1
    starts = np.concatenate([[0], change])
    values = a[starts]
    lengths = np.diff(np.concatenate([starts, [len(a)]]))
    return _narrow(values), _narrow(lengths)


def encode_column(a: np.ndarray) -> CompressedColumn:
    a = np.asarray(a, np.int64)
    n = len(a)
    if n == 0:
        return CompressedColumn("raw", 0, (np.empty(0, np.int32),))
    candidates: list[CompressedColumn] = [
        CompressedColumn("raw", n, (_narrow(a),))]
    values, lengths = _rle(a)
    candidates.append(CompressedColumn("rle", n, (values, lengths)))
    deltas = np.diff(a)
    if len(deltas) == 0 or (abs(deltas).max() <= np.iinfo(np.int32).max):
        candidates.append(CompressedColumn(
            "delta", n, (a[:1], deltas.astype(np.int32))))
    distinct = np.unique(a)
    for dt in (np.int8, np.int16):
        if len(distinct) <= np.iinfo(dt).max:
            codes = np.searchsorted(distinct, a).astype(dt)
            candidates.append(CompressedColumn(
                "dict", n, (distinct, codes)))
            break
    return min(candidates, key=lambda c: c.nbytes())


def decode_column(c: CompressedColumn) -> np.ndarray:
    if c.codec == "raw":
        return c.payload[0].astype(np.int64)
    if c.codec == "rle":
        values, lengths = c.payload
        return np.repeat(values.astype(np.int64), lengths)
    if c.codec == "dict":
        distinct, codes = c.payload
        return distinct[codes.astype(np.int64)]
    first, deltas = c.payload
    return np.concatenate([first, first + np.cumsum(
        deltas, dtype=np.int64)])


# -- operate directly on compressed blocks -----------------------------------


def rle_equals(c: CompressedColumn, value: int) -> np.ndarray:
    """Row mask for ``col == value`` straight off the RLE form."""
    assert c.codec == "rle"
    values, lengths = c.payload
    return np.repeat(values.astype(np.int64) == value, lengths)


def rle_count(c: CompressedColumn, value: int) -> int:
    assert c.codec == "rle"
    values, lengths = c.payload
    return int(lengths[values.astype(np.int64) == value].sum())


# -- bindings integration ------------------------------------------------------


class CompressedBindings:
    """Columnar bindings stored compressed (decoded lazily per column).

    Decoded columns are memoized in a bytes-bounded LRU: repeated
    ``col`` access (rule bodies touch the same join column once per
    condition) costs one decode, not one per access, while the resident
    overhead stays capped at ``cache_bytes`` of decoded data.  Evicted
    columns simply re-decode on the next touch — the compressed form is
    the source of truth, so the cache is pure working set.
    """

    layout = "CC"

    def __init__(self, cols: dict[str, np.ndarray],
                 cache_bytes: int = 1 << 22):
        self._enc = {k: encode_column(v) for k, v in cols.items()}
        self.n = next(iter(self._enc.values())).n if self._enc else 0
        self._cache_bytes = int(cache_bytes)
        self._dec: dict[str, np.ndarray] = {}   # insertion order = LRU
        self._dec_bytes = 0
        self.decode_hits = 0
        self.decode_misses = 0

    def names(self) -> list[str]:
        return list(self._enc)

    def col(self, name: str) -> np.ndarray:
        a = self._dec.get(name)
        if a is not None:
            self.decode_hits += 1
            self._dec.pop(name)       # refresh recency
            self._dec[name] = a
            return a
        self.decode_misses += 1
        a = decode_column(self._enc[name])
        a.flags.writeable = False     # shared across accesses
        if a.nbytes <= self._cache_bytes:
            self._dec[name] = a
            self._dec_bytes += a.nbytes
            while self._dec_bytes > self._cache_bytes and len(self._dec) > 1:
                old = self._dec.pop(next(iter(self._dec)))
                self._dec_bytes -= old.nbytes
        return a

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self._enc.values())

    def cache_stats(self) -> dict[str, int]:
        return {"decode_hits": self.decode_hits,
                "decode_misses": self.decode_misses,
                "cached_bytes": self._dec_bytes,
                "cached_cols": len(self._dec)}

    def codecs(self) -> dict[str, str]:
        return {k: c.codec for k, c in self._enc.items()}
