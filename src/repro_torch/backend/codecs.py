"""Column codecs for device-resident compressed buffers.

The paper's §2.3 "tightly packed inner array" calls out RLE/delta
encoding as the intended evolution of the fact store; Abadi et al.
(paper ref [1]) showed the capacity *and* bandwidth win comes from
operating directly on codes rather than decompressing first.  This
module is the host-side half of that design: it picks a per-column
encoding at upload time and produces the code arrays the torch backend
keeps resident instead of raw int64 buffers.

Three exact integer codecs (plus implicit raw):

* ``for``  — frame of reference: ``code = value - ref`` stored in the
  narrowest signed dtype that fits the span.  Dense id ranges (interned
  strings are allocated densely) narrow to int16/int32.  The mapping is
  monotonic, so sort order and equality are preserved in code domain.
* ``dict`` — dictionary: codes are ranks into the sorted array of
  distinct values.  Low-cardinality columns (attribute names, type
  objects) narrow to int8/int16.  Rank encoding is order-preserving,
  so code-domain sorts and merges produce the same permutation as
  value-domain ones.
* ``rle``  — run-length (values, lengths) pairs for run-heavy derived
  columns (constant attribute lanes of bindings).  Positional access
  needs a decode, so RLE is only used at the handle tier where decoded
  results are memoized.

Code-domain invariants the backend relies on:

* real codes always leave ``_RESERVE`` headroom at *both* dtype ends,
  so ``iinfo.min`` / ``iinfo.max`` are free for sort/join pads and
  ``iinfo.max - 1`` is a never-matching probe code (``no_match_code``);
* a codec's ``cid`` identifies its code domain: append-only extensions
  keep the ``cid`` (existing rows keep their codes), while any recode
  that renumbers existing rows gets a fresh one — derived mirrors
  (tagged runs) remember the ``cid`` they were built under and refuse
  to merge across a recode;
* ``did`` is a content hash of the dictionary, so two columns with
  byte-identical dictionaries (same-table self-joins, ``__shard_view:``
  copies) share a token and can join directly in code domain.

Everything here is numpy-only; device uploads and the decode/recode
composites live in ``torch_ops``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import zlib
from dataclasses import dataclass

import numpy as np

INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max

#: reserved headroom (in codes) at both ends of the storage dtype for
#: pad and no-match sentinels.
_RESERVE = 4

_CID = itertools.count(1)
_DICT_IDS: dict[tuple, int] = {}
_DICT_SEQ = itertools.count(1)
_LOCK = threading.Lock()


def _dict_token(values: np.ndarray) -> int:
    """Identity token for a sorted dictionary, keyed by content so
    byte-identical dictionaries built independently share it."""
    key = (len(values), int(values[0]), int(values[-1]),
           zlib.crc32(values.tobytes()))
    with _LOCK:
        tok = _DICT_IDS.get(key)
        if tok is None:
            tok = next(_DICT_SEQ)
            _DICT_IDS[key] = tok
        return tok


def smallest_dtype(span: int) -> np.dtype | None:
    """Narrowest signed dtype holding codes ``[0, span]`` with sentinel
    headroom; ``None`` when only int64 would fit (not worth coding)."""
    if span < 0:
        return None
    for dt in (np.int8, np.int16, np.int32):
        if span <= int(np.iinfo(dt).max) - _RESERVE:
            return np.dtype(dt)
    return None


@dataclass(frozen=True, eq=False)
class ColumnCodec:
    """Per-column encoding descriptor (see module docstring)."""

    kind: str                        # "for" | "dict" | "rle"
    dtype: np.dtype                  # storage dtype of the code lanes
    n: int                           # decoded row count at encode time
    lo: int                          # decoded-domain bounds (exact)
    hi: int
    ref: int = 0                     # frame of reference (kind="for")
    values: np.ndarray | None = None  # sorted dictionary (kind="dict")
    did: int = 0                     # shared-dictionary identity token
    nruns: int = 0                   # run count (kind="rle")
    cid: int = dataclasses.field(default_factory=lambda: next(_CID))

    # -- code-domain geometry ------------------------------------------
    def pad_code(self, fill: int) -> int:
        """Code-domain stand-in for a value-domain pad fill."""
        if fill == INT64_MAX:
            return int(np.iinfo(self.dtype).max)
        if fill == INT64_MIN:
            return int(np.iinfo(self.dtype).min)
        return 0

    @property
    def no_match_code(self) -> int:
        """A code no real row carries and no pad equals — probe keys
        that cannot match encode to this."""
        return int(np.iinfo(self.dtype).max) - 1

    def coded_nbytes(self, cap: int) -> int:
        extra = self.values.nbytes if self.values is not None else 0
        lane = self.dtype.itemsize
        if self.kind == "rle":
            lane = 8 + 4  # int64 run values + int32 run lengths
        return cap * lane + extra


# ---------------------------------------------------------------------------
# encoding


def _rle_runs(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    starts = np.r_[0, np.flatnonzero(np.diff(col)) + 1]
    values = col[starts].astype(np.int64)
    lengths = np.diff(np.r_[starts, len(col)]).astype(np.int32)
    return values, lengths


def choose_codec(col: np.ndarray, *, hint: str | None = None,
                 dict_max: int = 1 << 16, allow_rle: bool = False,
                 min_n: int = 1):
    """Pick the cheapest exact encoding for an int64 column.

    Returns ``(codec, payload)``; ``(None, None)`` means raw int64 wins.
    ``payload`` is the code array for for/dict and a ``(values,
    lengths)`` pair for rle.  ``hint`` ("for" | "dict") skips the scan
    the caller knows is futile (e.g. attribute columns are always
    low-cardinality, id columns are always dense ranges).
    """
    n = len(col)
    if n < min_n:
        return None, None
    lo = int(col.min())
    hi = int(col.max())
    best_bytes = n * 8
    best = None          # (kind, dtype, uniq-or-None, runs-or-None)
    if hint != "dict":
        dt = smallest_dtype(hi - lo)
        if dt is not None and n * dt.itemsize < best_bytes:
            best_bytes = n * dt.itemsize
            best = ("for", dt, None, None)
    if hint != "for" and n <= (1 << 22):
        uniq = np.unique(col)
        ddt = smallest_dtype(len(uniq) - 1)
        if len(uniq) <= dict_max and ddt is not None:
            b = n * ddt.itemsize + uniq.nbytes
            if b < best_bytes:
                best_bytes = b
                best = ("dict", ddt, uniq, None)
    if allow_rle:
        values, lengths = _rle_runs(col)
        # 2x headroom: run caps are bucketed and runs grow on append
        b = 2 * (values.nbytes + lengths.nbytes)
        if b < best_bytes:
            best_bytes = b
            best = ("rle", np.dtype(np.int64), None, (values, lengths))
    if best is None:
        return None, None
    kind, dt, uniq, runs = best
    if kind == "for":
        codec = ColumnCodec("for", dt, n, lo, hi, ref=lo)
        return codec, (col - lo).astype(dt)
    if kind == "dict":
        codec = ColumnCodec("dict", dt, n, lo, hi, values=uniq,
                            did=_dict_token(uniq))
        return codec, np.searchsorted(uniq, col).astype(dt)
    values, lengths = runs
    codec = ColumnCodec("rle", dt, n, lo, hi, nruns=len(values))
    return codec, runs


def encode_probes(codec: ColumnCodec, vals: np.ndarray) -> np.ndarray:
    """Encode arbitrary int64 probe keys into the codec's code domain.

    Members map to their code; anything that cannot occur in the column
    maps to ``no_match_code``.  Output is int64 (probes are transient
    uploads; only resident buffers store narrow)."""
    out = np.full(len(vals), codec.no_match_code, dtype=np.int64)
    if codec.kind == "for":
        ok = (vals >= codec.lo) & (vals <= codec.hi)
        np.subtract(vals, codec.ref, out=out, where=ok)
        return out
    rank = np.searchsorted(codec.values, vals)
    idx = np.minimum(rank, len(codec.values) - 1)
    ok = codec.values[idx] == vals
    out[ok] = rank[ok]
    return out


def same_code_domain(a: ColumnCodec, b: ColumnCodec) -> bool:
    """True when ``a`` and ``b`` encode every value to the same code —
    a rebuild that lands here (capacity growth, identical re-scan) may
    keep the displaced codec's ``cid`` so coded mirror runs stay
    mergeable.  FoR: same reference and width.  Dict: same dictionary
    content (``did`` is a content hash, and ranks follow from content).
    """
    if a.kind != b.kind or a.dtype != b.dtype:
        return False
    if a.kind == "for":
        return a.ref == b.ref
    if a.kind == "dict":
        return (a.did == b.did
                and np.array_equal(a.values, b.values))
    return False


def try_encode_delta(codec: ColumnCodec, delta: np.ndarray):
    """Encode an appended tail in the *existing* code domain.

    Returns ``(new_codec, codes)`` on success (``new_codec`` keeps the
    ``cid``: no existing row is renumbered) or ``None`` when the tail
    escapes the domain and the caller must recode-rebuild.  Dictionary
    codecs accept strictly-larger new values by appending to the
    dictionary in place — rank codes of existing values are unchanged —
    which is the coded twin of the in-place buffer-extend path.
    """
    if len(delta) == 0:
        return codec, np.empty(0, dtype=codec.dtype)
    lo = int(delta.min())
    hi = int(delta.max())
    info = np.iinfo(codec.dtype)
    if codec.kind == "for":
        if (lo - codec.ref < info.min + _RESERVE
                or hi - codec.ref > info.max - _RESERVE):
            return None
        new = dataclasses.replace(codec, n=codec.n + len(delta),
                                  lo=min(codec.lo, lo),
                                  hi=max(codec.hi, hi))
        return new, (delta - codec.ref).astype(codec.dtype)
    if codec.kind == "rle":
        values, lengths = _rle_runs(delta)
        new = dataclasses.replace(codec, n=codec.n + len(delta),
                                  lo=min(codec.lo, lo),
                                  hi=max(codec.hi, hi),
                                  nruns=codec.nruns + len(values))
        return new, (values, lengths)
    rank = np.searchsorted(codec.values, delta)
    idx = np.minimum(rank, len(codec.values) - 1)
    member = codec.values[idx] == delta
    if member.all():
        new = dataclasses.replace(codec, n=codec.n + len(delta))
        return new, rank.astype(codec.dtype)
    fresh = np.unique(delta[~member])
    if fresh[0] <= int(codec.values[-1]):
        return None  # would renumber existing ranks
    d = len(codec.values) + len(fresh)
    if d - 1 > info.max - _RESERVE:
        return None  # dictionary outgrew the code dtype
    values = np.concatenate([codec.values, fresh])
    new = dataclasses.replace(codec, n=codec.n + len(delta),
                              lo=min(codec.lo, lo),
                              hi=max(codec.hi, hi),
                              values=values, did=_dict_token(values))
    return new, np.searchsorted(values, delta).astype(codec.dtype)


def encode_with(codec: ColumnCodec, vals: np.ndarray) -> np.ndarray:
    """Encode values known to lie in the codec's domain (compaction of
    surviving rows).  Stays in the existing code domain — same cid."""
    if codec.kind == "for":
        return (vals - codec.ref).astype(codec.dtype)
    return np.searchsorted(codec.values, vals).astype(codec.dtype)


def decode(codec: ColumnCodec | None, payload) -> np.ndarray:
    """Host-side decode (tests and the numpy twin use this; the torch
    backend decodes on device)."""
    if codec is None:
        return payload
    if codec.kind == "for":
        return payload.astype(np.int64) + codec.ref
    if codec.kind == "dict":
        return codec.values[payload]
    values, lengths = payload
    return np.repeat(values[:codec.nruns], lengths[:codec.nruns])


def join_token(codec: ColumnCodec | None):
    """Equality token for code-domain joins: two columns whose codecs
    share a token encode equal values to equal codes."""
    if codec is None:
        return None
    if codec.kind == "for":
        return ("for", codec.dtype.itemsize, codec.ref)
    if codec.kind == "dict":
        return ("dict", codec.did)
    return None  # rle columns decode before joining
