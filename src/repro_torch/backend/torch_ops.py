"""Device backend of the port: the inference primitives on PyTorch tensors.

``TorchOps`` is the port of the reference ``JaxOps``.  Each ``Ops``
primitive maps onto the port's kernel wrappers:

* ``sort_kv`` / ``sort_perm`` -> ``kernels/sortmerge`` tagged-key stable
  bitonic sort (``(key - kmin) << tag_bits | lane`` packs the original
  position into the low bits, making the unstable network stable and
  letting the sorted low bits double as the permutation).
* ``join_pairs`` and the fused ``join_gather_h`` -> ``kernels/mergejoin``
  (key-value bitonic sort of the right side, sorted probe, bounded
  expansion).
* ``semi_join`` -> bitonic sort + ``torch.searchsorted``.
* ``unique_mask`` -> ``kernels/uniquefilter`` (the first-of-run
  neighbour-compare kernel), as does the distinct count of ``sketch``.
* ``dedup_rows`` / ``dedup_select_h`` -> chained tagged sorts (stable
  lexsort, §2.3's SU filter) + neighbor compare.
* ``batch_probe`` -> the sorted-probe kernel against the resident sorted
  mirror that ``sort_perm`` leaves on the device.

On a ``cuda`` device every kernel wrapper launches its hand-written CUDA
kernel (or raises); on ``cpu`` the same code runs the kernels' plain
PyTorch versions — the CPU test mode.  Work the reference leaves to XLA
outside its Pallas kernels (prefix sums, gathers, scatters, the
searchsorted of the semi-join and of the write-side anti-join, and the
stable-sort fallbacks) is stock torch here too.

Width-overflow guard: tagging spends ``ceil(log2(cap))`` low bits, so a
column whose key span needs more than ``63 - tag_bits`` bits cannot be
tagged — those calls take a stock-torch stable-sort fallback, counted in
``kernels.FALLBACKS``.  Inputs whose real keys collide with a pad
sentinel on a non-tagged path take the exact host path — a correctness
guard, not a fast path.

Device residency: a ``DeviceArrayCache`` keeps per-fact-type column
buffers, packed join keys, sorted index mirrors and uid-memoized handle
results resident across calls, keyed by the owning table's version
counter.  Columns are append-only, so a buffer cached at an older version
is *extended*: only the appended tail is uploaded.  Every host<->device
conversion goes through ``self.transfers`` — a ``TransferCounter`` — so
residency is measurable.

Merge maintenance: resident index mirrors are not re-sorted per append.
Each mirror carries a ``MirrorRuns`` entry (the sorted run in tagged
form); an append sorts only the O(Δ) tail into a delta run and merges it
into the resident run (``kernels/sortmerge/ops.merge_sorted_mirror_impl``,
two ``merge_ranks`` launches plus a scatter), bit-matching the full
stable re-sort.  Compaction (a full re-sort) triggers when the run has
absorbed ``MIRROR_COMPACT_RUNS`` merges; tombstone churn, tagged width
overflow and capacity growth force the full-sort fallback.
``self.sort_work`` (a ``SortWorkCounter``) splits the device sort work
into full sorts and delta merges, so "per-append index cost scales with
Δ" is measurable.

Compressed resident columns (``compress``; ``None`` follows
``REPRO_COMPRESS``, on unless it is ``0``/``false``/``off``, as in the
reference): resident column buffers and resident handles hold dict, FoR
or RLE *codes* (``backend/codecs.py``) in the codec's narrow dtype
instead of raw int64.  Index mirrors sort, merge and probe in code
domain (order-preserving codes; the tagged runs remember the codec's
``cid`` and refuse to merge across a recode), joins over two columns
with the same join token run on the codes, two dictionaries recode the
smaller side on the device through a rank crossmap, and everything else
decodes on the device at the kernels' boundary.  Narrow codes widen to
int64 on entry to every kernel.  The decode and recode composites
(``decode_*``, ``narrow_sorted``, ``dict_crossmap``, ``map_codes``) are
stock torch, as the reference leaves them to XLA.  Decoded results are
bit-identical to the raw path; ``residency_stats()`` reports coded vs
raw resident bytes and the codec counters.

All device work runs behind a lock, because the engine's PF/PW thread
pools may issue primitives concurrently.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.backend import codecs
from repro_torch.backend.base import SKETCH_BUCKETS, Ops
from repro_torch.backend.device_cache import (DeviceArrayCache,
                                              MirrorRuns, SortWorkCounter,
                                              TransferCounter)
from repro_torch.backend.handles import DeviceCol, merge_bounds
from repro_torch.backend.numpy_ops import NumpyOps
from repro_torch.kernels.mergejoin.mergejoin import probe_sorted
from repro_torch.kernels.mergejoin.ops import (device_compact,
                                               merge_join_bounded,
                                               merge_join_gather_bounded,
                                               pack_pairs_bounded,
                                               splitmix64_dev)
from repro_torch.kernels.sortmerge.ops import (device_dedup_rows,
                                               device_merge_runs,
                                               device_sort,
                                               device_stable_sort_perm,
                                               fits_tagged_width,
                                               merge_sorted_mirror_impl,
                                               tag_bits_for,
                                               tagged_from_sorted)
from repro_torch.kernels.uniquefilter.uniquefilter import unique_mask_sorted

INT64_MAX = np.iinfo(np.int64).max
INT64_MIN = np.iinfo(np.int64).min


# --------------------------------------------------------------------------
# stock-torch composites (the reference's XLA work outside its kernels)


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` order: the last key is primary; chained stable
    sorts, least-significant key first."""
    order = torch.arange(keys[0].shape[0], dtype=torch.int64,
                         device=keys[0].device)
    for k in keys:
        if k.dtype == torch.bool:
            k = k.to(torch.int8)
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _neighbor_diff(cols, order) -> torch.Tensor:
    """First-of-run mask over rows taken in ``order``."""
    diff = torch.zeros(order.shape[0], dtype=torch.bool, device=order.device)
    diff[0] = True
    for c in cols:
        cs = c[order]
        diff[1:] |= cs[1:] != cs[:-1]
    return diff


def stable_sort_perm_fallback(keys: torch.Tensor, n_real: int):
    """Width-overflow fallback: stable (sorted, perm) via chained stable
    sorts.  Pads sort last via an explicit flag, so real keys may hold any
    int64 value including the sentinels."""
    kernels.FALLBACKS["stable_sort_perm"] += 1
    keys = keys.to(torch.int64)
    cap = keys.shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=keys.device)
    order = _lexsort((keys, lane >= n_real))
    skeys = torch.where(lane < n_real, keys[order], INT64_MAX)
    return skeys, order


def dedup_rows_fallback(cols, n_real: int):
    """Width-overflow fallback: stable lexsort + neighbor compare."""
    kernels.FALLBACKS["dedup_rows"] += 1
    cap = cols[0].shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=cols[0].device)
    order = _lexsort(tuple(reversed(cols)) + (lane >= n_real,))
    keep = _neighbor_diff(cols, order) & (order < n_real)
    rows = torch.sort(torch.where(keep, order, cap)).values
    return rows, keep.sum()


def _semi_join_n(keys, bound, n_bound: int):
    """Membership of ``keys`` lanes in ``bound[:n_bound]``: the bound side
    is re-padded here (handle pads are garbage) and membership is bounded
    by ``n_bound``, so sentinel-value collisions are impossible."""
    cap_b = bound.shape[0]
    lane_b = torch.arange(cap_b, dtype=torch.int64, device=bound.device)
    s = device_sort(torch.where(lane_b < n_bound, bound, INT64_MAX))
    pos = torch.searchsorted(s, keys).clamp(0, cap_b - 1)
    return (s[pos] == keys) & (pos < n_bound)


def _sort_pairs(keys, vals, n_real: int):
    """(key, val) rows sorted lexicographically, pads (flag-based) last —
    the probe structure for the write-side exists check."""
    lane = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    order = _lexsort((vals, keys, lane >= n_real))
    real = lane < n_real
    return (torch.where(real, keys[order], INT64_MAX),
            torch.where(real, vals[order], INT64_MAX))


def _fresh_pairs(ks, vs, n_old: int, kn, vn):
    """For each (kn, vn) row: True iff the pair does NOT appear in the
    sorted (ks, vs) rows — a branch-free binary search of ``vn`` inside
    each key's run (the write-side anti-join, no pair expansion)."""
    cap_old = ks.shape[0]
    khi = torch.searchsorted(ks, kn, right=True).clamp(max=n_old)
    lo = torch.searchsorted(ks, kn).clamp(max=n_old)
    hi = khi
    for _ in range(max(1, cap_old.bit_length()) + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        go = vs[mid.clamp(0, cap_old - 1)] < vn
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    found = (lo < khi) & (vs[lo.clamp(0, cap_old - 1)] == vn)
    return ~found


def _decode_lanes(x, vt: int):
    """Int64 lanes -> an order-comparable domain (twin of
    ``facts.decode_lane_array``)."""
    if vt == 5:    # FLOAT: low 32 bits are a float32 pattern
        return x.to(torch.int32).view(torch.float32)
    if vt == 6:    # DOUBLE
        return x.view(torch.float64)
    if vt == 4:    # UINT64: flipping the sign bit keeps the unsigned order
        return x ^ INT64_MIN
    return x


_CMP = {"==": torch.eq, "!=": torch.ne, ">=": torch.ge, "<=": torch.le,
        ">": torch.gt, "<": torch.lt}


def _lanes(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], dtype=torch.int64, device=x.device)


def _unsigned_mod(z: torch.Tensor, m: int) -> torch.Tensor:
    """``z`` read as uint64, modulo ``m`` (torch's ``%`` is a signed
    floor-mod: a negative lane is its uint64 value minus 2**64)."""
    r = torch.remainder(z, m)
    return torch.where(z < 0, (r + (1 << 64) % m) % m, r)


def sketch_hist(x: torch.Tensor, n_real: int, buckets: int):
    """Cardinality sketch over one padded int64 column (pads are int64
    max): per-bucket row counts, per-bucket distinct-value counts and
    the distinct total, all as device tensors.  The column sorts through
    ``device_sort`` and its first-of-run mask is the ``unique_mask_sorted``
    kernel, the function the reference computes inline; the bucketing
    (splitmix64 mod ``buckets``) and the histograms are stock torch."""
    valid = _lanes(x) < n_real

    def hist(vals, keep):
        b = _unsigned_mod(splitmix64_dev(vals), buckets)
        out = torch.zeros(buckets + 1, dtype=torch.int64, device=x.device)
        out.scatter_add_(0, torch.where(keep, b, buckets),
                         torch.ones_like(b))
        return out[:buckets]

    s = device_sort(x)  # pads are int64 max: they sort last
    newv = unique_mask_sorted(s) & valid
    return hist(x, valid), hist(s, newv), newv.sum()


# --------------------------------------------------------------------------
# compressed-column composites: decode and recode on the device, never on
# the host (the reference's XLA work outside its kernels)

_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def widen(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def decode_for(codes: torch.Tensor, ref: int) -> torch.Tensor:
    """Frame-of-reference decode; pad lanes stay garbage (handle
    contract: consumers mask by n)."""
    return widen(codes) + ref


def decode_for_n(codes: torch.Tensor, ref: int, n_real: int,
                 fill: int) -> torch.Tensor:
    """Frame-of-reference decode with exact re-pad: lanes past ``n_real``
    become ``fill`` (for consumers whose pad lanes are load-bearing
    sentinels)."""
    return torch.where(_lanes(codes) < n_real, decode_for(codes, ref), fill)


def decode_dict(codes: torch.Tensor, dvals: torch.Tensor) -> torch.Tensor:
    """Dictionary decode (rank gather); pad lanes garbage."""
    return dvals[widen(codes).clamp(0, dvals.shape[0] - 1)]


def decode_dict_n(codes: torch.Tensor, dvals: torch.Tensor,
                  n_real: int) -> torch.Tensor:
    """Dictionary decode with exact re-pad to int64 max (sort inputs:
    pads must sort last)."""
    return torch.where(_lanes(codes) < n_real, decode_dict(codes, dvals),
                       INT64_MAX)


def decode_rle(values: torch.Tensor, lengths: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Run-length decode to ``cap`` lanes.  Run pads have length 0; lane
    ``p`` takes the run whose end is the first one past ``p``, so lanes
    past the real prefix repeat the last run (garbage by contract).  A
    searchsorted over the run ends instead of ``repeat_interleave``,
    whose ``output_size`` must equal the sum of the repeats."""
    ends = torch.cumsum(widen(lengths).clamp(0, cap), 0)
    lane = torch.arange(cap, dtype=torch.int64, device=values.device)
    run = torch.searchsorted(ends, lane, right=True)
    return values[run.clamp(max=values.shape[0] - 1)]


def decode_sorted_for(sk: torch.Tensor, n_real: int, ref: int
                      ) -> torch.Tensor:
    """Decode a code-domain sorted mirror, re-padding with the sort
    sentinel so the output obeys the sorted-buffer contract."""
    return torch.where(_lanes(sk) < n_real, sk + ref, INT64_MAX)


def decode_sorted_dict(sk: torch.Tensor, n_real: int,
                       dvals: torch.Tensor) -> torch.Tensor:
    return torch.where(_lanes(sk) < n_real,
                       dvals[sk.clamp(0, dvals.shape[0] - 1)], INT64_MAX)


def narrow_sorted(sk: torch.Tensor, n_real: int, dtype) -> torch.Tensor:
    """Store a code-domain sorted mirror at the codec's width: real codes
    fit by construction, pads re-fill with the narrow dtype's max so the
    stored mirror stays sorted (probes search the whole buffer)."""
    dt = _TORCH_DTYPE[np.dtype(dtype)]
    return torch.where(_lanes(sk) < n_real, sk,
                       torch.iinfo(dt).max).to(dt)


def dict_crossmap(lvals: torch.Tensor, rvals: torch.Tensor,
                  no_match: int) -> torch.Tensor:
    """Cross-dictionary recode table: left rank -> right rank for shared
    values, ``no_match`` (the right domain's never-matching code)
    otherwise.  Both dictionaries are sorted int64."""
    rank = torch.searchsorted(rvals, lvals)
    idx = rank.clamp(0, rvals.shape[0] - 1)
    return torch.where(rvals[idx] == lvals, rank, no_match)


def map_codes(cmap: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Apply a crossmap to a code column (recode one join side on the
    device); garbage pad codes clip harmlessly."""
    return cmap[widen(codes).clamp(0, cmap.shape[0] - 1)]


class TorchOps(Ops):
    """Bounded-shape, device-resident implementation of ``Ops`` on torch
    tensors (see the module docstring)."""

    prefer_handles = True
    MIRROR_COMPACT_RUNS = 64

    def __init__(self, device: str = "cuda", block: int = 1024,
                 cache_bytes: int | None = None,
                 compress: bool | None = None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'torch' needs a CUDA device and this process "
                    "sees none (use 'torch-cpu' for the CPU test mode)")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device: {device!r}")
        self.block = block  # smallest bucket of a full-size column
        self.name = f"torch[{self.device.type}]"
        self._host = NumpyOps()  # exact fallback for sentinel collisions
        self._lock = threading.Lock()
        self.transfers = TransferCounter()
        self.sort_work = SortWorkCounter()
        if cache_bytes is None:
            # a quarter of the card: the resident columns, index mirrors
            # and memoized join results of a LUBM-class fact base outgrow
            # a few GiB, and an evicted mirror run loses its merge state
            cache_bytes = (torch.cuda.get_device_properties(
                self.device).total_memory // 4
                if self.device.type == "cuda" else 256 << 20)
        self.cache = DeviceArrayCache(cache_bytes)
        # compressed device-resident columns: on by default (decoded
        # results are bit-identical by construction); REPRO_COMPRESS=0
        # or compress=False keeps raw int64 buffers end to end
        if compress is None:
            env = os.environ.get("REPRO_COMPRESS")
            compress = env is None or env not in ("0", "false", "off")
        self.compress = bool(compress)
        # codec accounting (monotone; residency_stats() reads them)
        self._res_counts = {"for": 0, "dict": 0, "rle": 0,
                            "recode_rebuilds": 0, "dict_extends": 0,
                            "decode_calls": 0, "code_joins": 0,
                            "cross_recodes": 0}
        self._dict_bufs: dict[int, torch.Tensor] = {}  # did -> dictionary

    # -- plumbing ---------------------------------------------------------
    def _bucket(self, n: int) -> int:
        return max(self.block, 1 << (max(n, 1) - 1).bit_length())

    @staticmethod
    def _delta_bucket(n: int) -> int:
        """Small power-of-two bucket for small columns (h2d bytes scale
        with the column, not with the block)."""
        return max(32, 1 << (max(n, 1) - 1).bit_length())

    @staticmethod
    def _pad(a: np.ndarray, cap: int, fill: int, dtype=np.int64
             ) -> np.ndarray:
        """``a`` padded to ``cap`` lanes of ``dtype`` (codes ship narrow)."""
        out = np.full(cap, fill, dtype)
        out[: len(a)] = a
        return out

    def _dict_dev(self, codec) -> torch.Tensor | None:
        """Device copy of a codec's dictionary, shared per ``did`` (the
        content token) so self-joins upload it once.  Caller holds the
        lock."""
        if codec is None or codec.values is None:
            return None
        buf = self._dict_bufs.get(codec.did)
        if buf is None:
            if len(self._dict_bufs) > 512:  # dids are content-hashed;
                self._dict_bufs.clear()     # bound stale-token buildup
            buf = self._to_dev(codec.values)
            self._dict_bufs[codec.did] = buf
        return buf

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """Upload (counted); always a copy, never a view of ``a``."""
        a = np.ascontiguousarray(a)
        self.transfers.count_h2d(a.nbytes)
        return torch.tensor(a, device=self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Download (counted); always a copy, never a view of ``t``."""
        out = t.detach().cpu().numpy()
        if self.device.type == "cpu":
            out = out.copy()
        self.transfers.count_d2h(out.nbytes)
        return out

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int64, device=self.device)

    # -- device-resident column buffers ------------------------------------
    def _colbuf_nbytes(self, value: dict) -> int:
        codec = value["codec"]
        extra = (codec.values.nbytes
                 if codec is not None and codec.values is not None else 0)
        return value["buf"].nbytes + extra

    def _extend_colbuf(self, key, version: int, old: dict,
                       col: np.ndarray) -> dict | None:
        """Tail extension of a resident column buffer: only the appended
        tail goes up, into a copy of the buffer (readers of the older
        version keep theirs).  Coded buffers extend in *code domain*: the
        tail is encoded with the resident codec (a dictionary may
        append-extend — existing rank codes are untouched, so derived
        mirrors stay valid).  Returns ``None`` when the tail escapes the
        code domain or the capacity; the caller recodes/rebuilds."""
        n, n_old = len(col), old["n"]
        if n > old["buf"].shape[0]:
            return None
        delta = col[n_old:]
        codec = old["codec"]
        if codec is None:
            tail = delta
        else:
            enc = codecs.try_encode_delta(codec, delta)
            if enc is None:
                return None
            codec_new, tail = enc
            if codec_new.did != codec.did:
                self._res_counts["dict_extends"] += 1
            codec = codec_new
        buf = old["buf"].clone()
        buf[n_old:n] = self._to_dev(tail)
        value = {"buf": buf, "n": n,
                 "kmin": min(old["kmin"], int(tail.min())),
                 "kmax": max(old["kmax"], int(tail.max())),
                 "codec": codec, "dvals": self._dict_dev(codec)}
        self.cache.put(key, version, value, self._colbuf_nbytes(value))
        self.cache.note_extended(key)
        return value

    def _resident_column(self, cache_key, version: int, col: np.ndarray,
                         fill: int, *, encode: bool | None = None,
                         hint: str | None = None) -> dict:
        """Device buffer of an append-only int64 column (a table's index
        column, packed keys or values): ``{"buf", "n", "kmin", "kmax",
        "codec", "dvals"}``.

        With ``codec=None`` the buffer is the raw int64 column padded
        with ``fill`` and ``kmin``/``kmax`` are value bounds.  With a
        codec the buffer holds *codes* in the codec's narrow dtype,
        ``kmin``/``kmax`` are **code-domain** bounds (what the tagged
        sort needs), pads are the codec's code-domain twin of ``fill``
        and ``dvals`` is the device dictionary (dict codecs).  A hit at
        ``version`` costs nothing; an entry cached at an older version
        whose length is a prefix of ``col`` is *extended*; anything else
        uploads the column whole.  ``encode=False`` keeps a cold build
        raw (``hint`` names the codec the caller expects).  Caller holds
        the lock."""
        key = ("colbuf", cache_key, fill)
        n = len(col)
        hit = self.cache.get(key, version)
        if hit is not None and hit["n"] == n:
            return hit
        e = self.cache.get_any(key)
        if e is not None and e.version < version and e.value["n"] < n:
            value = self._extend_colbuf(key, version, e.value, col)
            if value is not None:
                return value
            if e.value["codec"] is not None:
                self._res_counts["recode_rebuilds"] += 1
        # full (re-)upload: first sight of this column, a non-append
        # change, capacity growth, or a tail that escaped the code domain
        do_encode = self.compress if encode is None else encode
        codec = payload = None
        if do_encode and n:
            codec, payload = codecs.choose_codec(col, hint=hint)
            # a rebuild whose fresh codec encodes *identically* to the
            # displaced one (same FoR ref and width, or same dictionary)
            # keeps the old code-domain identity, so coded mirror runs
            # stay mergeable across capacity growth
            if codec is not None and e is not None:
                oldc = e.value["codec"]
                if oldc is not None and codecs.same_code_domain(oldc,
                                                                codec):
                    codec = dataclasses.replace(codec, cid=oldc.cid)
        cap = self._bucket(n)
        if codec is None:
            buf = self._to_dev(self._pad(col, cap, fill))
            value = {"buf": buf, "n": n, "kmin": int(col.min()),
                     "kmax": int(col.max()), "codec": None, "dvals": None}
        else:
            self._res_counts[codec.kind] += 1
            buf = self._to_dev(self._pad(payload, cap, codec.pad_code(fill),
                                         codec.dtype))
            value = {"buf": buf, "n": n, "kmin": int(payload.min()),
                     "kmax": int(payload.max()), "codec": codec,
                     "dvals": self._dict_dev(codec)}
        self.cache.put(key, version, value, self._colbuf_nbytes(value))
        return value

    def _raw_colbuf(self, cv: dict, col: np.ndarray, fill: int):
        """Raw int64 device view of a resident column entry.  A shared
        entry may be *coded* even for a caller that passed
        ``encode=False``: that flag governs a cold build only, while a
        hit or an append-extend returns whatever domain another consumer
        cached (``join_pairs`` dict-codes the packed-key column).  Coded
        buffers decode on the device; pad lanes refill with a sentinel,
        which the pad-flag-based consumers ignore.  Caller holds the
        lock."""
        codec = cv["codec"]
        if codec is None:
            return cv["buf"]
        n = cv["n"]
        if codec.kind == "for":
            return decode_for_n(cv["buf"], codec.ref, n, fill)
        if codec.kind == "dict" and cv["dvals"] is not None:
            self._res_counts["decode_calls"] += 1
            return decode_dict_n(cv["buf"], cv["dvals"], n)
        # unknown coded shape: transient raw upload
        return self._to_dev(self._pad(col, self._bucket(len(col)), fill))

    # -- primitives -------------------------------------------------------
    def _stable_perm_device(self, buf, n: int, kmin: int, kmax: int):
        """(sorted, perm) device tensors for a padded buffer: tagged-key
        bitonic sort when the key span fits, the stable-sort fallback
        otherwise.  Caller holds the lock."""
        cap = buf.shape[0]
        if fits_tagged_width(kmin, kmax, cap):
            return device_stable_sort_perm(buf, n, kmin,
                                           tag_bits=tag_bits_for(cap))
        return stable_sort_perm_fallback(buf, n)

    def _mirror_sort_device(self, cache_key, version: int, buf, n: int,
                            kmin: int, kmax: int, n_dead: int, keys64,
                            alive, codec=None):
        """(sorted, perm, real length) device tensors for a cached mirror,
        maintained incrementally: when the resident ``MirrorRuns`` entry
        is an append-only prefix of the column at an unchanged capacity,
        only the tail is tagged-sorted (O(Δ log Δ)) and merged into the
        resident run — tombstone deltas ride along as carried dead weight
        (lookups alive-filter the perm, so the mirror stays sound);
        otherwise — cold build, capacity growth, width overflow, dead
        weight past a quarter of the alive rows, or the compaction
        threshold — the full sort runs and (when taggable) seeds a fresh
        run entry.

        Every full-sort event on a tombstoned column (``alive`` given,
        ``n_dead > 0``) **compacts**: only the alive rows are sorted
        (host-gathered, transient upload) and the seeded run maps its tag
        bits back to original row ids, so the mirror — and every merge
        after it — stops carrying dead rows.

        With a ``codec`` the buffer (and so the whole mirror) lives in
        code domain: ``kmin``/``kmax`` are code bounds — narrow codes are
        what lets wide-spread columns pass ``fits_tagged_width`` — and
        the resident run remembers the codec's ``cid``, refusing to merge
        across a recode (a recode renumbers existing rows, so the old
        run's tagged codes are in a dead domain).  Caller holds the
        lock."""
        cap = buf.shape[0]
        tb = tag_bits_for(cap)
        fits = fits_tagged_width(kmin, kmax, cap)
        cid = codec.cid if codec is not None else 0
        key = ("runs", cache_key)
        ent = self.cache.get_any(key)
        runs = ent.value if ent is not None else None
        compacting = (runs is not None and
                      runs.merges >= self.MIRROR_COMPACT_RUNS)
        # dead rows the resident run still carries: tombstoned since the
        # run last compacted them out
        carried = n_dead - runs.n_dead if runs is not None else 0
        churned = runs is not None and (
            carried < 0 or carried * 4 > max(n - n_dead, 1))
        if (runs is not None and fits and not compacting and not churned
                and runs.cap == cap and runs.tag_bits == tb
                and runs.cid == cid
                and runs.src_n < n and runs.kmin >= kmin):
            d = n - runs.src_n
            dcap = self._delta_bucket(d)
            if dcap <= cap:  # the slice window slides back if needed
                sk, perm, merged = merge_sorted_mirror_impl(
                    buf, runs.tagged, runs.n, runs.src_n, n, kmin,
                    runs.kmin, dcap=dcap, tag_bits=tb)
                self.cache.put(key, version, MirrorRuns(
                    tagged=merged, n=runs.n + d, kmin=kmin, cap=cap,
                    tag_bits=tb, merges=runs.merges + 1,
                    n_dead=runs.n_dead, src_n=n, cid=cid), merged.nbytes)
                self.sort_work.count_merge(dcap * 8)
                return sk, perm, runs.n + d
        rebuild = (runs is not None and not compacting and
                   (not fits or churned))
        if alive is not None and n_dead > 0:
            # tombstone compaction: sort only the alive rows.  The
            # compacted column is a transient upload (the resident column
            # buffer stays as-is for later tail slices); the perm maps
            # back to original row ids through the gather
            rows = np.flatnonzero(np.asarray(alive[:n], bool))
            m = len(rows)
            if m == 0:
                self.cache.invalidate(key)
                self.sort_work.count_full(0, compaction=compacting,
                                          rebuild=rebuild)
                return None, None, 0
            ckeys = keys64[rows]
            ccap = self._bucket(m)
            if codec is not None:
                # stay in code domain so the seeded run matches the
                # resident buffer's domain (same cid as the colbuf)
                ckeys = codecs.encode_with(codec, ckeys).astype(np.int64)
            cbuf = self._to_dev(self._pad(ckeys, ccap, INT64_MAX))
            sk, permc = self._stable_perm_device(
                cbuf, m, int(ckeys.min()), int(ckeys.max()))
            rows_dev = self._to_dev(self._pad(rows, ccap, 0))
            perm = rows_dev[permc]
            self.sort_work.count_full(ccap * 8, compaction=compacting,
                                      rebuild=rebuild)
            if fits:  # seed a compacted run at the column buffer's cap
                pad_n = cap - ccap
                if pad_n > 0:
                    sk_f = torch.cat([sk, torch.full(
                        (pad_n,), INT64_MAX, dtype=torch.int64,
                        device=self.device)])
                    pm_f = torch.cat([perm, torch.arange(
                        ccap, cap, dtype=torch.int64, device=self.device)])
                else:
                    sk_f, pm_f = sk, perm
                tagged = tagged_from_sorted(sk_f, pm_f, m, kmin,
                                            tag_bits=tb)
                self.cache.put(key, version, MirrorRuns(
                    tagged=tagged, n=m, kmin=kmin, cap=cap, tag_bits=tb,
                    merges=0, n_dead=n_dead, src_n=n, cid=cid),
                    tagged.nbytes)
            else:
                self.cache.invalidate(key)
            return sk, perm, m
        sk, perm = self._stable_perm_device(buf, n, kmin, kmax)
        self.sort_work.count_full(cap * 8, compaction=compacting,
                                  rebuild=rebuild)
        if fits:
            tagged = tagged_from_sorted(sk, perm, n, kmin, tag_bits=tb)
            # the run holds ALL n rows (nothing compacted out): n_dead=0
            self.cache.put(key, version, MirrorRuns(
                tagged=tagged, n=n, kmin=kmin, cap=cap, tag_bits=tb,
                merges=0, n_dead=0, src_n=n, cid=cid), tagged.nbytes)
        else:
            # width overflow: the fallback's output has no tagged form to
            # merge into — appends keep re-sorting
            self.cache.invalidate(key)
        return sk, perm, n

    def sort_perm(self, keys: np.ndarray, *, cache_key=None,
                  version: int | None = None, n_dead: int = 0,
                  alive=None, hint: str | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys)
        n = len(keys)
        if n == 0:
            return keys.astype(np.int64), np.empty(0, np.int64)
        use_cache = cache_key is not None and version is not None
        if use_cache:
            hit = self.cache.get(("perm", cache_key), version)
            if hit is not None:
                return hit  # host mirrors: zero transfers
        keys64 = keys.astype(np.int64, copy=False)
        with self._lock:
            if use_cache:
                colv = self._resident_column(cache_key, version, keys64,
                                             INT64_MAX, hint=hint)
                codec = colv["codec"]
                sk, perm, n_real = self._mirror_sort_device(
                    cache_key, version, colv["buf"], n, colv["kmin"],
                    colv["kmax"], int(n_dead), keys64, alive, codec)
                if sk is None:  # fully tombstoned: empty mirror
                    out = (np.empty(0, np.int64), np.empty(0, np.int64))
                    self.cache.invalidate(("permdev", cache_key))
                    self.cache.put(("perm", cache_key), version, out, 0)
                    return out
                # the device-side sorted mirror stays resident: batched
                # rank-1 probes (``batch_probe``) search it without
                # re-uploading the sorted column.  Coded columns keep the
                # *narrow code-domain* mirror (probes are encoded into
                # the same domain on the host) and decode the sorted
                # keys on the device for the host mirror
                if codec is not None:
                    sk_store = narrow_sorted(sk, n_real, codec.dtype)
                    self._res_counts["decode_calls"] += 1
                    if codec.kind == "dict":
                        sk = decode_sorted_dict(sk, n_real, colv["dvals"])
                    else:
                        sk = decode_sorted_for(sk, n_real, codec.ref)
                else:
                    sk_store = sk
                self.cache.put(("permdev", cache_key), version,
                               {"sk": sk_store, "n": n_real, "codec": codec},
                               sk_store.nbytes)
            elif alive is not None and n_dead:
                # uncached + tombstoned: compact on the host, sort the
                # alive rows, map the perm back to original row ids
                rows = np.flatnonzero(np.asarray(alive[:n], bool))
                if len(rows) == 0:
                    return np.empty(0, np.int64), np.empty(0, np.int64)
                kept = keys64[rows]
                buf = self._to_dev(
                    self._pad(kept, self._bucket(len(rows)), INT64_MAX))
                sk, perm = self._stable_perm_device(
                    buf, len(rows), int(kept.min()), int(kept.max()))
                self.sort_work.count_full(buf.shape[0] * 8)
                n_real = len(rows)
                return (self._to_host(sk[:n_real]),
                        rows[self._to_host(perm[:n_real])])
            else:
                buf = self._to_dev(
                    self._pad(keys64, self._bucket(n), INT64_MAX))
                sk, perm = self._stable_perm_device(
                    buf, n, int(keys64.min()), int(keys64.max()))
                self.sort_work.count_full(buf.shape[0] * 8)
                n_real = n
            out = (self._to_host(sk[:n_real]), self._to_host(perm[:n_real]))
        if use_cache:
            # hits hand out these exact arrays (aliased into engine index
            # state): freeze them so an in-place write fails loudly
            # instead of corrupting every later hit at this version
            out[0].flags.writeable = False
            out[1].flags.writeable = False
            self.cache.put(("perm", cache_key), version, out,
                           out[0].nbytes + out[1].nbytes)
        return out

    def sort_kv(self, keys: np.ndarray, vals: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        n = len(keys)
        if n == 0:
            return keys.copy(), vals.copy()
        cap = self._bucket(n)
        with self._lock:
            kp = self._to_dev(self._pad(keys, cap, INT64_MAX))
            vp = self._to_dev(self._pad(vals, cap, 0))
            sk, perm = self._stable_perm_device(
                kp, n, int(keys.min()), int(keys.max()))
            ks = self._to_host(sk[:n])
            vs = self._to_host(vp[perm[:n]])
        return ks, vs

    def merge_runs(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Bounded two-run merge on the device (``merge_ranks``).  No
        sentinel-collision fallback is needed: the rank searches run over
        MAX-padded arrays but are clamped by the runs' real lengths, so
        real keys equal to the sentinel still land in the right
        positions."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        n_a, n_b = len(a), len(b)
        if n_a == 0 or n_b == 0:
            return (b if n_a == 0 else a).copy()
        cap = self._bucket(n_a + n_b)
        with self._lock:
            ap = self._to_dev(self._pad(a, cap, INT64_MAX))
            bp = self._to_dev(self._pad(b, self._delta_bucket(n_b),
                                        INT64_MAX))
            out = device_merge_runs(ap, bp, n_a, n_b)
            return self._to_host(out[: n_a + n_b])

    def join_pairs(self, lkeys: np.ndarray, rkeys: np.ndarray, *,
                   rkeys_key=None, rkeys_version: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        lkeys = np.asarray(lkeys, np.int64)
        rkeys = np.asarray(rkeys, np.int64)
        n, m = len(lkeys), len(rkeys)
        if n == 0 or m == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        # left pads (MAX) must not match real right keys and right pads
        # (MIN) must not match real left keys
        if lkeys.min() == INT64_MIN or rkeys.max() == INT64_MAX:
            kernels.FALLBACKS["join_host_redo"] += 1
            return self._host.join_pairs(lkeys, rkeys)
        cap = self._bucket(max(n, m))
        with self._lock:
            if rkeys_key is not None and rkeys_version is not None:
                colv = self._resident_column(rkeys_key, rkeys_version, rkeys,
                                             INT64_MIN)
                rp = colv["buf"]
                if colv["codec"] is not None:
                    # the right side is resident in code domain: encode
                    # the probe keys into the same domain instead of
                    # decoding the buffer.  Absent left keys become
                    # ``no_match_code`` (above every real code, inside
                    # both pad sentinels), which matches nothing
                    lkeys = codecs.encode_probes(colv["codec"], lkeys)
            else:
                rp = self._to_dev(self._pad(rkeys, self._bucket(m),
                                            INT64_MIN))
            lp = self._to_dev(self._pad(lkeys, self._bucket(n), INT64_MAX))
            while True:
                li, ri, valid, total = merge_join_bounded(lp, rp,
                                                          out_cap=cap)
                total = int(total)
                if total <= cap:
                    break
                cap = self._bucket(total)  # one retry: exact total known
            if total == 0:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            # valid pairs are a prefix: pack (li << 32 | ri) on device and
            # download the prefix once — one transfer, not three
            packed = self._to_host(pack_pairs_bounded(li, ri, valid)[:total])
        return packed >> 32, packed & 0xFFFFFFFF

    def _narrow_h2d(self, a: np.ndarray, cap: int, fill: int, lo: int,
                    hi: int) -> torch.Tensor:
        """Upload an int64 array through a frame-of-reference narrowing
        when ``[lo, hi]`` fits a smaller dtype, then widen back on the
        device (transient-transfer compression: the shift is exact, and
        lanes past the real prefix re-pad to ``fill``).  Raw upload when
        compression is off or the span is too wide.  Caller holds the
        lock."""
        dt = codecs.smallest_dtype(hi - lo) if self.compress else None
        if dt is None:
            return self._to_dev(self._pad(a, cap, fill))
        nar = self._to_dev(self._pad((a - lo).astype(dt), cap,
                                     np.iinfo(dt).max, dt))
        return decode_for_n(nar, lo, len(a), fill)

    def unique_mask(self, sorted_keys: np.ndarray) -> np.ndarray:
        """First-of-run mask through the ``unique_mask_sorted`` kernel.
        The keys go up narrowed by their span (``_narrow_h2d``); the
        span is taken over the whole array, so an unsorted input still
        uploads exactly and gets the neighbour-compare mask."""
        x = np.asarray(sorted_keys, np.int64)
        n = len(x)
        if n == 0:
            return np.zeros(0, bool)
        # tail pads never influence mask lanes < n: no sentinel guard
        with self._lock:
            xp = self._narrow_h2d(x, self._bucket(n), INT64_MAX,
                                  int(x.min()), int(x.max()))
            mask = self._to_host(unique_mask_sorted(xp)[:n])
        return mask

    def semi_join(self, keys: np.ndarray, bound_values: np.ndarray
                  ) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        bound = np.asarray(bound_values, np.int64)
        n, m = len(keys), len(bound)
        if n == 0 or m == 0:
            return np.zeros(n, bool)
        # membership is bounded by the real bound length, so no key value
        # (the sentinels included) can match a pad lane
        with self._lock:
            kp = self._narrow_h2d(keys, n, INT64_MAX, int(keys.min()),
                                  int(keys.max()))
            bp = self._narrow_h2d(bound, m, INT64_MAX, int(bound.min()),
                                  int(bound.max()))
            mask = self._to_host(_semi_join_n(kp, bp, m))
        return mask

    def dedup_rows(self, cols: list[np.ndarray]) -> np.ndarray:
        cols = [np.asarray(c, np.int64) for c in cols]
        n = len(cols[0])
        if n == 0:
            return np.empty(0, np.int64)
        cap = self._bucket(n)
        spans = [(int(c.min()), int(c.max())) for c in cols]
        tagged_ok = all(fits_tagged_width(lo, hi, cap) for lo, hi in spans)
        with self._lock:
            padded = tuple(self._to_dev(self._pad(c, cap, INT64_MAX))
                           for c in cols)
            if tagged_ok:
                rows, count = device_dedup_rows(
                    padded, n, [lo for lo, _ in spans],
                    tag_bits=tag_bits_for(cap))
            else:
                rows, count = dedup_rows_fallback(padded, n)
            count = int(self._to_host(count))
            rows = self._to_host(rows[:count])
        return rows.astype(np.int64)

    # -- handle tier (device-resident, uid-memoized) -----------------------
    # Every method below keeps its result on device inside a ``DeviceCol``
    # and memoizes it in the ``DeviceArrayCache`` keyed by the operand
    # handles' uids.  Handles are immutable and uids are never reused, so
    # a memo hit is sound — and it is what makes a *repeated* island
    # evaluation at a fixed table version cost zero transfers and zero
    # device work.

    @staticmethod
    def _memoable(*handles) -> bool:
        """Memoize only chains built from stable handles — an op with a
        transient operand (delta-window state) can never see the same
        uids again, so a memo entry would be a guaranteed-dead miss."""
        return all(h.stable for h in handles)

    def _memo_get(self, key):
        return self.cache.get(("hmemo",) + key, 0)

    def _memo_put(self, key, value, nbytes: int):
        self.cache.put(("hmemo",) + key, 0, value, int(nbytes))
        return value

    def _empty_h(self) -> DeviceCol:
        e = np.empty(0, np.int64)
        return DeviceCol(e, 0, self, host=e)

    @staticmethod
    def _nbytes(*datas) -> int:
        return sum(getattr(d, "nbytes", 0) for d in datas)

    def _fit_cap(self, data, cap: int):
        """Align a device buffer to ``cap`` lanes (pad lanes are garbage
        by contract, so zero-fill is fine)."""
        cur = data.shape[0]
        if cur == cap:
            return data
        if cur > cap:
            return data[:cap]
        return torch.cat([data, torch.zeros(cap - cur, dtype=data.dtype,
                                            device=data.device)])

    def _upload_locked(self, arr) -> DeviceCol:
        arr = np.ascontiguousarray(np.asarray(arr, np.int64))
        n = len(arr)
        if n == 0:
            return self._empty_h()
        # small columns pad to a small power-of-two bucket — h2d bytes
        # scale with the column, not with the block (the device programs
        # re-pad internally, so a sub-block cap is legal everywhere)
        buf = self._to_dev(self._pad(arr, self._delta_bucket(n), 0))
        return DeviceCol(buf, n, self, int(arr.min()), int(arr.max()),
                         host=arr)

    def upload(self, arr) -> DeviceCol:
        with self._lock:
            return self._upload_locked(arr)

    def upload_resident(self, cache_key, version: int, arr,
                        assume_prefix: bool = False,
                        transient: bool = False) -> DeviceCol:
        """Delta-only upload of an append-frontier column (semi-naive
        eval): the device buffer for ``cache_key`` stays resident across
        versions, and when the cached state is a prefix of ``arr`` — rows
        appended at the frontier, nothing rewritten — only the tail goes
        up.  The returned handle is stable per ``(cache_key, version)``,
        so downstream uid-keyed memos keep hitting between appends."""
        arr = np.ascontiguousarray(np.asarray(arr, np.int64))
        n = len(arr)
        if n == 0:
            return self._empty_h()
        if transient:
            # one-shot window: no resident entry could ever be reused,
            # so upload straight and poison downstream memoization
            with self._lock:
                h = self._upload_locked(arr)
            h.stable = False
            return h
        key = ("rescol", cache_key)
        hit = self.cache.get(key, version)
        if hit is not None and hit.n == n:
            return hit
        with self._lock:
            e = self.cache.get_any(key)
            if e is not None and e.value.n < n:
                old = e.value
                n_old = old.n
                delta = arr[n_old:]
                prefix_ok = old.bounds_known() and (
                    assume_prefix or (
                        old._host is not None and
                        np.array_equal(arr[:n_old], old._host[:n_old])))
                if prefix_ok and old.codec is not None:
                    h = self._extend_res_coded(key, version, old, arr, delta)
                    if h is not None:
                        return h
                    self._res_counts["recode_rebuilds"] += 1
                elif prefix_ok and n <= old.data.shape[0]:
                    buf = old.data.clone()  # the old handle stays valid
                    buf[n_old:n] = self._to_dev(delta)
                    h = DeviceCol(buf, n, self, min(int(delta.min()), old.lo),
                                  max(int(delta.max()), old.hi), host=arr)
                    self.cache.put(key, version, h, buf.nbytes)
                    self.cache.note_extended(key)
                    return h
            h = self._upload_res_locked(arr)
        self.cache.put(key, version, h, self._res_nbytes(h))
        return h

    def _res_nbytes(self, h: DeviceCol) -> int:
        """Cache-accounted bytes of a resident handle: the *coded*
        footprint (plus the dictionary).  A forced decode materializes a
        transient int64 buffer on top; that working set is deliberately
        not accounted (it dies with the handle)."""
        if h.codec is None:
            return getattr(h._data, "nbytes", 0)
        if h.codec.kind == "rle":
            return h.codes["v"].nbytes + h.codes["l"].nbytes
        extra = (h.codec.values.nbytes
                 if h.codec.values is not None else 0)
        return h.codes.nbytes + extra

    def _decode_thunk(self, codec, codes, dvals):
        """Deferred device-side decode for a coded resident handle.  Runs
        at most once, on the first ``.data`` access, and takes NO backend
        lock (it can fire inside a locked region)."""
        def thunk():
            self._res_counts["decode_calls"] += 1
            if codec.kind == "for":
                return decode_for(codes, codec.ref)
            if codec.kind == "dict":
                return decode_dict(codes, dvals)
            return decode_rle(codes["v"], codes["l"], codes["cap"])
        return thunk

    def _coded_handle(self, arr, codec, codes) -> DeviceCol:
        dvals = self._dict_dev(codec) if codec.kind == "dict" else None
        return DeviceCol(None, len(arr), self, int(arr.min()),
                         int(arr.max()), host=arr, codec=codec, codes=codes,
                         thunk=self._decode_thunk(codec, codes, dvals))

    def _upload_res_locked(self, arr) -> DeviceCol:
        """Resident-column upload: codes when an exact codec beats raw
        int64 (RLE allowed: resident frontiers are often run-heavy
        derived columns), raw otherwise.  The handle keeps the code
        buffer and codec visible (``h.codes`` / ``h.codec``) so joins can
        run in code domain; the int64 view decodes lazily on the device.
        Caller holds the lock."""
        n = len(arr)
        codec = payload = None
        if self.compress and n >= 16:
            codec, payload = codecs.choose_codec(arr, allow_rle=True,
                                                 min_n=16)
        if codec is None:
            return self._upload_locked(arr)
        self._res_counts[codec.kind] += 1
        cap = self._delta_bucket(n)
        if codec.kind == "rle":
            values, lengths = payload
            rcap = self._delta_bucket(codec.nruns)
            codes = {"v": self._to_dev(self._pad(values, rcap, 0)),
                     "l": self._to_dev(self._pad(lengths, rcap, 0,
                                                 np.int32)),
                     "cap": cap}
        else:
            codes = self._to_dev(self._pad(payload, cap, 0, codec.dtype))
        return self._coded_handle(arr, codec, codes)

    def _extend_res_coded(self, key, version: int, old: DeviceCol,
                          arr: np.ndarray, delta: np.ndarray
                          ) -> DeviceCol | None:
        """Code-domain tail extension of a coded resident column: only
        the encoded tail ships, into copies of the code buffers (the old
        handle stays valid).  A dictionary grows by append-only
        extension (existing rank codes untouched, same ``cid``); RLE
        appends run pairs (non-maximal runs are sound).  Returns ``None``
        when the tail escapes the code domain or the capacity; the caller
        recode-rebuilds.  Caller holds the lock."""
        n, n_old = len(arr), old.n
        codec = old.codec
        enc = codecs.try_encode_delta(codec, delta)
        if enc is None:
            return None
        new_codec, payload = enc
        if codec.kind == "rle":
            values, lengths = payload
            r0, r1 = codec.nruns, new_codec.nruns
            if n > old.codes["cap"] or r1 > old.codes["v"].shape[0]:
                return None
            codes = {"v": old.codes["v"].clone(),
                     "l": old.codes["l"].clone(), "cap": old.codes["cap"]}
            codes["v"][r0:r1] = self._to_dev(values)
            codes["l"][r0:r1] = self._to_dev(lengths.astype(np.int32))
        else:
            if n > old.codes.shape[0]:
                return None
            if new_codec.did != codec.did:
                self._res_counts["dict_extends"] += 1
            codes = old.codes.clone()
            codes[n_old:n] = self._to_dev(payload)
        h = self._coded_handle(arr, new_codec, codes)
        self.cache.put(key, version, h, self._res_nbytes(h))
        self.cache.note_extended(key)
        return h

    def cross_join_h(self, lpay, rpay, n_l: int, n_r: int):
        total = n_l * n_r
        if total == 0:
            return ([self._empty_h() for _ in lpay],
                    [self._empty_h() for _ in rpay], 0)
        memo = self._memoable(*lpay, *rpay)
        key = ("cross", tuple(p.uid for p in lpay),
               tuple(p.uid for p in rpay), n_l, n_r)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            idx = self._arange(self._bucket(total))
            li = idx // max(n_r, 1)
            ri = idx % max(n_r, 1)
            louts = [p.data[li.clamp(0, p.data.shape[0] - 1)] for p in lpay]
            routs = [p.data[ri.clamp(0, p.data.shape[0] - 1)] for p in rpay]
        lout = [DeviceCol(d, total, self, p.lo, p.hi, stable=memo)
                for d, p in zip(louts, lpay)]
        rout = [DeviceCol(d, total, self, p.lo, p.hi, stable=memo)
                for d, p in zip(routs, rpay)]
        out = (lout, rout, total)
        if memo:
            return self._memo_put(key, out, self._nbytes(*louts, *routs))
        return out

    def test_mask_h(self, a: DeviceCol, b: DeviceCol, op: str,
                    valtype: int) -> DeviceCol:
        if a.n == 0:
            e = np.zeros(0, bool)
            return DeviceCol(e, 0, self, host=e)
        memo = self._memoable(a, b)
        key = ("tm", a.uid, b.uid, op, int(valtype))
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        vt = int(valtype)
        with self._lock:
            buf = _CMP[op](_decode_lanes(a.data, vt),
                           _decode_lanes(self._fit_cap(b.data,
                                                       a.data.shape[0]), vt))
        h = DeviceCol(buf, a.n, self, stable=memo)
        if memo:
            return self._memo_put(key, h, buf.nbytes)
        return h

    def materialize(self, h: DeviceCol) -> np.ndarray:
        if isinstance(h.data, np.ndarray):
            return h.data[: h.n]
        with self._lock:
            return self._to_host(h.data[: h.n])

    def iota_h(self, n: int) -> DeviceCol:
        if n == 0:
            return self._empty_h()
        hit = self._memo_get(("iota", n))
        if hit is not None:
            return hit
        with self._lock:
            buf = self._arange(self._bucket(n))
        h = DeviceCol(buf, n, self, 0, n - 1,
                      host=np.arange(n, dtype=np.int64))
        return self._memo_put(("iota", n), h, buf.nbytes)

    def const_h(self, value: int, n: int) -> DeviceCol:
        if n == 0:
            return self._empty_h()
        value = int(value)
        hit = self._memo_get(("const", value, n))
        if hit is not None:
            return hit
        with self._lock:
            buf = torch.full((self._bucket(n),), value, dtype=torch.int64,
                             device=self.device)
        h = DeviceCol(buf, n, self, value, value,
                      host=np.full(n, value, np.int64))
        return self._memo_put(("const", value, n), h, buf.nbytes)

    def concat_h(self, parts) -> DeviceCol:
        parts = [self.as_handle(p) for p in parts]
        live = [p for p in parts if p.n] or parts[:1]
        if len(live) == 1:
            return live[0]
        memo = self._memoable(*live)
        key = ("cat",) + tuple(p.uid for p in live)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        total = sum(p.n for p in live)
        with self._lock:
            pieces = [p.data[: p.n] if not isinstance(p.data, np.ndarray)
                      else self._to_dev(p.data[: p.n]) for p in live]
            cap = self._bucket(total)
            if cap > total:
                pieces.append(torch.zeros(cap - total, dtype=torch.int64,
                                          device=self.device))
            buf = torch.cat(pieces)
        lo, hi = merge_bounds(*live)
        h = DeviceCol(buf, total, self, lo, hi, stable=memo)
        if memo:
            return self._memo_put(key, h, buf.nbytes)
        return h

    def gather_h(self, col: DeviceCol, idx: DeviceCol,
                 n: int | None = None) -> DeviceCol:
        n = idx.n if n is None else n
        if n == 0 or col.n == 0:
            return self._empty_h()
        memo = self._memoable(col, idx)
        key = ("g", col.uid, idx.uid, n)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            buf = col.data[idx.data.clamp(0, col.data.shape[0] - 1)]
        h = DeviceCol(buf, n, self, col.lo, col.hi, stable=memo)
        if memo:
            return self._memo_put(key, h, buf.nbytes)
        return h

    def select_mask_h(self, cols, mask: DeviceCol):
        n = cols[0].n
        if n == 0:
            return [self._empty_h() for _ in cols], 0
        memo = self._memoable(mask, *cols)
        key = ("sel", tuple(c.uid for c in cols), mask.uid)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            cap = mask.data.shape[0]
            datas = tuple(self._fit_cap(c.data, cap) for c in cols)
            outs, cnt = device_compact(datas, mask.data, n)
            kept = int(self._to_host(cnt))
        handles = [DeviceCol(d, kept, self, c.lo, c.hi, stable=memo)
                   for d, c in zip(outs, cols)]
        if memo:
            return self._memo_put(key, (handles, kept), self._nbytes(*outs))
        return handles, kept

    def semi_join_h(self, keys: DeviceCol, bound: DeviceCol) -> DeviceCol:
        if keys.n == 0:
            e = np.zeros(0, bool)
            return DeviceCol(e, 0, self, host=e)
        memo = self._memoable(keys, bound)
        key = ("sj", keys.uid, bound.uid)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            if bound.n == 0:
                buf = torch.zeros(keys.data.shape[0], dtype=torch.bool,
                                  device=self.device)
            else:
                buf = _semi_join_n(keys.data, bound.data, bound.n)
        h = DeviceCol(buf, keys.n, self, stable=memo)
        if memo:
            return self._memo_put(key, h, buf.nbytes)
        return h

    def pack_pairs_h(self, a: DeviceCol, b: DeviceCol) -> DeviceCol:
        if a.n == 0:
            return self._empty_h()
        memo = self._memoable(a, b)
        key = ("pp", a.uid, b.uid)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            buf = (a.data << 32) | (self._fit_cap(b.data, a.data.shape[0])
                                    & 0xFFFFFFFF)
        lo = hi = None
        if a.lo is not None and a.hi is not None:
            lo, hi = (a.lo << 32), (a.hi << 32) | 0xFFFFFFFF
        h = DeviceCol(buf, a.n, self, lo, hi, stable=memo)
        if memo:
            return self._memo_put(key, h, buf.nbytes)
        return h

    def join_gather_h(self, lkeys: DeviceCol, rkeys: DeviceCol,
                      lpay, rpay, verify=(), algo: str = "MJ"):
        if algo not in ("MJ", "HJ"):
            raise ValueError(f"unknown join algo: {algo!r}")
        verify = list(verify)
        if lkeys.n == 0 or rkeys.n == 0:
            return ([self._empty_h() for _ in lpay],
                    [self._empty_h() for _ in rpay], 0)
        memo = self._memoable(lkeys, rkeys, *lpay, *rpay,
                              *(a for a, _ in verify),
                              *(b for _, b in verify))
        key = ("jg", algo, lkeys.uid, rkeys.uid,
               tuple(p.uid for p in lpay), tuple(p.uid for p in rpay),
               tuple((a.uid, b.uid) for a, b in verify))
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        hash_keys = algo == "HJ"
        # code-domain join: when both key columns encode equal values to
        # equal codes (same join token: same-table self-joins share
        # dictionaries by content), join directly over the narrow code
        # buffers and decode neither side.  Two dict columns with
        # *different* dictionaries recode the smaller side on the device
        # through a rank-to-rank crossmap (absent values map to the
        # target's never-matching code).  Both are sound for HJ too:
        # splitmix of a code is a consistent hash domain and the exact
        # check compares codes, which is value equality under one encoding
        lt = codecs.join_token(lkeys.codec)
        rt = codecs.join_token(rkeys.codec)
        code_join = lt is not None and lt == rt
        cross_dict = (not code_join
                      and lkeys.codec is not None
                      and rkeys.codec is not None
                      and lkeys.codec.kind == "dict"
                      and rkeys.codec.kind == "dict")
        # a real left key equal to the right pad sentinel would match pad
        # lanes (MJ only; the hash domain is checked inside the program).
        # Codes cannot reach the sentinels (reserved headroom at both
        # dtype ends), so the guard applies to raw keys only
        bad = (not hash_keys and not code_join and not cross_dict
               and (lkeys.lo is None or lkeys.lo == INT64_MIN))
        if not bad:
            cap = self._bucket(max(lkeys.n, rkeys.n))
            with self._lock:
                if code_join:
                    lkb, rkb = lkeys.codes, rkeys.codes
                    self._res_counts["code_joins"] += 1
                elif cross_dict:
                    self._res_counts["cross_recodes"] += 1
                    if lkeys.n <= rkeys.n:
                        cmap = dict_crossmap(self._dict_dev(lkeys.codec),
                                             self._dict_dev(rkeys.codec),
                                             rkeys.codec.no_match_code)
                        lkb, rkb = map_codes(cmap, lkeys.codes), rkeys.codes
                    else:
                        cmap = dict_crossmap(self._dict_dev(rkeys.codec),
                                             self._dict_dev(lkeys.codec),
                                             lkeys.codec.no_match_code)
                        lkb, rkb = lkeys.codes, map_codes(cmap, rkeys.codes)
                else:
                    lkb, rkb = lkeys.data, rkeys.data
                cap_l = lkb.shape[0]
                cap_r = rkb.shape[0]
                lp = tuple(self._fit_cap(p.data, cap_l) for p in lpay)
                rp = tuple(self._fit_cap(p.data, cap_r) for p in rpay)
                vl = tuple(self._fit_cap(a.data, cap_l) for a, _ in verify)
                vr = tuple(self._fit_cap(b.data, cap_r) for _, b in verify)
                while True:
                    louts, routs, stats = merge_join_gather_bounded(
                        lkb, rkb, lkeys.n, rkeys.n, lp, rp,
                        vl, vr, out_cap=cap, hash_keys=hash_keys)
                    st = self._to_host(stats)
                    total, total0, bad = int(st[0]), int(st[1]), bool(st[2])
                    if bad or total0 <= cap:
                        break
                    cap = self._bucket(total0)  # one retry: exact total
        if bad:
            out = self._join_gather_host(lkeys, rkeys, lpay, rpay,
                                         verify, algo)
            for h in out[0] + out[1]:
                h.stable = memo
            if memo:
                return self._memo_put(
                    key, out, self._nbytes(*(h.data for h in out[0]
                                             + out[1])))
            return out
        lout = [DeviceCol(d, total, self, p.lo, p.hi, stable=memo)
                for d, p in zip(louts, lpay)]
        rout = [DeviceCol(d, total, self, p.lo, p.hi, stable=memo)
                for d, p in zip(routs, rpay)]
        if memo:
            return self._memo_put(key, (lout, rout, total),
                                  self._nbytes(*louts, *routs))
        return lout, rout, total

    def _join_gather_host(self, lkeys, rkeys, lpay, rpay, verify, algo):
        """Exact host path for sentinel-adversarial keys (downloads and
        re-uploads — counted; correctness guard, not a fast path)."""
        kernels.FALLBACKS["join_host_redo"] += 1
        li, ri = self._host.join(lkeys.host(), rkeys.host(), algo)
        for vl, vr in verify:
            if len(li) == 0:
                break
            ok = vl.host()[li] == vr.host()[ri]
            li, ri = li[ok], ri[ok]
        lout = [self.upload(p.host()[li]) for p in lpay]
        rout = [self.upload(p.host()[ri]) for p in rpay]
        return lout, rout, len(li)

    def dedup_select_h(self, cols):
        n = cols[0].n
        if n == 0:
            return self._empty_h(), 0
        memo = self._memoable(*cols)
        key = ("dd", tuple(c.uid for c in cols))
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        with self._lock:
            cap = cols[0].data.shape[0]
            datas = tuple(self._fit_cap(c.data, cap) for c in cols)
            tagged = (all(c.bounds_known() for c in cols) and
                      all(fits_tagged_width(c.lo, c.hi, cap) for c in cols))
            if tagged:
                # both paths ignore pad *content* (tagging rewrites pad
                # lanes by position; the fallback is pad-flag based), so
                # no sentinel-collision host fallback exists here
                rows, cnt = device_dedup_rows(datas, n, [c.lo for c in cols],
                                              tag_bits=tag_bits_for(cap))
            else:
                rows, cnt = dedup_rows_fallback(datas, n)
            kept = int(self._to_host(cnt))
        h = DeviceCol(rows, kept, self, 0 if kept else None,
                      (n - 1) if kept else None, stable=memo)
        if memo:
            return self._memo_put(key, (h, kept), rows.nbytes)
        return h, kept

    def fresh_mask_h(self, key_new: DeviceCol, vals_new: DeviceCol,
                     old_keys, old_vals, cache_uid=None,
                     version: int | None = None) -> DeviceCol:
        n_new = key_new.n
        if n_new == 0:
            e = np.zeros(0, bool)
            return DeviceCol(e, 0, self, host=e)
        use_cache = cache_uid is not None and version is not None
        # the table-side sorted pairs stay resident either way; only the
        # output mask memo needs stable batch operands
        memo = use_cache and self._memoable(key_new, vals_new)
        key = ("fm", key_new.uid, vals_new.uid, cache_uid, version)
        if memo:
            hit = self._memo_get(key)
            if hit is not None:
                return hit
        old_keys = np.asarray(old_keys, np.int64)
        old_vals = np.asarray(old_vals, np.int64)
        with self._lock:
            if len(old_keys) == 0:
                buf = torch.ones(key_new.data.shape[0], dtype=torch.bool,
                                 device=self.device)
            else:
                pkv = (self.cache.get(("pkv", cache_uid), version)
                       if use_cache else None)
                if pkv is None:
                    if use_cache:
                        # encode=False governs a *cold build* only: the
                        # probe side arrives raw, so a fresh upload stays
                        # raw too.  But the ("pk", uid) entry is shared
                        # with ``join_pairs`` (engine dedup / retraction
                        # joins), which dict-codes it under compression:
                        # a hit or an append-extend of it comes back
                        # *coded*, so decode to raw on the device first
                        kb = self._resident_column(
                            ("pk", cache_uid), version, old_keys,
                            INT64_MIN, encode=False)
                        vb = self._resident_column(
                            ("vals", cache_uid), version, old_vals, 0,
                            encode=False)
                        kraw = self._raw_colbuf(kb, old_keys, INT64_MIN)
                        vraw = self._raw_colbuf(vb, old_vals, 0)
                        cap_o = max(kraw.shape[0], vraw.shape[0])
                        kbuf = self._fit_cap(kraw, cap_o)
                        vbuf = self._fit_cap(vraw, cap_o)
                    else:
                        cap_o = self._bucket(len(old_keys))
                        kbuf = self._to_dev(
                            self._pad(old_keys, cap_o, INT64_MIN))
                        vbuf = self._to_dev(self._pad(old_vals, cap_o, 0))
                    ks, vs = _sort_pairs(kbuf, vbuf, len(old_keys))
                    pkv = {"ks": ks, "vs": vs, "n": len(old_keys)}
                    if use_cache:
                        self.cache.put(("pkv", cache_uid), version, pkv,
                                       ks.nbytes + vs.nbytes)
                buf = _fresh_pairs(
                    pkv["ks"], pkv["vs"], pkv["n"], key_new.data,
                    self._fit_cap(vals_new.data, key_new.data.shape[0]))
        h = DeviceCol(buf, n_new, self, stable=memo)
        if memo:
            self._memo_put(key, h, buf.nbytes)
        return h

    def batch_probe(self, sorted_keys, probes, *, cache_key=None,
                    version: int | None = None):
        probes = np.asarray(probes, np.int64)
        n = len(probes)
        m = len(sorted_keys)
        if n == 0 or m == 0:
            return np.zeros(n, np.int64), np.zeros(n, np.int64)
        use_cache = cache_key is not None and version is not None
        with self._lock:
            ent = (self.cache.get(("permdev", cache_key), version)
                   if use_cache else None)
            if ent is None:
                sk = np.asarray(sorted_keys, np.int64)
                buf = self._to_dev(self._pad(sk, self._bucket(m), INT64_MAX))
                n_real = m
                if use_cache:
                    self.cache.put(("permdev", cache_key), version,
                                   {"sk": buf, "n": m, "codec": None},
                                   buf.nbytes)
            else:
                buf, n_real = ent["sk"], ent["n"]
                if ent["codec"] is not None:
                    # the resident mirror holds narrow codes: encode the
                    # probes into the same domain (absent values map to
                    # ``no_match_code``, whose [lo, hi) is empty, as on
                    # the raw path; only its ``lo`` differs, and callers
                    # read ``lo`` only under a non-empty run) and widen
                    # the mirror for the kernel
                    probes = codecs.encode_probes(ent["codec"], probes)
                    buf = widen(buf)
            pd = self._to_dev(self._pad(probes, self._bucket(n), INT64_MAX))
            lo, hi = probe_sorted(pd, buf)
            res = self._to_host(torch.stack([lo.to(torch.int64),
                                             hi.to(torch.int64)])
                                .clamp(max=n_real))
        return res[0, :n].copy(), res[1, :n].copy()

    def residency_stats(self) -> dict:
        """Footprint of the compressed resident tier: actual (coded)
        bytes vs what the same resident columns would occupy as raw
        int64 buffers, plus the codec event counters.  Transient buffers
        (probe uploads, join outputs) and derived mirrors are out of
        scope: the ratio measures the *storage* tier the codecs
        replace."""
        out = {"resident_bytes_raw": 0, "resident_bytes_coded": 0,
               "columns_raw": 0, "columns_coded": 0,
               "codecs": dict(self._res_counts),
               "compress": self.compress}
        with self.cache._lock:
            entries = [(k, e.value) for k, e in self.cache._entries.items()]
        for key, v in entries:
            fam = key[0] if isinstance(key, tuple) else None
            if fam == "colbuf" and isinstance(v, dict) and "buf" in v:
                coded = self._colbuf_nbytes(v)
                raw = v["buf"].shape[0] * 8
                out["columns_raw" if v["codec"] is None
                    else "columns_coded"] += 1
            elif fam == "rescol" and isinstance(v, DeviceCol):
                coded = self._res_nbytes(v)
                if v.codec is None:
                    raw = coded
                    out["columns_raw"] += 1
                else:
                    cap = (v.codes["cap"] if v.codec.kind == "rle"
                           else v.codes.shape[0])
                    raw = cap * 8
                    out["columns_coded"] += 1
            else:
                continue
            out["resident_bytes_raw"] += raw
            out["resident_bytes_coded"] += coded
        return out

    def sketch(self, col, *, cache_key=None, version: int | None = None):
        """Device cardinality sketch (see ``Ops.sketch``).  The sketch is
        tiny (~1KB) and cached per ``(uid, data_version)``; a miss prefers
        the *resident coded column* of the index build over a fresh
        upload — decode on the device, histogram, three small downloads.
        RLE columns and misses without a resident buffer upload the host
        column transiently.  The column's sort runs through the port's
        ``device_sort`` and its distinct count through the
        ``unique_mask_sorted`` kernel, so ``sort_mode="sketch"`` runs that
        kernel on the engine's path (``sketch_hist``)."""
        col = np.asarray(col, np.int64)
        n = len(col)
        use_cache = cache_key is not None and version is not None
        if n == 0:
            return super().sketch(col)
        with self._lock:
            if use_cache:
                hit = self.cache.get(("sketch", cache_key), version)
                if hit is not None:
                    return hit
            buf = None
            if use_cache:
                ent = self.cache.get_any(
                    ("colbuf", (cache_key[0], cache_key[1], ""), INT64_MAX))
                cv = ent.value if ent is not None else None
                if isinstance(cv, dict) and cv.get("n") == n and "buf" in cv:
                    codec = cv["codec"]
                    if codec is None:
                        buf = cv["buf"]  # raw, pads already int64 max
                    elif codec.kind == "for":
                        buf = decode_for_n(cv["buf"], codec.ref, n,
                                           INT64_MAX)
                    elif codec.kind == "dict" and cv["dvals"] is not None:
                        buf = decode_dict_n(cv["buf"], cv["dvals"], n)
                        self._res_counts["decode_calls"] += 1
            if buf is None:
                buf = self._to_dev(self._pad(col, self._bucket(n), INT64_MAX))
            hist, dhist, distinct = sketch_hist(buf, n, SKETCH_BUCKETS)
            out = {"n": n, "distinct": int(self._to_host(distinct)),
                   "hist": self._to_host(hist).astype(np.int64),
                   "dhist": self._to_host(dhist).astype(np.int64)}
            if use_cache:
                self.cache.put(("sketch", cache_key), version, out,
                               out["hist"].nbytes + out["dhist"].nbytes)
        return out
