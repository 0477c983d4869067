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

Not ported yet, and raising ``NotImplementedError`` rather than running
on the host: compressed resident columns (``compress=True``, ROADMAP A6),
``unique_mask`` (B5) and ``sketch`` (A7).

All device work runs behind a lock, because the engine's PF/PW thread
pools may issue primitives concurrently.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.backend.base import Ops
from repro_torch.backend.device_cache import (DeviceArrayCache,
                                              MirrorRuns, SortWorkCounter,
                                              TransferCounter)
from repro_torch.backend.handles import DeviceCol, merge_bounds
from repro_torch.backend.numpy_ops import NumpyOps
from repro_torch.kernels.mergejoin.mergejoin import probe_sorted
from repro_torch.kernels.mergejoin.ops import (device_compact,
                                               merge_join_bounded,
                                               merge_join_gather_bounded,
                                               pack_pairs_bounded)
from repro_torch.kernels.sortmerge.ops import (device_dedup_rows,
                                               device_merge_runs,
                                               device_sort,
                                               device_stable_sort_perm,
                                               fits_tagged_width,
                                               merge_sorted_mirror_impl,
                                               tag_bits_for,
                                               tagged_from_sorted)

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


class TorchOps(Ops):
    """Bounded-shape, device-resident implementation of ``Ops`` on torch
    tensors (see the module docstring)."""

    prefer_handles = True
    MIRROR_COMPACT_RUNS = 64

    def __init__(self, device: str = "cuda", block: int = 1024,
                 cache_bytes: int | None = None,
                 compress: bool | None = None) -> None:
        if compress:
            raise NotImplementedError(
                "compressed resident columns are not ported yet "
                "(ROADMAP A6)")
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
        self.compress = False

    # -- plumbing ---------------------------------------------------------
    def _bucket(self, n: int) -> int:
        return max(self.block, 1 << (max(n, 1) - 1).bit_length())

    @staticmethod
    def _delta_bucket(n: int) -> int:
        """Small power-of-two bucket for small columns (h2d bytes scale
        with the column, not with the block)."""
        return max(32, 1 << (max(n, 1) - 1).bit_length())

    @staticmethod
    def _pad(a: np.ndarray, cap: int, fill: int) -> np.ndarray:
        out = np.full(cap, fill, np.int64)
        out[: len(a)] = a
        return out

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

    def _resident_column(self, cache_key, version: int, col: np.ndarray,
                         fill: int) -> dict:
        """Device buffer of an append-only int64 column (a table's index
        column, packed keys or values), padded with ``fill``: ``{"buf",
        "n", "kmin", "kmax"}``.  A hit at ``version`` costs nothing; an
        entry cached at an older version whose length is a prefix of
        ``col`` is *extended* — only the appended tail goes up — while the
        capacity holds; anything else uploads the column whole.  Caller
        holds the lock."""
        key = ("colbuf", cache_key, fill)
        n = len(col)
        hit = self.cache.get(key, version)
        if hit is not None and hit["n"] == n:
            return hit
        e = self.cache.get_any(key)
        if (e is not None and e.version < version and e.value["n"] < n
                and n <= e.value["buf"].shape[0]):
            old = e.value
            tail = col[old["n"]:]
            buf = old["buf"].clone()  # older-version readers keep theirs
            buf[old["n"]:n] = self._to_dev(tail)
            value = {"buf": buf, "n": n,
                     "kmin": min(old["kmin"], int(tail.min())),
                     "kmax": max(old["kmax"], int(tail.max()))}
            self.cache.put(key, version, value, buf.nbytes)
            self.cache.note_extended(key)
            return value
        buf = self._to_dev(self._pad(col, self._bucket(n), fill))
        value = {"buf": buf, "n": n, "kmin": int(col.min()),
                 "kmax": int(col.max())}
        self.cache.put(key, version, value, buf.nbytes)
        return value

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
                            alive):
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
        after it — stops carrying dead rows.  Caller holds the lock."""
        cap = buf.shape[0]
        tb = tag_bits_for(cap)
        fits = fits_tagged_width(kmin, kmax, cap)
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
                    n_dead=runs.n_dead, src_n=n), merged.nbytes)
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
                    merges=0, n_dead=n_dead, src_n=n), tagged.nbytes)
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
                merges=0, n_dead=0, src_n=n), tagged.nbytes)
        else:
            # width overflow: the fallback's output has no tagged form to
            # merge into — appends keep re-sorting
            self.cache.invalidate(key)
        return sk, perm, n

    def sort_perm(self, keys: np.ndarray, *, cache_key=None,
                  version: int | None = None, n_dead: int = 0,
                  alive=None) -> tuple[np.ndarray, np.ndarray]:
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
                                             INT64_MAX)
                sk, perm, n_real = self._mirror_sort_device(
                    cache_key, version, colv["buf"], n, colv["kmin"],
                    colv["kmax"], int(n_dead), keys64, alive)
                if sk is None:  # fully tombstoned: empty mirror
                    out = (np.empty(0, np.int64), np.empty(0, np.int64))
                    self.cache.invalidate(("permdev", cache_key))
                    self.cache.put(("perm", cache_key), version, out, 0)
                    return out
                # the device-side sorted mirror stays resident: batched
                # rank-1 probes (``batch_probe``) search it without
                # re-uploading the sorted column
                self.cache.put(("permdev", cache_key), version,
                               {"sk": sk, "n": n_real}, sk.nbytes)
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
                rp = self._resident_column(rkeys_key, rkeys_version, rkeys,
                                           INT64_MIN)["buf"]
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

    def unique_mask(self, sorted_keys: np.ndarray) -> np.ndarray:
        raise NotImplementedError(
            "unique_mask_sorted is not ported yet (ROADMAP B5)")

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
            kp = self._to_dev(keys)
            bp = self._to_dev(bound)
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
                prefix_ok = old.bounds_known() and (
                    assume_prefix or (
                        old._host is not None and
                        np.array_equal(arr[:n_old], old._host[:n_old])))
                if prefix_ok and n <= old.data.shape[0]:
                    delta = arr[n_old:]
                    buf = old.data.clone()  # the old handle stays valid
                    buf[n_old:n] = self._to_dev(delta)
                    h = DeviceCol(buf, n, self, min(int(delta.min()), old.lo),
                                  max(int(delta.max()), old.hi), host=arr)
                    self.cache.put(key, version, h, buf.nbytes)
                    self.cache.note_extended(key)
                    return h
            h = self._upload_locked(arr)
        self.cache.put(key, version, h, h.data.nbytes)
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
        # a real left key equal to the right pad sentinel would match pad
        # lanes (MJ only; the hash domain is checked inside the program)
        bad = not hash_keys and (lkeys.lo is None or lkeys.lo == INT64_MIN)
        if not bad:
            cap = self._bucket(max(lkeys.n, rkeys.n))
            with self._lock:
                cap_l = lkeys.data.shape[0]
                cap_r = rkeys.data.shape[0]
                lp = tuple(self._fit_cap(p.data, cap_l) for p in lpay)
                rp = tuple(self._fit_cap(p.data, cap_r) for p in rpay)
                vl = tuple(self._fit_cap(a.data, cap_l) for a, _ in verify)
                vr = tuple(self._fit_cap(b.data, cap_r) for _, b in verify)
                while True:
                    louts, routs, stats = merge_join_gather_bounded(
                        lkeys.data, rkeys.data, lkeys.n, rkeys.n, lp, rp,
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
                        # the ("pk", uid) column is shared with
                        # ``join_pairs`` (engine dedup / retraction joins)
                        kbuf = self._resident_column(
                            ("pk", cache_uid), version, old_keys,
                            INT64_MIN)["buf"]
                        vbuf = self._resident_column(
                            ("vals", cache_uid), version, old_vals,
                            0)["buf"]
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
                                   {"sk": buf, "n": m}, buf.nbytes)
            else:
                buf, n_real = ent["sk"], ent["n"]
            pd = self._to_dev(self._pad(probes, self._bucket(n), INT64_MAX))
            lo, hi = probe_sorted(pd, buf)
            res = self._to_host(torch.stack([lo.to(torch.int64),
                                             hi.to(torch.int64)])
                                .clamp(max=n_real))
        return res[0, :n].copy(), res[1, :n].copy()

    def sketch(self, col, *, cache_key=None, version: int | None = None):
        raise NotImplementedError(
            "the device cardinality sketch belongs to the demand slice "
            "(ROADMAP A7)")
