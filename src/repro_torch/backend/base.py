"""Execution-backend interface: the bulk primitives of the inference hot path.

The paper's thesis (§2.3-§2.4) is that Rete-class inference is won or lost
on a handful of bulk primitives — fork-join sort, sorted probe/merge join,
and the SU unique filter.  ``Ops`` names exactly those primitives so the
engine can dispatch them to interchangeable implementations:

* ``NumpyOps`` — the host twins (the original ``core/joins.py`` code).
* ``TorchOps``   — the device path built on the ``kernels/`` CUDA kernels
  (power-of-two buckets; plain PyTorch versions serve CPU tensors).

Everything speaks numpy arrays at the boundary; backends own any padding,
device transfer, and jit-cache management internally.  Derived algorithms
that are pure composition (hash join = mix hash + merge join + verify) live
here once and are shared by all backends.
"""

from __future__ import annotations

import abc

import numpy as np

from repro_torch.backend.handles import DeviceCol, is_handle, merge_bounds


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit mix hash (HI bucketing and HJ joins)."""
    z = x.astype(np.uint64, copy=True)
    z += np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


# Cardinality-sketch histogram width: the planner's estimates bucket
# values by splitmix64(v) % SKETCH_BUCKETS, so one sketch is two small
# int64 vectors (~1KB) regardless of column size.
SKETCH_BUCKETS = 64


def sketch_bucket(v: int) -> int:
    """Host-side bucket of a single value (planner point estimates)."""
    return int(splitmix64(np.asarray([v], np.int64))[0]
               % np.uint64(SKETCH_BUCKETS))


class Ops(abc.ABC):
    """The bulk primitives of the inference/query hot path.

    Three tiers (each documented in backend/README.md and
    docs/ARCHITECTURE.md):

    * **array primitives** — the abstract methods below plus derived
      composites (``sort_perm``, ``hash_join_pairs``, ``merge_runs``):
      numpy in, numpy out; backends own padding, transfer, and jit
      caches internally.
    * **residency hints** — optional ``cache_key``/``version`` (and
      ``n_dead``) keywords on ``sort_perm``/``join_pairs``/
      ``batch_probe``/``upload_resident``/``fresh_mask_h`` identify an
      argument as the version-stamped state of an append-only column so
      device backends can keep it (and anything derived from it)
      resident, re-uploading only appended tails and maintaining sorted
      index mirrors by delta-run *merge* instead of full re-sort.  Host
      backends ignore every hint.
    * **handle tier** — ``*_h`` methods consume and produce opaque
      ``DeviceCol`` handles so intermediate join state never round-trips
      through the host (see handles.py); the defaults below are the
      numpy host twins, which makes ``NumpyOps`` the parity oracle.
    """

    name: str = "?"

    # -- primitives -------------------------------------------------------
    @abc.abstractmethod
    def sort_kv(self, keys: np.ndarray, vals: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        """Sort ``keys`` ascending, carrying ``vals`` (fork-join instance 4:
        the id+object sort used by every rank-1 index build)."""

    @abc.abstractmethod
    def join_pairs(self, lkeys: np.ndarray, rkeys: np.ndarray, *,
                   rkeys_key=None, rkeys_version: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Sort-merge equi-join: all (li, ri) with lkeys[li] == rkeys[ri].
        Pair order is unspecified; the pair *set* is exact.

        ``rkeys_key``/``rkeys_version`` optionally identify ``rkeys`` as a
        version-stamped append-only column (e.g. a fact table's packed
        (id, attr) keys): device backends keep it resident and upload only
        the appended tail when the version advances.  Host backends
        ignore the hint."""

    @abc.abstractmethod
    def unique_mask(self, sorted_keys: np.ndarray) -> np.ndarray:
        """First-of-run boolean mask over an already-sorted array (the SU
        neighbor-compare)."""

    @abc.abstractmethod
    def semi_join(self, keys: np.ndarray, bound_values: np.ndarray
                  ) -> np.ndarray:
        """Mask of ``keys`` that appear in ``bound_values`` (AR-mode RNL
        restriction).  Empty ``bound_values`` -> all-False."""

    @abc.abstractmethod
    def dedup_rows(self, cols: list[np.ndarray]) -> np.ndarray:
        """SU unique filter: ascending indices selecting one representative
        of each distinct row of ``zip(*cols)``."""

    #: whether the backend stores resident columns as compressed codes
    #: (device backends may flip this on; the host twin is always raw)
    compress = False

    # -- shared derived algorithms ---------------------------------------
    def sort_perm(self, keys: np.ndarray, *, cache_key=None,
                  version: int | None = None, n_dead: int = 0,
                  alive=None) -> tuple[np.ndarray, np.ndarray]:
        """(sorted keys, permutation) — the index-build form of the KV
        sort, **stable** (equal keys keep input order) on every backend.
        Default: carry an arange payload through ``sort_kv``; backends may
        override with a cheaper native path.

        ``cache_key``/``version`` optionally identify ``keys`` as a
        version-stamped append-only column (a rank-1 index build): device
        backends keep the column and its (sorted, perm) mirrors resident,
        return cached results at an unchanged version without any
        transfer, and when the version advanced append-only they
        *merge-maintain* the mirror — sort only the appended tail and
        merge it into the resident sorted run (O(Δ log Δ) instead of
        O(N log N); see ``merge_runs``).  ``n_dead`` is the owning
        table's tombstone count: any movement since the resident run's
        baseline forces a full rebuild instead of a merge.

        ``alive`` (bool mask over the owning table's rows, or ``None``)
        enables **tombstone compaction**: when given with ``n_dead >
        0``, full sorts and rebuilds drop the dead rows — the returned
        mirror covers only alive rows (perm values stay *original* row
        ids, relative order preserved), so downstream consumers see the
        same row sets they would after their own alive-filtering, and
        dead rows stop paying sort cost.  Backends without mirror state
        apply the filter directly."""
        keys = np.asarray(keys)
        if alive is not None and n_dead:
            rows = np.flatnonzero(np.asarray(alive[:len(keys)], bool))
            sk, perm = self.sort_kv(
                keys[rows].astype(np.int64, copy=False),
                rows.astype(np.int64))
            return sk, perm
        return self.sort_kv(keys.astype(np.int64, copy=False),
                            np.arange(len(keys), dtype=np.int64))

    def merge_runs(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Merge two individually sorted key arrays into one sorted
        array.  Equal keys keep the ``a``-run elements first; with
        distinct tagged codes (key ``<<`` tag_bits ``|`` lane) that tie
        discipline is exactly what makes the merge of two stable runs
        bit-match the full stable sort.  The mirror-maintenance
        composite (``merge_sorted_mirror_impl``) shares the same
        rank+scatter core on device; this standalone form is its
        host-checkable surface — the host twin here is the parity
        oracle for ``kernels/sortmerge/ops.device_merge_runs``."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if len(a) == 0 or len(b) == 0:
            return (b if len(a) == 0 else a).copy()
        out = np.empty(len(a) + len(b), np.int64)
        out[np.arange(len(a)) + np.searchsorted(b, a, side="left")] = a
        out[np.arange(len(b)) + np.searchsorted(a, b, side="right")] = b
        return out

    def hash_join_pairs(self, lkeys: np.ndarray, rkeys: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Radix-hash join: bucketize by a 64-bit mix, probe the hashed
        domain with the merge join, verify exact equality on candidates."""
        lkeys = np.asarray(lkeys, np.int64)
        rkeys = np.asarray(rkeys, np.int64)
        if len(lkeys) == 0 or len(rkeys) == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        lh = splitmix64(lkeys.view(np.uint64)).view(np.int64)
        rh = splitmix64(rkeys.view(np.uint64)).view(np.int64)
        li, ri = self.join_pairs(lh, rh)
        if len(li) == 0:
            return li, ri
        ok = lkeys[li] == rkeys[ri]
        return li[ok], ri[ok]

    def join(self, lkeys: np.ndarray, rkeys: np.ndarray, algo: str = "MJ"
             ) -> tuple[np.ndarray, np.ndarray]:
        """Dispatch on the paper's join axis: MJ (sort-merge) | HJ (hash)."""
        if algo == "HJ":
            return self.hash_join_pairs(lkeys, rkeys)
        if algo == "MJ":
            return self.join_pairs(lkeys, rkeys)
        raise ValueError(f"unknown join algo: {algo!r}")

    # -- handle tier -------------------------------------------------------
    # Variants that accept and return opaque ``DeviceCol`` handles so
    # intermediate join state never round-trips through the host (see
    # handles.py).  The defaults below are the numpy host twins — handles
    # wrap plain arrays and ``host()`` is free — which makes ``NumpyOps``
    # the oracle for the device tier's parity tests.  ``TorchOps`` overrides
    # every method with a device-resident, uid-memoized implementation.
    #
    # ``prefer_handles`` tells the island executor whether routing the
    # whole join pipeline through handles is a *win* on this backend (it
    # is on device backends, a wash on host ones); the API itself is
    # available on every backend.

    prefer_handles = False

    def upload(self, arr: np.ndarray) -> DeviceCol:
        """Wrap a host column as a handle (device backends transfer)."""
        arr = np.ascontiguousarray(np.asarray(arr, np.int64))
        lo = int(arr.min()) if len(arr) else None
        hi = int(arr.max()) if len(arr) else None
        return DeviceCol(arr, len(arr), self, lo, hi, host=arr)

    def upload_resident(self, cache_key, version: int, arr: np.ndarray,
                        assume_prefix: bool = False,
                        transient: bool = False) -> DeviceCol:
        """Upload a column identified as the ``version``-stamped state of
        an append-frontier source (a condition's binding column over an
        append-only table): device backends keep the buffer resident and,
        when the cached entry is a *prefix* of ``arr``, upload only the
        appended tail (``assume_prefix`` skips the host prefix check when
        the caller knows rows extend append-only, e.g. a full scan of a
        tombstone-free table).  ``transient`` marks one-shot state (a
        delta window at a never-recurring watermark): device backends
        upload without caching and mark the handle unstable so derived
        results skip memoization.  Host backends ignore the hints."""
        return self.upload(arr)

    def materialize(self, h: DeviceCol) -> np.ndarray:
        """Host array for ``h`` (device backends download, once)."""
        return np.asarray(h.data[: h.n])

    def as_handle(self, x) -> DeviceCol:
        return x if is_handle(x) else self.upload(x)

    def iota_h(self, n: int) -> DeviceCol:
        """`arange(n)` as a handle, built without a host->device copy."""
        a = np.arange(n, dtype=np.int64)
        return DeviceCol(a, n, self, 0 if n else None,
                         n - 1 if n else None, host=a)

    def const_h(self, value: int, n: int) -> DeviceCol:
        """A constant column as a handle.  Device backends memoize by
        ``(value, n)`` so the constant action slots of a rule map to the
        same handle (and thus the same memoized write-side results) on
        every evaluation at a fixed version."""
        a = np.full(n, int(value), np.int64)
        v = int(value) if n else None
        return DeviceCol(a, n, self, v, v, host=a)

    def concat_h(self, parts: list[DeviceCol]) -> DeviceCol:
        parts = [self.as_handle(p) for p in parts]
        if len(parts) == 1:
            return parts[0]
        out = np.concatenate([p.host() for p in parts])
        lo, hi = merge_bounds(*parts)
        return DeviceCol(out, len(out), self, lo, hi, host=out)

    def gather_h(self, col: DeviceCol, idx: DeviceCol,
                 n: int | None = None) -> DeviceCol:
        """``col[idx[:n]]`` — bounds are inherited (a subset can only
        shrink the value range)."""
        n = idx.n if n is None else n
        out = col.host()[idx.host()[:n]]
        return DeviceCol(out, n, self, col.lo, col.hi, host=out)

    def select_mask_h(self, cols: list[DeviceCol], mask: DeviceCol
                      ) -> tuple[list[DeviceCol], int]:
        """Compact each column to the lanes where ``mask`` is True (the
        handle-tier form of boolean selection)."""
        m = mask.host()[: cols[0].n] if cols else mask.host()
        kept = int(m.sum())
        out = []
        for c in cols:
            d = c.host()[m]
            out.append(DeviceCol(d, kept, self, c.lo, c.hi, host=d))
        return out, kept

    def semi_join_h(self, keys: DeviceCol, bound: DeviceCol) -> DeviceCol:
        """Boolean-mask handle of ``keys`` lanes appearing in ``bound``."""
        m = self.semi_join(keys.host(), bound.host())
        return DeviceCol(m, keys.n, self, host=m)

    def pack_pairs_h(self, a: DeviceCol, b: DeviceCol) -> DeviceCol:
        """Packed ``(a << 32) | (b & 0xFFFFFFFF)`` join keys (the engine's
        (id, attr) key form)."""
        out = (a.host().astype(np.int64) << 32) | (
            b.host().astype(np.int64) & 0xFFFFFFFF)
        lo = hi = None
        if a.n and a.lo is not None and a.hi is not None:
            lo, hi = (a.lo << 32), (a.hi << 32) | 0xFFFFFFFF
        return DeviceCol(out, a.n, self, lo, hi, host=out)

    def join_gather_h(self, lkeys: DeviceCol, rkeys: DeviceCol,
                      lpay: list[DeviceCol], rpay: list[DeviceCol],
                      verify: list[tuple[DeviceCol, DeviceCol]] = (),
                      algo: str = "MJ"
                      ) -> tuple[list[DeviceCol], list[DeviceCol], int]:
        """Fused equi-join + payload gather: joins ``lkeys``/``rkeys``,
        refines candidate pairs on the ``verify`` column pairs, and emits
        the gathered payload columns directly — the ``(li, ri)`` pair
        arrays are never exposed (device backends never materialize them
        on host)."""
        li, ri = self.join(lkeys.host(), rkeys.host(), algo)
        for vl, vr in verify:
            if len(li) == 0:
                break
            ok = vl.host()[li] == vr.host()[ri]
            li, ri = li[ok], ri[ok]
        n = len(li)
        lout = [DeviceCol(p.host()[li], n, self, p.lo, p.hi)
                for p in lpay]
        rout = [DeviceCol(p.host()[ri], n, self, p.lo, p.hi)
                for p in rpay]
        return lout, rout, n

    def cross_join_h(self, lpay: list[DeviceCol], rpay: list[DeviceCol],
                     n_l: int, n_r: int
                     ) -> tuple[list[DeviceCol], list[DeviceCol], int]:
        """Cross product of two binding tables (no shared variable — the
        island planner only emits this when the rule truly is a cross
        product, typically refined by a join test right after): left
        payloads repeat, right payloads tile.  Device backends expand on
        device so test-bearing cross products stay resident."""
        total = n_l * n_r
        li = np.repeat(np.arange(n_l, dtype=np.int64), n_r)
        ri = np.tile(np.arange(n_r, dtype=np.int64), n_l)
        lout = [DeviceCol(p.host()[li], total, self, p.lo, p.hi)
                for p in lpay]
        rout = [DeviceCol(p.host()[ri], total, self, p.lo, p.hi)
                for p in rpay]
        return lout, rout, total

    def test_mask_h(self, a: DeviceCol, b: DeviceCol, op: str,
                    valtype: int) -> DeviceCol:
        """Join-test comparison mask (Def. 9) over handle columns: the
        lanes are decoded to their value domain (float bit-puns,
        uint64 views) before the ordered compare.  ``b`` may be a
        constant column (the var⊕const form).  Device backends evaluate
        the compare in one jit program so test-bearing rules stay
        resident."""
        from repro_torch.core.facts import ValueType, decode_lane_array
        from repro_torch.core.conditions import _TEST_OPS
        vt = ValueType(valtype)
        m = _TEST_OPS[op](decode_lane_array(a.host(), vt),
                          decode_lane_array(b.host()[: a.n], vt))
        return DeviceCol(m, a.n, self, host=m)

    def dedup_select_h(self, cols: list[DeviceCol]
                       ) -> tuple[DeviceCol, int]:
        """SU unique filter over handle columns -> (ascending kept row
        ids as a handle, kept count)."""
        idx = self.dedup_rows([c.host() for c in cols])
        n = len(idx)
        return DeviceCol(idx, n, self, 0 if n else None,
                         (cols[0].n - 1) if n else None, host=idx), n

    def fresh_mask_h(self, key_new: DeviceCol, vals_new: DeviceCol,
                     old_keys: np.ndarray, old_vals: np.ndarray,
                     cache_uid=None, version: int | None = None
                     ) -> DeviceCol:
        """Write-side anti-join: mask of batch rows whose ``(key, val)``
        pair does NOT already exist in the table columns.  ``cache_uid``/
        ``version`` identify the (append-only) table columns for device
        residency; host backends ignore the hint.  Callers are
        responsible for tombstone handling (the engine falls back to the
        host path when the table has dead rows)."""
        kn = key_new.host()
        vn = vals_new.host()
        exists = np.zeros(key_new.n, bool)
        if len(old_keys) and key_new.n:
            li, ri = self.join_pairs(kn, old_keys)
            if len(li):
                ok = vn[li] == old_vals[ri]
                exists[li[ok]] = True
        fresh = ~exists
        return DeviceCol(fresh, key_new.n, self, host=fresh)

    def batch_probe(self, sorted_keys: np.ndarray, probes: np.ndarray, *,
                    cache_key=None, version: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched rank-1 probe: ``[lo, hi)`` run bounds in
        ``sorted_keys`` for every probe key, in one bulk call.  Device
        backends resolve all probes in a single kernel launch against the
        resident ``(sorted, perm)`` mirror identified by ``cache_key``/
        ``version`` instead of per-probe host bisection."""
        sorted_keys = np.asarray(sorted_keys)
        probes = np.asarray(probes)
        lo = np.searchsorted(sorted_keys, probes, side="left")
        hi = np.searchsorted(sorted_keys, probes, side="right")
        return lo.astype(np.int64), hi.astype(np.int64)

    def sketch(self, col: np.ndarray, *, cache_key=None,
               version: int | None = None) -> dict:
        """Cardinality sketch of one join-key column: distinct count
        plus two ``SKETCH_BUCKETS``-wide histograms (``hist`` counts rows
        per ``splitmix64 % B`` bucket, ``dhist`` counts *distinct values*
        per bucket).  The planner reads ``hist[bucket(c)]`` as the
        selectivity of an ``== c`` constant and ``n / distinct`` as the
        mean join fan-out.  ``cache_key``/``version`` identify the column
        as version-stamped append-only state; device backends compute the
        sketch over the resident coded buffer and cache the (tiny)
        result per ``(uid, data_version)`` — a re-plan at an unchanged
        version touches neither host column nor device.  Host backends
        ignore the hint."""
        col = np.asarray(col, np.int64)
        n = len(col)
        if n == 0:
            z = np.zeros(SKETCH_BUCKETS, np.int64)
            return {"n": 0, "distinct": 0, "hist": z, "dhist": z.copy()}
        b = (splitmix64(col) % np.uint64(SKETCH_BUCKETS)).astype(np.int64)
        hist = np.bincount(b, minlength=SKETCH_BUCKETS).astype(np.int64)
        uniq = np.unique(col)
        db = (splitmix64(uniq) % np.uint64(SKETCH_BUCKETS)).astype(np.int64)
        dhist = np.bincount(db, minlength=SKETCH_BUCKETS).astype(np.int64)
        return {"n": n, "distinct": len(uniq), "hist": hist,
                "dhist": dhist}
