"""Host backend: the numpy twins of the fork-join primitives.

These are the original bulk/vectorized implementations lifted out of
``core/joins.py`` — they double as the oracles for the device backend's
parity tests (see ``tests/test_backend.py``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.backend.base import Ops


class NumpyOps(Ops):
    name = "numpy"

    def sort_kv(self, keys: np.ndarray, vals: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]

    def sort_perm(self, keys: np.ndarray, *, cache_key=None,
                  version: int | None = None, n_dead: int = 0,
                  alive=None, hint: str | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        # native-dtype fast path: no int64 casts, no arange payload.
        # cache_key/version are device-residency hints (mirror caching +
        # merge maintenance) — meaningless here.  The alive mask is not:
        # tombstone compaction filters dead rows out of the mirror (perm
        # keeps original row ids, stable order preserved).
        keys = np.asarray(keys)
        if alive is not None and n_dead:
            rows = np.flatnonzero(np.asarray(alive[:len(keys)], bool))
            kept = keys[rows]
            order = np.argsort(kept, kind="stable")
            return kept[order], rows[order]
        order = np.argsort(keys, kind="stable")
        return keys[order], order

    def join_pairs(self, lkeys: np.ndarray, rkeys: np.ndarray, *,
                   rkeys_key=None, rkeys_version: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Sorts the right side once, then resolves every left key with two
        binary searches; the expansion to pairs is pure index arithmetic
        (no host loop)."""
        lkeys = np.asarray(lkeys)
        rkeys = np.asarray(rkeys)
        if len(lkeys) == 0 or len(rkeys) == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        rorder = np.argsort(rkeys, kind="stable")
        rsorted = rkeys[rorder]
        lo = np.searchsorted(rsorted, lkeys, side="left")
        hi = np.searchsorted(rsorted, lkeys, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        li = np.repeat(np.arange(len(lkeys), dtype=np.int64), counts)
        starts = np.cumsum(counts) - counts
        pos_within = np.arange(total, dtype=np.int64) - starts[li]
        ri = rorder[lo[li] + pos_within]
        return li, ri

    def unique_mask(self, sorted_keys: np.ndarray) -> np.ndarray:
        sorted_keys = np.asarray(sorted_keys)
        n = len(sorted_keys)
        if n == 0:
            return np.zeros(0, bool)
        mask = np.empty(n, bool)
        mask[0] = True
        mask[1:] = sorted_keys[1:] != sorted_keys[:-1]
        return mask

    def semi_join(self, keys: np.ndarray, bound_values: np.ndarray
                  ) -> np.ndarray:
        keys = np.asarray(keys)
        bound_values = np.asarray(bound_values)
        if len(keys) == 0 or len(bound_values) == 0:
            return np.zeros(len(keys), bool)
        uniq = np.unique(bound_values)
        pos = np.searchsorted(uniq, keys)
        pos = np.clip(pos, 0, len(uniq) - 1)
        return uniq[pos] == keys

    def dedup_rows(self, cols: list[np.ndarray]) -> np.ndarray:
        cols = [np.asarray(c) for c in cols]
        n = len(cols[0])
        if n == 0:
            return np.empty(0, np.int64)
        order = np.lexsort(tuple(reversed(cols)))
        # a sorted row is new iff it differs from its predecessor in ANY col
        diff = np.zeros(n, bool)
        diff[0] = True
        for c in cols:
            cs = c[order]
            diff[1:] |= cs[1:] != cs[:-1]
        return np.sort(order[diff])
