"""Distributed fact processing — the paper's engine across devices.

The paper confines itself to one node ("realizing the fact storage in a ...
distributed fashion is not part of this work"); this module is the natural
multi-device extension of its two parallel ideas:

* derivation-tree **parallel index writes** (each thread owns a memory
  range) -> each device owns a hash partition of the fact space;
* the **fork-join sort-merge** instances -> fork = shard over the
  devices, local work = the same sorted-array algebra, join = an
  all-to-all repartitioning by join key (exactly a distributed
  sort-merge join).

Everything is fixed-capacity: relations are sentinel-padded sorted
buffers + counts, so one semi-naive fixpoint iteration
(``closure_step``) runs the same shapes every round.

The flagship workload is transitive closure (RDFS-Plus ``prp-trp`` /
``scm-sco`` — the recursive heart of the paper's LUBM benchmark).

The port's copy of the reference's ``core/distributed.py``.  Shards are
a list of ``torch.device`` (one per shard; a device may repeat, which
runs several shards on one card or on the CPU).  The reference's
``lax.all_to_all`` becomes a slot permute (``_exchange``: slot ``d`` of
every source shard's send buffer is concatenated, in source order, on
``devices[d]``; ``.to()`` is a peer copy across cards and a no-op
within one), and ``lax.psum`` becomes a sum over the shards.  None of
these primitives is a Pallas kernel in the reference, even on the TPU:
they are plain XLA ops, and the stock torch ops used here
(``argsort(stable=True)``, ``searchsorted``, ``cumsum``, ``index_put_``)
are their faithful counterparts, not a stand-in for a hand-written
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.launch import hlo_analysis as _ha

SENTINEL = int(np.iinfo(np.int64).max)
_M32 = 0xFFFFFFFF


def _s64(c: int) -> int:
    """The int64 whose bits are the unsigned 64-bit constant ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (torch's ``>>`` is arithmetic,
    and ``uint64`` lacks shifts and products on CUDA in most builds)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def pack_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pack two int32 columns into one sortable int64 key."""
    return (a.to(torch.int64) << 32) | (b.to(torch.int64) & _M32)


def unpack_pair(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (p >> 32).to(torch.int32), (p & _M32).to(torch.int32)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 on int64 lanes (device twin of ``backend.splitmix64``).
    Runs in int64, where wrapping ``+``, ``*`` and ``^`` are bit-identical
    to the unsigned arithmetic."""
    z = z.to(torch.int64) + _s64(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _s64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _s64(0x94D049BB133111EB)
    return z ^ _shr(z, 31)


def _owner(keys: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owner shard per key — device twin of ``core.sharded.shard_of``.
    The modulo is the unsigned one, so signed lanes agree with the host
    twin for any device count, not just powers of two: the unsigned
    value is ``hi * 2^32 + lo`` with both halves non-negative."""
    h = _mix64(keys)
    hi, lo = _shr(h, 32), h & _M32
    r = ((hi % n_dev) * ((1 << 32) % n_dev) + lo % n_dev) % n_dev
    return r.to(torch.int32)


# ---------------------------------------------------------------------------
# In-shard primitives (static shapes, sentinel padded)


def bucket_scatter(dest: torch.Tensor, payload: torch.Tensor, n_dev: int,
                   slot_cap: int, valid: torch.Tensor,
                   sentinel: int = SENTINEL
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter ``payload`` rows into a ``[n_dev * slot_cap]`` send buffer by
    destination device.  Returns (buffer, overflow_count).  Out-of-capacity
    rows are dropped and counted (the caller re-runs with a bigger slot
    cap if the overflow flag trips — bounded-buffer discipline).

    ``sentinel`` fills empty slots; compressed-wire lanes (sub-int64
    payload dtypes) pass their own dtype's max, since the int64 default
    does not fit.  Rows keep their order within a bucket (a stable
    argsort, as ``jnp.argsort``)."""
    n = dest.shape[0]
    dev = payload.device
    d = torch.where(valid, dest.to(torch.int64), n_dev)
    order = torch.argsort(d, stable=True)
    d_sorted = d[order]
    payload_sorted = payload[order]
    starts = torch.searchsorted(
        d_sorted, torch.arange(n_dev, dtype=torch.int64, device=dev))
    idx_in_bucket = (torch.arange(n, device=dev)
                     - starts[d_sorted.clamp(0, n_dev - 1)])
    live = d_sorted < n_dev
    ok = live & (idx_in_bucket < slot_cap)
    # dropped rows land in one spill slot past the end (the reference's
    # ``.at[pos].set(..., mode="drop")``), cut off below
    pos = torch.where(ok, d_sorted * slot_cap + idx_in_bucket,
                      n_dev * slot_cap)
    buf = torch.full((n_dev * slot_cap + 1,), sentinel, dtype=payload.dtype,
                     device=dev)
    buf.index_put_((pos,), payload_sorted)
    overflow = (live & (idx_in_bucket >= slot_cap)).sum()
    return buf[:n_dev * slot_cap], overflow


def join_expand_bounded(
    l_key: torch.Tensor, l_payload: torch.Tensor,
    r_sorted_key: torch.Tensor, r_payload: torch.Tensor,
    out_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted equi-join with bounded emission.

    ``l_key`` (sentinel-padded) probes ``r_sorted_key`` (sorted, padded);
    emits up to ``out_cap`` (l_payload, r_payload) pairs + overflow count.
    The expansion is the searchsorted-on-prefix-sums trick: pure index
    arithmetic, no data-dependent shapes.
    """
    dev = l_key.device
    l_valid = l_key != SENTINEL
    lo = torch.searchsorted(r_sorted_key, l_key)
    hi = torch.searchsorted(r_sorted_key, l_key, side="right")
    counts = torch.where(l_valid, hi - lo, 0)
    starts = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    out_idx = torch.arange(out_cap, device=dev)
    row = (torch.searchsorted(starts, out_idx, side="right") - 1
           ).clamp(0, l_key.shape[0] - 1)
    within = out_idx - starts[row]
    ok = (out_idx < total) & (within < counts[row])
    r_idx = (lo[row] + within).clamp(0, r_sorted_key.shape[0] - 1)
    out_l = torch.where(ok, l_payload[row], SENTINEL)
    out_r = torch.where(ok, r_payload[r_idx], SENTINEL)
    overflow = (total - out_cap).clamp(min=0)
    return out_l, out_r, overflow


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted arrays by rank arithmetic (O(n) traffic instead of
    an O(n log n) re-sort — the paper's SU *merge* pass, device form).

    Tie-break: 'left' on a vs 'right' on b makes target ranks disjoint.
    """
    na, nb = a.shape[0], b.shape[0]
    pos_a = torch.arange(na, device=a.device) + torch.searchsorted(b, a)
    pos_b = (torch.arange(nb, device=a.device)
             + torch.searchsorted(a, b, side="right"))
    out = torch.zeros(na + nb, dtype=a.dtype, device=a.device)
    out[pos_a] = a
    out[pos_b] = b
    return out


def compact_masked(values_sorted: torch.Tensor, mask: torch.Tensor, cap: int,
                   fill) -> torch.Tensor:
    """Keep masked entries of a sorted array, left-packed to ``cap`` —
    a cumsum scatter instead of a sort.  Entries past ``cap`` drop into
    a spill slot."""
    pos = torch.where(mask, torch.cumsum(mask.to(torch.int64), 0) - 1, cap)
    out = torch.full((cap + 1,), fill, dtype=values_sorted.dtype,
                     device=values_sorted.device)
    out.index_put_((pos.clamp(max=cap),), values_sorted)
    return out[:cap]


def merge_unique(store_sorted: torch.Tensor, new_keys: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SU unique filter + merge (paper §2.4 deduplication, device form).

    Returns (merged_sorted_store, fresh_keys (padded), n_fresh).  ``fresh``
    are new keys neither duplicated in the batch nor present in the store.
    Overflowing the store capacity drops the largest keys (flagged by the
    caller via count checks).

    The store update is a rank-arithmetic *merge* of two sorted runs, not
    a re-sort of the whole store — only the small arrival buffer is ever
    sorted.
    """
    ns = torch.sort(new_keys).values
    first = torch.ones_like(ns, dtype=torch.bool)
    first[1:] = ns[1:] != ns[:-1]
    valid = (ns != SENTINEL) & first
    pos = torch.searchsorted(store_sorted, ns).clamp(
        0, store_sorted.shape[0] - 1)
    present = store_sorted[pos] == ns
    fresh_mask = valid & ~present
    fresh = compact_masked(ns, fresh_mask, ns.shape[0], SENTINEL)
    merged = merge_sorted(store_sorted, fresh)[: store_sorted.shape[0]]
    return merged, fresh, fresh_mask.sum()


# ---------------------------------------------------------------------------
# Distributed transitive closure (semi-naive)


@dataclasses.dataclass
class ClosureConfig:
    edge_cap: int = 1 << 14      # per-device closure/edge buffer capacity
    delta_cap: int = 1 << 12     # per-device frontier capacity
    slot_cap: int = 1 << 8       # per-destination all_to_all slots
    join_cap: int = 1 << 13      # per-device join emission capacity


def _exchange(bufs: Sequence[torch.Tensor], devices: Sequence[torch.device],
              slot_cap: int) -> list[torch.Tensor]:
    """All-to-all of per-source ``[n_dev * slot_cap]`` send buffers: the
    received rows of shard ``d`` are slot ``d`` of every source, in
    source order, on ``devices[d]`` (``lax.all_to_all`` with
    ``tiled=True``); announced to an active recorder as ``all-to-all``."""
    def run():
        return [torch.cat([b[d * slot_cap:(d + 1) * slot_cap].to(dev)
                           for b in bufs])
                for d, dev in enumerate(devices)]
    if _ha.ACTIVE is None:
        return run()
    return _ha.ACTIVE.collective("all-to-all", devices, run,
                                 sources=[b.device for b in bufs])


def _psum(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]
          ) -> list[torch.Tensor]:
    """``lax.psum``: the sum over the shards, on every shard's device;
    announced to an active recorder as ``all-reduce``."""
    def run():
        total = sum(x.to(devices[0]) for x in xs)
        return [total.to(dev) for dev in devices]
    if _ha.ACTIVE is None:
        return run()
    return _ha.ACTIVE.collective("all-reduce", devices, run,
                                 sources=[x.device for x in xs])


def closure_step(state: Sequence[dict], cfg: ClosureConfig,
                 devices: Sequence[torch.device]) -> list[dict]:
    """One semi-naive iteration over every shard:

    Δ'(x,z) = Δ(x,y) ⋈ E(y,z), deduplicated against the closure store.
    Two all_to_all repartitions: Δ by join key y, results by owner hash(x).
    ``state[s]`` holds shard ``s``'s buffers on ``devices[s]``:
    edges/closure: [E] packed (src,dst) sorted; delta: [Δ] packed (x,y).
    """
    n_dev = len(devices)
    # 1. route Δ to the owner of its join key y
    bufs, ovf = [], []
    for st in state:
        delta = st["delta"]
        _, y = unpack_pair(delta)
        buf, o = bucket_scatter(_owner(y, n_dev), delta, n_dev,
                                cfg.slot_cap, delta != SENTINEL)
        bufs.append(buf)
        ovf.append(o)
    arrived_delta = _exchange(bufs, devices, cfg.slot_cap)

    # 2. local join on y: E is sorted by packed (src,dst) => prefix search by
    #    src works on the src-extracted (still sorted) view
    bufs = []
    for s, st in enumerate(state):
        edges, dj = st["edges"], arrived_delta[s]
        xj, yj = unpack_pair(dj)
        e_src = torch.where(edges != SENTINEL, edges >> 32, SENTINEL >> 32)
        live = dj != SENTINEL
        out_x, out_z_pair, o2 = join_expand_bounded(
            torch.where(live, yj.to(torch.int64), SENTINEL),
            torch.where(live, xj.to(torch.int64), SENTINEL),
            e_src, edges, cfg.join_cap)
        # out_x = x of delta, out_z_pair = packed (y,z) edge; build (x,z)
        _, z = unpack_pair(out_z_pair)
        new_pairs = torch.where(out_x != SENTINEL,
                                pack_pair(out_x.to(torch.int32), z), SENTINEL)

        # 3. route new pairs to owner hash(x)
        nx, _ = unpack_pair(new_pairs)
        buf2, o3 = bucket_scatter(_owner(nx, n_dev), new_pairs, n_dev,
                                  cfg.slot_cap, new_pairs != SENTINEL)
        bufs.append(buf2)
        ovf[s] = ovf[s] + o2 + o3
    arrived = _exchange(bufs, devices, cfg.slot_cap)

    # 4. dedup + merge into closure; fresh pairs become next Δ
    out, fresh_n = [], []
    for s, st in enumerate(state):
        closure = st["closure"]
        merged, fresh, n_fresh = merge_unique(closure, arrived[s])
        fresh_sorted = fresh[: cfg.delta_cap]  # already sorted + left-packed
        o4 = (fresh != SENTINEL).sum() - (fresh_sorted != SENTINEL).sum()
        # closure-store overflow: valid keys dropped by the capacity
        # truncation
        o5 = ((closure != SENTINEL).sum() + (fresh != SENTINEL).sum()
              - (merged != SENTINEL).sum())
        ovf[s] = ovf[s] + o4 + o5
        fresh_n.append(n_fresh)
        out.append({"edges": st["edges"], "closure": merged,
                    "delta": fresh_sorted})
    total_fresh = _psum(fresh_n, devices)
    overflow = _psum(ovf, devices)
    for s, st in enumerate(out):
        st["fresh"] = total_fresh[s].to(torch.int64).reshape(1)
        st["overflow"] = overflow[s].to(torch.int64).reshape(1)
    return out


class DistributedClosure:
    """Host loop: partition edges over the shards' devices, loop
    ``closure_step`` to the fixpoint."""

    def __init__(self, devices: Sequence, cfg: ClosureConfig | None = None
                 ) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.cfg = cfg or ClosureConfig()
        self.n_dev = len(self.devices)

    # -- state construction --------------------------------------------------
    def init_state(self, src: np.ndarray, dst: np.ndarray) -> list[dict]:
        """Partition concrete edges: E shards by hash(src) (join side),
        closure/Δ shards by hash(x).

        Ownership uses the same ``shard_of`` as the engine's sharded mode
        (``core/sharded.py``), which is the host twin of the device
        ``_owner`` used inside ``closure_step`` — the toy and the engine
        agree on which shard owns a key by construction.
        """
        from repro_torch.core.sharded import shard_of

        cfg, D = self.cfg, self.n_dev
        packed = np.asarray(
            (src.astype(np.int64) << 32) | (dst.astype(np.int64) & _M32))
        h = shard_of(src.astype(np.int64), D)

        def shard_by(d: int, cap: int) -> torch.Tensor:
            out = np.full(cap, SENTINEL, np.int64)
            mine = np.sort(packed[h == d])[:cap]
            out[: len(mine)] = mine
            return torch.from_numpy(out).to(self.devices[d])

        return [{"edges": shard_by(d, cfg.edge_cap),
                 "closure": shard_by(d, cfg.edge_cap),
                 "delta": shard_by(d, cfg.delta_cap),
                 "fresh": torch.zeros(1, dtype=torch.int64, device=dev),
                 "overflow": torch.zeros(1, dtype=torch.int64, device=dev)}
                for d, dev in enumerate(self.devices)]

    def run(self, src: np.ndarray, dst: np.ndarray, max_iters: int = 64
            ) -> tuple[np.ndarray, int]:
        """Compute full transitive closure; returns (packed pairs, iters)."""
        state = self.init_state(np.asarray(src, np.int64),
                                np.asarray(dst, np.int64))
        iters = 0
        for _ in range(max_iters):
            state = closure_step(state, self.cfg, self.devices)
            iters += 1
            if int(state[0]["overflow"][0]) > 0:
                raise RuntimeError(
                    "capacity overflow — raise ClosureConfig caps")
            if int(state[0]["fresh"][0]) == 0:
                break
        clo = np.concatenate([st["closure"].cpu().numpy() for st in state])
        return np.unique(clo[clo != SENTINEL]), iters
