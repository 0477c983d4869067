"""Inter-device pipelines: GPipe stages over a mesh axis and the sharded
fact engine's frontier all-to-all.

Pipeline parallelism (``pipeline_apply``): on a multi-pod mesh the slow
inter-pod links carry only per-microbatch activations when pipeline
*stages* map to pods, instead of per-layer FSDP all-gathers.  Stage
``s`` holds the contiguous layers ``[s*L/S, (s+1)*L/S)`` on the ``s``-th
device along the axis, and microbatches stream through on the 1F
schedule (``n_micro + n_stages - 1`` ticks; the bubble is
``(stages-1)/microbatches``), each tick's activations handed stage to
stage by ``spmd.ppermute`` (the reference's ``collective_permute``).

Frontier exchange (``FrontierExchange``): the transport of
``EngineConfig(shards=N)`` — each fixpoint round, every shard worker
hands over the *append frontier* rows whose derived keys hash to a
foreign shard.  Rows are packed into three int64 lanes (packed
``(id, attr)`` key / raw value / table-and-kind meta), bucketed per
destination with ``core.distributed.bucket_scatter`` on the source
shard's device, and moved with the all-to-all slot permute of
``core.distributed._exchange`` (slot ``d`` of every source goes to
``devices[d]``: a peer copy across cards, a no-op within one).
Send-buffer capacity is exact: the host knows every bucket count, so
``slot_cap`` is the power-of-two-rounded max bucket — no overflow/retry
loop.  When no device list is given and torch sees fewer CUDA devices
than shards (or the engine runs the numpy backend) the same exchange
runs as a host permute with identical semantics and byte accounting.

The port's copy of the reference's ``distributed/pipeline.py``; its
``shard_map`` over a mesh becomes a list of ``torch.device``
(``launch/mesh.py``'s ``Mesh``, ``sharding.fact_devices``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.distributed import _exchange, bucket_scatter
from repro_torch.distributed import compression as C
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import fact_devices, is_sharded, piece


def pipeline_apply(block_fn, stacked_params, h: torch.Tensor, *, mesh,
                   n_stages: int, n_micro: int, axis: str = "pod"):
    """Run ``h`` through all layers with stage-held params.

    ``block_fn(layer_params, h_micro) -> h_micro``; ``stacked_params``: a
    tree whose leaves are ``[L_total, ...]`` (tensors or
    ``ShardedTensor``s); ``h``: ``[B, ...]`` with ``B % n_micro == 0``.
    Stage ``s`` runs on the ``s``-th device along ``axis`` (the other
    axes at 0) with its own layers copied there.  Each tick, stage 0
    takes microbatch ``t``, every stage runs its layers on what it holds
    and ``ppermute`` hands the results on (``s -> s + 1``); the last
    stage writes microbatch ``t - (S - 1)``.  A stage with no microbatch
    in flight (the bubble) idles: the reference runs it on values no
    output reads.  Returns the output on ``h``'s device.
    """
    from repro_torch.models.params import tree_leaves, tree_map
    B = h.shape[0]
    assert B % n_micro == 0
    mb = B // n_micro
    devs = mesh.axis_devices(axis)
    if len(devs) != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis} axis of "
                         f"{len(devs)}")
    per = tree_leaves(stacked_params, is_sharded)[0].shape[0] // n_stages

    def stage_params(s):
        lo = s * per
        return tree_map(lambda x: piece(x, devs[s], [(lo, lo + per)]),
                        stacked_params, is_leaf=is_sharded)
    stages = [stage_params(s) for s in range(n_stages)]

    def run_stage(s, x):
        for i in range(per):
            x = block_fn(tree_map(lambda w: w[i], stages[s]), x)
        return x

    micro = h.reshape(n_micro, mb, *h.shape[1:])
    out = [None] * n_micro
    cur = [None] * n_stages
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            cur[0] = micro[t].to(devs[0])
        processed = []
        for s in range(n_stages):
            if 0 <= t - s < n_micro:
                processed.append(run_stage(s, cur[s]))
            else:
                processed.append(torch.zeros((mb, *h.shape[1:]),
                                             dtype=h.dtype, device=devs[s]))
        done = t - (n_stages - 1)
        if done >= 0:
            out[done] = processed[-1].to(h.device)
        cur = spmd.ppermute(processed, perm, devs)
    return torch.cat(out, 0)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class FrontierExchange:
    """All-to-all transport for the sharded engine's append frontiers.

    ``exchange(dest, key, val, meta)`` takes per-source-shard host
    arrays (``dest``: int32 destination shard per row; the three int64
    payload lanes) and returns per-destination-shard received lanes
    plus a byte-accounting dict.  Row validity on the receive side is
    carried by the ``meta`` lane (small non-negative values; the
    sentinel never collides), so ``val`` may hold any int64 bit
    pattern.

    Device path (``devices`` given, or ``prefer_device`` and at least
    ``n_shards`` CUDA devices): per source shard, the lanes are uploaded
    to its device and scattered into per-destination slots there
    (``bucket_scatter``), slot ``d`` of every source moves to
    ``devices[d]``, and the received lanes come back to the host.  A
    failing copy or scatter raises; it never moves to the host path.
    Host path (no device list and too few CUDA devices, or
    ``prefer_device=False``): the same permutation on host arrays.
    """

    def __init__(self, n_shards: int, prefer_device: bool = True,
                 compress: bool | None = None,
                 devices: Sequence | None = None) -> None:
        self.n_shards = n_shards
        self.devices = None
        if compress is None:
            env = os.environ.get("REPRO_COMPRESS")
            compress = env is None or env not in ("0", "false", "off")
        self.compress = bool(compress)
        if devices is not None:
            self.devices = fact_devices(n_shards, devices)
        elif prefer_device and n_shards > 1:
            try:
                self.devices = fact_devices(n_shards)
            except ValueError:
                self.devices = None  # too few devices: host permute

    @property
    def device(self) -> bool:
        return self.devices is not None

    # -- device path -------------------------------------------------------
    def _lane_plans(self, key, val, meta):
        """Per-lane wire plans for one exchange round (``None`` entries
        ship raw int64).  The key and meta lanes narrow well (dense
        interned ids / small table-and-kind tags); the value lane may
        hold arbitrary bit patterns and usually stays raw."""
        if not self.compress:
            return (None, None, None)
        return tuple(C.lane_plan(list(lane)) for lane in (key, val, meta))

    def _exchange_device(self, dest, key, val, meta, slot_cap, plans):
        D = self.n_shards
        sentinels = tuple(C.lane_sentinel(p) for p in plans)
        sends = []  # per source: the three lanes' send buffers
        for s, dev in enumerate(self.devices):
            d = torch.from_numpy(np.asarray(dest[s], np.int32)).to(dev)
            valid = d >= 0
            bufs = []
            for col, p, sent in zip((key[s], val[s], meta[s]), plans,
                                    sentinels):
                lane = torch.from_numpy(C.narrow_lane(col, p)).to(dev)
                buf, _ovf = bucket_scatter(d, lane, D, slot_cap, valid,
                                           sentinel=sent)
                bufs.append(buf)
            sends.append(bufs)
        recv = [_exchange([b[i] for b in sends], self.devices, slot_cap)
                for i in range(3)]
        out = []
        for d in range(D):
            bk, bv, bm = (recv[i][d].cpu().numpy() for i in range(3))
            # row validity rides the meta lane: its wire sentinel marks
            # empty slots (real metas keep reserved headroom below it)
            ok = bm != sentinels[2]
            out.append(tuple(C.widen_lane(b[ok], p)
                             for b, p in zip((bk, bv, bm), plans)))
        return out

    # -- host path ---------------------------------------------------------
    def _exchange_host(self, dest, key, val, meta):
        D = self.n_shards
        out = []
        for d in range(D):
            ks, vs, ms = [], [], []
            for s in range(D):
                m = dest[s] == d
                if m.any():
                    ks.append(key[s][m])
                    vs.append(val[s][m])
                    ms.append(meta[s][m])
            cat = lambda xs: (np.concatenate(xs) if xs
                              else np.empty(0, np.int64))
            out.append((cat(ks), cat(vs), cat(ms)))
        return out

    # -- public ------------------------------------------------------------
    def exchange(self, dest: list, key: list, val: list, meta: list
                 ) -> tuple[list, dict]:
        """Move rows to their destination shards.

        Returns ``([(key, val, meta)] * n_shards, stats)``.  Stats:
        ``payload_bytes`` (real rows x 24B — the Δ-proportional
        traffic), ``padded_bytes`` (what the bounded-buffer a2a
        actually moved), plus the compressed-wire mirror of each
        (``payload_bytes_wire`` / ``padded_bytes_wire``) when the
        per-round frame-of-reference lane narrowing is on — the wire
        keys equal the raw ones when every lane ships raw.
        """
        D = self.n_shards
        rows = int(sum(len(d) for d in dest))
        counts = np.zeros((D, D), np.int64)
        for s in range(D):
            if len(dest[s]):
                np.add.at(counts[s], dest[s], 1)
        slot_cap = _pow2(max(1, int(counts.max())))
        if rows == 0:
            empty = [(np.empty(0, np.int64),) * 3 for _ in range(D)]
            return empty, {"rows": 0, "payload_bytes": 0, "padded_bytes": 0,
                           "payload_bytes_wire": 0, "padded_bytes_wire": 0,
                           "slot_cap": 0, "device": self.device,
                           "compress": self.compress}
        plans = self._lane_plans(key, val, meta)
        row_wire = sum(C.wire_itemsize(p) for p in plans)
        if self.device:
            out = self._exchange_device(dest, key, val, meta, slot_cap,
                                        plans)
            padded = D * D * slot_cap * 3 * 8
            padded_wire = D * D * slot_cap * row_wire
        else:
            # host permute moves no wire bytes, but account what the
            # device transport *would* ship so numpy-backend runs report
            # comparable compression ratios
            out = self._exchange_host(dest, key, val, meta)
            padded = rows * 3 * 8
            padded_wire = rows * row_wire
        return out, {"rows": rows, "payload_bytes": rows * 3 * 8,
                     "padded_bytes": padded,
                     "payload_bytes_wire": rows * row_wire,
                     "padded_bytes_wire": padded_wire,
                     "slot_cap": slot_cap, "device": self.device,
                     "compress": self.compress}
