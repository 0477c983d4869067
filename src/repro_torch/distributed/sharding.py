"""Fact-table sharding (``EngineConfig(shards=N)``): the devices of the
shards.

The port's copy of the reference's ``fact_mesh`` (its
``distributed/sharding.py``).  The reference's GSPMD specs for the LM
(``spec_for``, ``shardings_for``, ``activation_hints``, ...) are not
ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Sequence

import torch


def fact_devices(n_shards: int, devices: Sequence | None = None
                 ) -> list[torch.device]:
    """One device per shard of a hash-partitioned fact table.

    Each device owns the facts whose rank-1 key hashes to its index —
    the device generalization of the paper's derivation-tree parallel
    index writes (each writer owns a memory range).  With ``devices=None``
    the shards take ``n_shards`` distinct CUDA devices, and too few raise
    instead of silently folding into a degenerate layout (as the
    reference's ``fact_mesh`` does when JAX sees too few devices).  An
    explicit list may repeat a device (``[cuda:0] * 4``, ``[cpu] * 8``):
    several shards then share it, the counterpart of the reference's
    forced host device count on the CPU.
    """
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n_shards:
            raise ValueError(f"fact_devices({n_shards}) got {len(devs)} "
                             "devices")
        return devs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_shards:
        raise ValueError(
            f"fact_devices({n_shards}) needs {n_shards} CUDA devices but "
            f"torch sees {have}; pass an explicit device list to share one")
    return [torch.device("cuda", i) for i in range(n_shards)]
