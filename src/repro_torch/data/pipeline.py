"""Deterministic, shard-aware synthetic data pipeline.

Requirements from the brief: restart-reproducible (seed + step indexed —
a restarted job regenerates bit-identical batches), shardable (each data
shard draws only its slice), and fast enough not to bottleneck CPU smoke
training.  Two sources:

* ``SyntheticLM`` — Zipf-distributed token stream with a deterministic
  per-(step, position) hash; no state beyond (seed, step).
* ``FactCorpusSource`` (data/factsource.py) — sequences derived from a
  Hiperfact engine's inferred facts: the paper's engine as the rule-based
  feature-derivation stage of the training data layer (DESIGN.md §4).

A copy of the reference ``data/pipeline.py`` (numpy only): every batch is
bit-identical to the reference's for the same (seed, step, shard,
num_shards).  Batches are numpy int32; the trainer moves them to its
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    z = x.astype(np.uint64)
    z = (z + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Stateless batch generator: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # precompute a Zipf CDF over the vocab for inverse sampling
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(w) / w.sum()

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        rows = np.arange(shard * b, (shard + 1) * b, dtype=np.uint64)
        pos = np.arange(cfg.seq_len + 1, dtype=np.uint64)
        base = (np.uint64(cfg.seed) * np.uint64(0x100000001B3)
                + np.uint64(step) * np.uint64(0x1000193))
        h = _mix(base + rows[:, None] * np.uint64(1 << 20) + pos[None, :])
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ShardedLoader:
    """Host-side loader that materializes only this host's shard and is
    indexed by step (restart == re-ask for the same step)."""

    def __init__(self, source, shard: int = 0, num_shards: int = 1):
        self.source = source
        self.shard = shard
        self.num_shards = num_shards

    def __call__(self, step: int) -> dict:
        return self.source.batch(step, self.shard, self.num_shards)
