"""Hiperfact-derived training corpus — the paper's engine as the data layer.

The engine's derivation trees (paper §2.4) act as the *feature derivation*
stage: raw facts stream in, RDFS-Plus-style rules infer the closure, and a
QUERY rule (paper Defs. 10/11 — only rules below a query are evaluated)
selects the (subject, predicate, object) triples whose dictionary-encoded
handles become token sequences.  Lazy rule evaluation here is exactly the
paper's "don't process facts no query needs" applied to data curation.

Port of the reference ``data/factsource.py`` over ``repro_torch.core``.
The default engine is ``EngineConfig.infer1()``, the ``torch`` backend on
the card (it raises without one); CPU callers pass an engine built on
``torch-cpu`` or ``numpy`` (``corpus_engine``).  On the ``numpy`` backend
the batches are bit-identical to the reference's.  Join pair order is
unspecified (``backend/base.py``), so another backend may give the same
triples in another order, and so other batches; one backend gives the same
order build after build, so ``batch(step)`` stays a pure function of
(seed, step) across restarts.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.conditions import cond
from repro_torch.core.engine import EngineConfig, HiperfactEngine
from repro_torch.core.facts import Fact
from repro_torch.core.rulesets import rdfs_plus_rules


def synth_kg(n_entities: int = 200, n_edges: int = 600, seed: int = 0):
    """A small synthetic knowledge graph (entities, typed edges, classes)."""
    rng = np.random.RandomState(seed)
    facts = []
    classes = [f"C{i}" for i in range(8)]
    for i in range(len(classes) - 1):  # class chain for subClassOf closure
        facts.append(Fact("Schema", classes[i], "subClassOf", classes[i + 1]))
    facts.append(Fact("Schema", "linksTo", "characteristic", "transitive"))
    for e in range(n_entities):
        facts.append(Fact("Data", f"e{e}", "type",
                          classes[rng.randint(len(classes))]))
    src = rng.randint(0, n_entities, n_edges)
    dst = rng.randint(0, n_entities, n_edges)
    for s, d in zip(src, dst):
        facts.append(Fact("Data", f"e{s}", "linksTo", f"e{d}"))
    return facts


def corpus_engine(seed: int = 0, backend: str = "torch",
                  n_entities: int = 200, n_edges: int = 600
                  ) -> HiperfactEngine:
    """``infer1`` on ``backend`` with the RDFS-Plus rules over
    ``synth_kg(n_entities, n_edges, seed)``, inferred to its fixpoint:
    the engine ``FactCorpusSource`` builds when given none."""
    engine = HiperfactEngine(EngineConfig.infer1(backend))
    engine.add_rules(rdfs_plus_rules())
    engine.insert_facts(synth_kg(n_entities, n_edges, seed))
    engine.infer()
    return engine


class FactCorpusSource:
    """Token sequences from the inferred closure of a synthetic KG.

    Each training sequence is a random walk over inferred triples, using
    dictionary handles (mod vocab) as token ids — deterministic given
    (seed, step).
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, engine: HiperfactEngine | None = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        if engine is None:
            engine = corpus_engine(seed)
        self.engine = engine
        rows = engine.query([cond("Data", "?s", "linksTo", "?o")],
                            decode=False)
        s = np.asarray(rows.col("s"), np.int64)
        o = np.asarray(rows.col("o"), np.int64)
        self._triples = np.stack([s, o], axis=1)
        if len(self._triples) == 0:
            self._triples = np.zeros((1, 2), np.int64)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 97 + shard) % (2**31 - 1))
        idx = rng.randint(0, len(self._triples), (b, self.seq_len + 1))
        toks = (self._triples[idx, idx % 2] % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
