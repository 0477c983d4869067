"""The port's data layer (``repro_torch.data``) against the reference's.

* the reference's four data tests, run against the port (the fact corpus
  on the port's ``numpy`` engine: the default engine is the card's);
* ``SyntheticLM`` batches bit-equal to the reference's over several
  (seed, step, shard, num_shards);
* ``FactCorpusSource`` on the port's ``numpy`` engine bit-equal to the
  reference's source (triples and batches) at the default KG size, and on
  ``torch-cpu`` equal to it as a multiset of triples with an equal
  ``facts_inferred``, at a smaller KG: the kernels' plain versions run the
  sort network on the CPU, which takes minutes at the default size.  Join
  pair order is unspecified, so the triples are not compared in order
  there;
* ``engine=None`` builds on the card and raises without one.

This file imports ``repro.core`` (through the reference's fact source),
which turns on jax's x64 mode: no other new test file of the port does.
"""

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data.factsource import FactCorpusSource as RefFactCorpusSource
from repro.data.factsource import synth_kg as ref_synth_kg
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
from repro_torch.data.factsource import (FactCorpusSource, corpus_engine,
                                         synth_kg)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the torch-cpu KG: (entities, edges), at the default's 3 edges an entity
SMALL_KG = (40, 120)


@pytest.fixture(scope="module")
def numpy_source():
    """The port's source on its ``numpy`` engine, the reference test's
    arguments and the default KG."""
    return FactCorpusSource(vocab=256, seq_len=16, global_batch=4, seed=1,
                            engine=corpus_engine(1, "numpy"))


def test_step_indexed_determinism():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=3)
    a = SyntheticLM(cfg).batch(7)
    b = SyntheticLM(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_shards_partition_global_batch():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=0)
    src = SyntheticLM(cfg)
    full = src.batch(3, 0, 1)
    parts = [src.batch(3, s, 4) for s in range(4)]
    stacked = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(full["tokens"], stacked)
    loader = ShardedLoader(src, shard=2, num_shards=4)
    np.testing.assert_array_equal(loader(3)["tokens"], parts[2]["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=50, seq_len=16, global_batch=2, seed=0)
    b = SyntheticLM(cfg).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_fact_corpus_deterministic_and_derived(numpy_source):
    src = numpy_source
    a = src.batch(2)
    b = FactCorpusSource(vocab=256, seq_len=16, global_batch=4, seed=1,
                         engine=corpus_engine(1, "numpy")).batch(2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16)
    assert (a["tokens"] >= 0).all() and (a["tokens"] < 256).all()
    # the engine actually inferred a closure larger than the raw edges
    assert src.engine.last_infer.facts_inferred > 0


@pytest.mark.parametrize("seed,step,shard,num_shards,vocab,seq,batch", [
    (0, 0, 0, 1, 1000, 32, 8),
    (3, 7, 0, 1, 50_280, 64, 4),
    (3, 7, 1, 4, 50_280, 64, 8),
    (11, 123_456, 3, 4, 152_064, 17, 8),
    (2**20, 9, 5, 8, 256, 128, 16),
])
def test_synthetic_lm_bit_equal_to_reference(seed, step, shard, num_shards,
                                             vocab, seq, batch):
    ref = RefSyntheticLM(RefDataConfig(vocab=vocab, seq_len=seq,
                                       global_batch=batch, seed=seed))
    port = SyntheticLM(DataConfig(vocab=vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    a, b = ref.batch(step, shard, num_shards), port.batch(step, shard,
                                                          num_shards)
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert b[k].dtype == a[k].dtype == np.int32
        np.testing.assert_array_equal(b[k], a[k])


def test_synth_kg_equals_reference():
    for args in ((200, 600, 0), SMALL_KG + (3,)):
        assert [repr(f) for f in synth_kg(*args)] == \
            [repr(f) for f in ref_synth_kg(*args)]


def test_fact_corpus_numpy_bit_equal_to_reference(numpy_source):
    ref = RefFactCorpusSource(vocab=256, seq_len=16, global_batch=4, seed=1)
    np.testing.assert_array_equal(numpy_source._triples, ref._triples)
    assert numpy_source.engine.last_infer.facts_inferred == \
        ref.engine.last_infer.facts_inferred
    for step, shard, num_shards in ((0, 0, 1), (2, 0, 1), (7, 1, 2),
                                    (99, 3, 4)):
        a = ref.batch(step, shard, num_shards)
        b = numpy_source.batch(step, shard, num_shards)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def _ref_engine(seed, n_entities, n_edges):
    from repro.core.engine import EngineConfig, HiperfactEngine
    from repro.core.rulesets import rdfs_plus_rules
    e = HiperfactEngine(EngineConfig.infer1("numpy"))
    e.add_rules(rdfs_plus_rules())
    e.insert_facts(ref_synth_kg(n_entities, n_edges, seed))
    e.infer()
    return e


def test_fact_corpus_torch_cpu_equals_reference_as_multiset():
    seed = 5
    ref = RefFactCorpusSource(vocab=512, seq_len=16, global_batch=4,
                              seed=seed, engine=_ref_engine(seed, *SMALL_KG))
    port = FactCorpusSource(vocab=512, seq_len=16, global_batch=4,
                            seed=seed, engine=corpus_engine(
                                seed, "torch-cpu", *SMALL_KG))
    assert port.engine.last_infer.facts_inferred == \
        ref.engine.last_infer.facts_inferred > 0
    assert port._triples.shape == ref._triples.shape
    assert sorted(map(tuple, port._triples.tolist())) == \
        sorted(map(tuple, ref._triples.tolist()))
    # one backend, one order: a second build gives the same batches
    again = FactCorpusSource(vocab=512, seq_len=16, global_batch=4,
                             seed=seed, engine=corpus_engine(
                                 seed, "torch-cpu", *SMALL_KG))
    np.testing.assert_array_equal(again._triples, port._triples)
    b = port.batch(3)
    assert (b["tokens"] >= 0).all() and (b["tokens"] < 512).all()


def test_fact_corpus_default_engine_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FactCorpusSource(vocab=256, seq_len=16, global_batch=4)
