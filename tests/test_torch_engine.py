"""The port's engine on the ``torch-cpu`` backend vs the reference engine
on ``backend="numpy"``.

Both engines get the same rules and facts; inference must write the same
number of facts, every query must return the same row set, and the
decoded-fact checksums (``core/sharded.py`` ``decoded_fact_checksum`` of
each package) must be equal.  The grid is the MJ/HJ × SU/HU × CR/RR
Table-1 grid of the reference backend tests plus the ``infer1`` and
``query1`` presets.  ``lubm_like(scale=1)`` runs through
``load_reference_state``, so both engines also share their interned ids
and their encoded tables must match row for row.
"""

import dataclasses

import pytest

import repro.core as ref
from repro.core.rulesets import rdfs_plus_rules as ref_rules
from repro.core.sharded import decoded_fact_checksum as ref_checksum
from repro_torch.core import EngineConfig, Fact, HiperfactEngine
from repro_torch.core.convert import load_reference_state
from repro_torch.core.rulesets import rdfs_plus_rules
from repro_torch.core.sharded import decoded_fact_checksum
from repro_torch.datasets import LUBM_QUERIES, lubm_like

KG_QUERIES = [
    [("Data", "?x", "type", "D")],
    [("Data", "?a", "partOf", "?b")],
    [("Data", "?x", "type", "?t"), ("Data", "?x", "knows", "?y")],
]

LUBM_TUPLES = [
    [("Data", "?x", "type", "Person")],
    [("Data", "?x", "type", "Student"), ("Data", "?x", "takesCourse", "?c")],
    [("Data", "?x", "subOrganizationOf", "?u")],
    [("Data", "?s", "advisor", "?p"), ("Data", "?p", "memberOf", "?d"),
     ("Data", "?s", "memberOf", "?d")],
]


def kg_facts(F=Fact):
    return [
        F("Schema", "A", "subClassOf", "B"),
        F("Schema", "B", "subClassOf", "C"),
        F("Schema", "C", "subClassOf", "D"),
        F("Schema", "knows", "characteristic", "symmetric"),
        F("Schema", "partOf", "characteristic", "transitive"),
        F("Data", "x", "type", "A"),
        F("Data", "y", "type", "B"),
        F("Data", "x", "knows", "y"),
        F("Data", "p1", "partOf", "p2"),
        F("Data", "p2", "partOf", "p3"),
    ]


def to_ref(facts):
    return [ref.Fact(f.fact_type, f.id, f.attr, f.val,
                     ref.ValueType(int(f.valtype))) for f in facts]


def query_sets(engine, queries, cond):
    return [{tuple(sorted(r.items())) for r in engine.query(
        [cond(*c) for c in q])} for q in queries]


def ref_config(cfg: EngineConfig) -> "ref.EngineConfig":
    return ref.EngineConfig(**{**dataclasses.asdict(cfg),
                               "backend": "numpy"})


def run_pair(cfg: EngineConfig, facts):
    """(port engine on torch-cpu, reference engine on numpy), inferred."""
    e = HiperfactEngine(dataclasses.replace(cfg, backend="torch-cpu"))
    e.add_rules(rdfs_plus_rules())
    e.insert_facts(facts)
    r = ref.HiperfactEngine(ref_config(cfg))
    r.add_rules(ref_rules())
    r.insert_facts(to_ref(facts))
    return (e, e.infer()), (r, r.infer())


def assert_same(pair, queries_port, queries_ref):
    (e, s), (r, rs) = pair
    assert s.facts_inferred == rs.facts_inferred
    assert e.store.num_facts() == r.store.num_facts()
    assert queries_port(e) == queries_ref(r)
    assert decoded_fact_checksum(e) == ref_checksum(r)


def kg_queries(engine_mod_cond):
    return lambda e: query_sets(e, KG_QUERIES, engine_mod_cond)


GRID = [(j, u, la) for j in ("MJ", "HJ") for u in ("SU", "HU")
        for la in ("CR", "RR")]


@pytest.mark.parametrize("join,unique,layout", GRID,
                         ids=lambda v: v if isinstance(v, str) else str(v))
def test_engine_parity_grid(join, unique, layout):
    from repro.core.conditions import cond as rcond
    from repro_torch.core.conditions import cond
    cfg = EngineConfig(index_backend="AI", join=join, unique=unique,
                       layout=layout)
    assert_same(run_pair(cfg, kg_facts()), kg_queries(cond),
                kg_queries(rcond))


@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_engine_parity_presets(preset):
    from repro.core.conditions import cond as rcond
    from repro_torch.core.conditions import cond
    cfg = getattr(EngineConfig, preset)()
    assert_same(run_pair(cfg, kg_facts()), kg_queries(cond),
                kg_queries(rcond))
    assert getattr(EngineConfig, preset)(
        backend="torch-cpu").label().endswith("@torch-cpu")


def table_rows(engine):
    return {(ft, int(t.ids[i]), int(t.attrs[i]), int(t.vals[i]),
             int(t.valtypes[i]))
            for ft, t in engine.store.tables.items()
            for i in range(t.n) if t.alive[i]}


@pytest.mark.parametrize("preset", ["infer1", "query1"])
@pytest.mark.parametrize("eval_mode", ["full", "delta", "auto"])
def test_lubm_through_reference_state(preset, eval_mode):
    facts = lubm_like(scale=1)
    rcfg = getattr(ref.EngineConfig, preset)(backend="numpy")
    rcfg.eval_mode = eval_mode
    r = ref.HiperfactEngine(rcfg)
    r.add_rules(ref_rules())
    r.insert_facts(to_ref(facts))
    strings = [r.store.strings.lookup_id(i)
               for i in range(len(r.store.strings))]
    tables = {ft: (t.ids[t.alive], t.attrs[t.alive], t.vals[t.alive],
                   t.valtypes[t.alive]) for ft, t in r.store.tables.items()}
    cfg = getattr(EngineConfig, preset)(backend="torch-cpu")
    cfg.eval_mode = eval_mode
    e = HiperfactEngine(cfg)
    e.add_rules(rdfs_plus_rules())
    # lubm_like repeats some facts; the reference kept one row of each
    n_rows = sum(len(cols[0]) for cols in tables.values())
    assert 0 < n_rows <= len(facts)
    assert load_reference_state(e, strings, tables) == n_rows
    assert table_rows(e) == table_rows(r)
    s, rs = e.infer(), r.infer()
    assert s.facts_inferred == rs.facts_inferred > 0
    assert table_rows(e) == table_rows(r)  # same ids, same encoded rows
    assert decoded_fact_checksum(e) == ref_checksum(r)
    from repro.core.conditions import cond as rcond
    from repro_torch.core.conditions import cond
    assert [[cond(*c) for c in q] for q in LUBM_TUPLES] == LUBM_QUERIES
    assert query_sets(e, LUBM_TUPLES, cond) == query_sets(r, LUBM_TUPLES,
                                                          rcond)


def test_load_reference_state_rejects_mismatched_ids():
    e = HiperfactEngine(EngineConfig(backend="numpy"))
    e.add_rules(rdfs_plus_rules())  # interns rule constants first
    with pytest.raises(ValueError, match="same rules"):
        load_reference_state(e, ["not-a-rule-constant"], {})


def test_unported_modes_raise():
    """No engine mode raises any more: demand evaluation is ported
    (``tests/test_torch_demand.py``), the sharded engine too
    (``tests/test_torch_sharded.py``), and compressed columns are on by
    default and take either flag."""
    from repro_torch.core.sharded import ShardedEngine
    assert HiperfactEngine(EngineConfig(
        backend="torch-cpu", eval_mode="demand"))._counting
    e = HiperfactEngine(EngineConfig(backend="torch-cpu",
                                     eval_mode="demand", shards=2))
    assert isinstance(e, ShardedEngine) and e._counting
    e = HiperfactEngine(EngineConfig(backend="torch-cpu", shards=2))
    assert isinstance(e, ShardedEngine) and len(e.workers) == 2
    for flag in (True, False):
        assert HiperfactEngine(EngineConfig(
            backend="torch-cpu", compress=flag)).ops.compress is flag
    # "auto" resolves to one shard off the CUDA backend
    assert HiperfactEngine(EngineConfig(backend="torch-cpu",
                                        shards="auto")).ops.name == \
        "torch[cpu]"


@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_streaming_appends_merge_maintained(preset, monkeypatch):
    """Load, infer, append, re-infer: the port's index mirrors absorb the
    appends by merge (``sort_work.delta_merges``) and the engine still
    matches the reference after every round.  LPIM pages are cut to 64
    rows, so its index compacts (re-sorts its tail into the base) at this
    size as it does at full scale with 4096-row pages."""
    from repro.core.conditions import cond as rcond
    from repro_torch.core import store
    from repro_torch.core.conditions import cond
    monkeypatch.setattr(store, "PAGE_ROWS", 64)
    facts = lubm_like(scale=1)
    cut = [0, len(facts) // 2, 3 * len(facts) // 4, len(facts)]
    cfg = getattr(EngineConfig, preset)(backend="torch-cpu")
    e = HiperfactEngine(cfg)
    e.add_rules(rdfs_plus_rules())
    work = e.ops.sort_work.snapshot()
    r = ref.HiperfactEngine(ref_config(cfg))
    r.add_rules(ref_rules())
    for lo, hi in zip(cut, cut[1:]):
        e.insert_facts(facts[lo:hi])
        r.insert_facts(to_ref(facts[lo:hi]))
        assert e.infer().facts_inferred == r.infer().facts_inferred
        assert decoded_fact_checksum(e) == ref_checksum(r)
        assert query_sets(e, LUBM_TUPLES, cond) == query_sets(r, LUBM_TUPLES,
                                                              rcond)
    assert e.ops.sort_work.delta(work).delta_merges > 0
