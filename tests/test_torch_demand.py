"""The port's demand evaluation (``eval_mode="demand"``) vs the reference.

Each case builds the same rules and facts into a port engine (on
``torch-cpu`` or the port's ``numpy`` backend) and into the reference
engine on ``backend="numpy"``, runs the same queries and writes, and
compares exactly: decoded row sets, ``decoded_fact_checksum`` and the
demand counters (``demand_rounds``, ``demand_cone_rows``,
``demand_fallbacks``, ``rows_considered``).  The reference engine takes
the device-pipeline setting the port's backend resolved to, since the
handle-tier join counts ``rows_considered`` its own way.  The cells
mirror ``tests/test_demand.py`` at one shard: chain/closure parity in
every eval mode, cone-only touch, the memo and query cache, the sketch
planner, every rung of the fallback ladder (direct and served through
``FactServer``), and the ``PROBE_CAP`` escalation under a concurrent
append; ``lubm_like(1)`` runs through ``load_reference_state``.
"""

import dataclasses
import threading

import pytest
import torch

import repro.core as R
import repro.core.demand as ref_demand
import repro_torch.core as P
import repro_torch.core.demand as demand_mod
from repro.core.rulesets import rdfs_plus_rules as ref_rdfs_rules
from repro.core.sharded import decoded_fact_checksum as ref_checksum
from repro_torch.core.convert import load_reference_state
from repro_torch.core.rulesets import rdfs_plus_rules
from repro_torch.core.sharded import decoded_fact_checksum
from repro_torch.datasets import lubm_like

BACKENDS = ["torch-cpu", "numpy"]
K_CHAINS, CHAIN_LEN = 3, 5
COUNTERS = ("demand_rounds", "demand_cone_rows", "demand_fallbacks",
            "rows_considered")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Fixtures, written once for either package (``m`` is ``repro.core`` or
# ``repro_torch.core``: both export the same names)


def chain_facts(m, k=K_CHAINS, length=CHAIN_LEN):
    return [m.Fact("edge", f"c{j}_n{i}", "to", f"c{j}_n{i + 1}")
            for j in range(k) for i in range(length)]


def closure_rules(m, sink=None):
    return [
        m.Rule("base", (m.cond("edge", "?x", "to", "?y"),),
               (m.AddAction("path", m.term("?x"), "to", m.term("?y")),)),
        m.Rule("rec", (m.cond("edge", "?x", "to", "?y"),
                       m.cond("path", "?y", "to", "?z")),
               (m.AddAction("path", m.term("?x"), "to", m.term("?z")),)),
    ]


def point_q(m):
    return [m.cond("path", "c0_n0", "to", "?z")]


def extra_edge(m, i=0):
    return m.Fact("edge", f"c0_n{CHAIN_LEN + i}", "to",
                  f"c0_n{CHAIN_LEN + i + 1}")


def rows_key(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def q_rows(engine, q):
    return rows_key(engine.query(q))


def port_cfg(backend, **kw):
    return dataclasses.replace(P.EngineConfig.infer1(backend), **kw)


def ref_cfg(pipeline=False, **kw):
    return dataclasses.replace(R.EngineConfig.infer1("numpy"),
                               device_pipeline="on" if pipeline else "off",
                               **kw)


def build(m, cfg, facts_fn=chain_facts, rules_fn=closure_rules, sink=None):
    e = m.HiperfactEngine(cfg)
    e.add_rules(rules_fn(m, sink))
    e.insert_facts(facts_fn(m))
    return e


def pair(backend, facts_fn=chain_facts, rules_fn=closure_rules, **kw):
    """(port engine, reference numpy engine) over the same fixture."""
    e = build(P, port_cfg(backend, **kw), facts_fn, rules_fn)
    r = build(R, ref_cfg(e._pipeline, **kw), facts_fn, rules_fn)
    return e, r


def counters(engine):
    return {k: getattr(engine.last_infer, k) for k in COUNTERS}


def assert_same(e, r, q_port, q_ref):
    got = q_rows(e, q_port)
    assert got == q_rows(r, q_ref)
    assert counters(e) == counters(r)
    assert decoded_fact_checksum(e) == ref_checksum(r)
    return got


def full_reference_rows(q=None, facts_fn=chain_facts, rules_fn=closure_rules):
    r = build(R, ref_cfg(eval_mode="full"), facts_fn, rules_fn)
    r.infer()
    return q_rows(r, q or point_q(R))


# ---------------------------------------------------------------------------
# Parity: demand ≡ delta ≡ full, port ≡ reference


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["full", "delta", "demand"])
def test_point_query_parity(mode, backend):
    e, r = pair(backend, eval_mode=mode)
    if mode != "demand":                # demand engines stay cold
        assert e.infer().facts_inferred == r.infer().facts_inferred
    got = assert_same(e, r, point_q(P), point_q(R))
    assert got == full_reference_rows()
    # a streaming append into the queried chain moves the demand memo
    # and the delta watermark alike
    e.insert_facts([extra_edge(P)])
    r.insert_facts([extra_edge(R)])
    if mode != "demand":
        e.infer()
        r.infer()
    got2 = assert_same(e, r, point_q(P), point_q(R))
    assert len(got2) == len(got) + 1
    assert got2 == full_reference_rows(
        facts_fn=lambda m: chain_facts(m) + [extra_edge(m)])


@pytest.mark.parametrize("mode", ["full", "delta", "demand"])
def test_sharded_engine_raises_naming_a9(mode):
    """The sharded engine is ported (ROADMAP A9): ``shards=2`` builds a
    ``ShardedEngine`` in every eval mode, and its point query equals the
    reference's two-shard numpy engine (``tests/test_torch_sharded.py``
    holds the rest)."""
    from repro_torch.core.sharded import ShardedEngine
    e = build(P, port_cfg("torch-cpu", eval_mode=mode, shards=2))
    assert isinstance(e, ShardedEngine) and len(e.workers) == 2
    assert all(w.config.eval_mode == mode for w in e.workers)
    r = build(R, ref_cfg(e.workers[0]._pipeline, eval_mode=mode, shards=2))
    if mode != "demand":
        e.infer()
        r.infer()
    assert q_rows(e, point_q(P)) == q_rows(r, point_q(R))


@pytest.mark.parametrize("backend", BACKENDS)
def test_demand_touches_only_the_cone(backend):
    e, r = pair(backend, eval_mode="demand")
    assert assert_same(e, r, point_q(P), point_q(R)) == full_reference_rows()
    st = e.last_infer
    assert st.demand_fallbacks == 0 and st.demand_cone_rows > 0

    def path_ids(engine):
        s, t = engine.store.strings, engine.store.tables["path"]
        return {s.lookup_id(int(t.ids[i])) for i in range(t.n)
                if t.alive[i]}

    ids = path_ids(e)
    assert ids == path_ids(r)
    assert ids and all(i.startswith("c0_") for i in ids)


@pytest.mark.parametrize("backend", BACKENDS)
def test_demand_restriction_beats_full_rows_considered(backend):
    ef, rf = pair(backend, eval_mode="full")
    ef.infer()
    rf.infer()
    assert_same(ef, rf, point_q(P), point_q(R))
    e, r = pair(backend, eval_mode="demand")
    assert_same(e, r, point_q(P), point_q(R))
    assert 0 < e.last_infer.rows_considered < ef.last_infer.rows_considered


@pytest.mark.parametrize("backend", BACKENDS)
def test_demand_memo_and_query_cache(backend):
    e, r = pair(backend, eval_mode="demand")
    assert_same(e, r, point_q(P), point_q(R))
    rounds = e.last_infer.demand_rounds
    n_facts = e.store.num_facts()
    # a repeat at fixed versions: a query-cache hit, no new rounds, no
    # new facts
    rows = e.query(point_q(P))
    r.query(point_q(R))
    assert e.last_infer.query_cache_hits == r.last_infer.query_cache_hits >= 1
    assert e.last_infer.demand_rounds == rounds
    assert e.store.num_facts() == n_facts
    # mutating a returned row must not poison the cache
    rows[0]["z"] = "mutant"
    assert q_rows(e, point_q(P)) == full_reference_rows()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["full", "demand"])
def test_sketch_planner_parity_and_counters(mode, backend):
    e, r = pair(backend, eval_mode=mode, sort_mode="sketch")
    if mode == "full":
        st, rst = e.infer(), r.infer()
        assert st.facts_inferred == rst.facts_inferred
    assert assert_same(e, r, point_q(P), point_q(R)) == full_reference_rows()
    st = e.last_infer
    assert st.sketch_hits + st.sketch_misses > 0
    assert (st.sketch_hits, st.sketch_misses) == (
        r.last_infer.sketch_hits, r.last_infer.sketch_misses)


@pytest.mark.parametrize("backend", BACKENDS)
def test_demand_requery_after_delete(backend):
    """Deletes between demand queries: the death-frontier check runs
    before the memo, so no retracted derivation is served."""
    e, r = pair(backend, eval_mode="demand")
    assert_same(e, r, point_q(P), point_q(R))
    e.delete_facts([P.Fact("edge", "c0_n2", "to", "c0_n3")])
    r.delete_facts([R.Fact("edge", "c0_n2", "to", "c0_n3")])
    got = assert_same(e, r, point_q(P), point_q(R))
    assert got == full_reference_rows(facts_fn=lambda m: [
        f for f in chain_facts(m) if (f.id, f.val) != ("c0_n2", "c0_n3")])
    assert len(got) == 2


# ---------------------------------------------------------------------------
# The fallback ladder: each rung reverts to full evaluation, on both
# packages alike


def _gated_rules(m, sink=None):
    return closure_rules(m) + [
        m.Rule("gated", (m.cond("Flag", "on", "enabled", "yes"),
                         m.cond("edge", "?x", "to", "?y")),
               (m.AddAction("path", m.term("?y"), "to", m.term("?x")),))]


def _external_rules(m, sink=None):
    return [m.Rule("base", (m.cond("edge", "?x", "to", "?y"),),
                   (m.AddAction("path", m.term("?x"), "to", m.term("?y")),
                    m.ExternalAction(lambda b: sink is not None
                                     and sink.append(1))))]


def _mixed_action_rules(m, sink=None):
    # the deleter sits inside the producing cone
    return closure_rules(m) + [
        m.Rule("mix", (m.cond("edge", "?x", "to", "?y"),),
               (m.AddAction("path", m.term("?y"), "to", m.term("?x")),
                m.DeleteAction("Scratch", m.term("?x"), "dead", "yes")))]


def _purge_rules(m, sink=None):
    return closure_rules(m) + [
        m.Rule("purge", (m.cond("Tomb", "?x", "dead", "yes"),),
               (m.DeleteAction("path", m.term("?x"), "to", "gone"),))]


# reason -> (rules_fn, facts_fn, query_fn)
FALLBACKS = {
    "unknown-constant": (
        closure_rules, chain_facts,
        lambda m: [m.cond("path", "never_interned", "to", "?z")]),
    "no-constants": (
        closure_rules, chain_facts,
        lambda m: [m.cond("path", "?x", "?a", "?z")]),
    "existence-gate": (
        _gated_rules,
        lambda m: chain_facts(m) + [m.Fact("Flag", "on", "enabled", "yes")],
        point_q),
    "external-action": (_external_rules, chain_facts, point_q),
    "delete-action": (_mixed_action_rules, chain_facts, point_q),
    "foreign-delete": (_purge_rules, chain_facts, point_q),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reason", sorted(FALLBACKS))
def test_fallback_rungs(reason, backend):
    rules_fn, facts_fn, q_fn = FALLBACKS[reason]
    sinks = ([], [])
    e = build(P, port_cfg(backend, eval_mode="demand"), facts_fn, rules_fn,
              sinks[0])
    r = build(R, ref_cfg(e._pipeline, eval_mode="demand"), facts_fn,
              rules_fn, sinks[1])
    assert demand_mod.DemandEvaluator(e, q_fn(P)).fallback == reason
    assert ref_demand.DemandEvaluator(r, q_fn(R)).fallback == reason
    got = assert_same(e, r, q_fn(P), q_fn(R))
    assert e.last_infer.demand_fallbacks == 1
    assert got == full_reference_rows(q_fn(R), facts_fn, rules_fn)
    if reason == "unknown-constant":
        assert got == []
    if reason == "external-action":
        # the sink fired: full evaluation really ran, on both sides
        assert sinks[0] and len(sinks[0]) == len(sinks[1])
        assert len(got) == 1


@pytest.mark.parametrize("reason", sorted(FALLBACKS))
def test_served_fallback_parity(reason):
    from repro.serve import FactServer as RefServer
    from repro_torch.serve import FactServer

    rules_fn, facts_fn, q_fn = FALLBACKS[reason]
    e, r = pair("torch-cpu", facts_fn, rules_fn, eval_mode="demand")
    assert demand_mod.DemandEvaluator(e, q_fn(P)).fallback == reason
    ref = full_reference_rows(q_fn(R), facts_fn, rules_fn)
    with FactServer(e, batching=False) as srv, \
            RefServer(r, batching=False) as rsrv:
        first, rfirst = srv.serve(q_fn(P)), rsrv.serve(q_fn(R))
        assert rows_key(first.rows) == ref
        assert first.checksum() == rfirst.checksum()
        assert first.mode == rfirst.mode
        assert e.last_infer.demand_fallbacks >= 1
        again = srv.serve(q_fn(P))       # repeat at an unchanged frontier
        assert again.checksum() == first.checksum()
        rsrv.serve(q_fn(R))
        assert counters(e) == counters(r)


def test_served_probe_cap_escalation_under_concurrent_append(monkeypatch):
    """Demand sets that outgrow ``PROBE_CAP`` mid-flight, while a writer
    streams cold appends, escalate to unrestricted demand; each served
    result equals a reference full-evaluation replay of the write prefix
    behind its token."""
    from repro_torch.serve import FactServer

    monkeypatch.setattr(demand_mod, "PROBE_CAP", 2)
    monkeypatch.setattr(ref_demand, "PROBE_CAP", 2)
    e, r = pair("torch-cpu", eval_mode="demand")
    ev = demand_mod.DemandEvaluator(e, point_q(P))
    rev = ref_demand.DemandEvaluator(r, point_q(R))
    assert ev.fallback is None and rev.fallback is None
    while ev.round():
        pass
    while rev.round():
        pass
    # the tiny cap really escalates, on the same types as the reference
    assert any(d.all for d in ev.demand.values()), "no escalation hit"
    assert ({t: d.all for t, d in ev.demand.items()}
            == {t: d.all for t, d in rev.demand.items()})
    assert ev.facts_written == rev.facts_written

    e2 = build(P, port_cfg("torch-cpu", eval_mode="demand"))
    extra = [extra_edge(P, i) for i in range(6)]
    with FactServer(e2, batching=False, record_history=True) as srv:
        served = []

        def writer():
            for f in extra:
                srv.append([f])           # demand default: no infer

        def reader():
            for _ in range(8):
                served.append(srv.serve(point_q(P)))

        ts = [threading.Thread(target=writer),
              threading.Thread(target=reader)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        final = srv.serve(point_q(P))
        history = srv.history

    # oracle: replay each history prefix on a reference full engine
    by_token = {}
    writes = []
    for kind, facts, tok in history:
        if facts:
            writes.append((kind, [R.Fact(f.fact_type, f.id, f.attr, f.val)
                                  for f in facts]))
        o = build(R, ref_cfg(eval_mode="full"))
        o.infer()
        for kind2, fs in writes:
            (o.insert_facts if kind2 == "append" else o.delete_facts)(fs)
            o.infer()
        by_token[tok] = q_rows(o, point_q(R))
    for res in served + [final]:
        assert res.token in by_token, "torn read: token outside history"
        assert rows_key(res.rows) == by_token[res.token]
    assert len(final.rows) == CHAIN_LEN + len(extra)


# ---------------------------------------------------------------------------
# LUBM through the reference's interned state


LUBM_TUPLES = [
    [("Data", "?x", "type", "Person")],
    [("Data", "?x", "type", "Student"), ("Data", "?x", "takesCourse", "?c")],
    [("Data", "?x", "subOrganizationOf", "?u")],
    [("Data", "?s", "advisor", "?p"), ("Data", "?p", "memberOf", "?d"),
     ("Data", "?s", "memberOf", "?d")],
    [("Data", "stu0_0_0", "type", "?t")],
    [("Data", "?x", "memberOf", "dept0_0")],
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_lubm_demand_through_reference_state(preset, backend):
    facts = lubm_like(scale=1)
    cfg = getattr(P.EngineConfig, preset)(backend)
    cfg.eval_mode = "demand"
    e = P.HiperfactEngine(cfg)
    e.add_rules(rdfs_plus_rules())
    rcfg = getattr(R.EngineConfig, preset)("numpy")
    rcfg.eval_mode = "demand"
    rcfg.device_pipeline = "on" if e._pipeline else "off"
    r = R.HiperfactEngine(rcfg)
    r.add_rules(ref_rdfs_rules())
    r.insert_facts([R.Fact(f.fact_type, f.id, f.attr, f.val,
                           R.ValueType(int(f.valtype))) for f in facts])
    strings = [r.store.strings.lookup_id(i)
               for i in range(len(r.store.strings))]
    tables = {ft: (t.ids[t.alive], t.attrs[t.alive], t.vals[t.alive],
                   t.valtypes[t.alive]) for ft, t in r.store.tables.items()}
    load_reference_state(e, strings, tables)
    full = R.HiperfactEngine(getattr(R.EngineConfig, preset)("numpy"))
    full.add_rules(ref_rdfs_rules())
    full.insert_facts([R.Fact(f.fact_type, f.id, f.attr, f.val,
                              R.ValueType(int(f.valtype))) for f in facts])
    full.infer()
    for q in LUBM_TUPLES:
        got = assert_same(e, r, [P.cond(*c) for c in q],
                          [R.cond(*c) for c in q])
        assert got == q_rows(full, [R.cond(*c) for c in q])
        assert got
    st = e.last_infer
    assert st.demand_fallbacks == 0
    assert 0 < st.demand_cone_rows < full.last_infer.facts_inferred
