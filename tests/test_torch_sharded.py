"""The port's sharded engine (``EngineConfig(shards=N)``) vs the reference.

Every cell of ``tests/test_sharded.py`` runs on the port, on its
``numpy`` backend and on ``torch-cpu``: the reference test's own
assertions hold on the port's engines, and each port ``ShardedEngine``
is held against the reference ``ShardedEngine`` on ``backend="numpy"``
built from the same facts — the decoded-fact checksum,
``facts_inferred``, the rule analysis (``_pick_home``,
``_rewrite_rule``, the registered views), every flush of
``exchange_log`` (``rows``, ``payload_bytes``, ``padded_bytes``,
``slot_cap``, ``owner_fresh``) and the query and gather-memo counters.
The reference engine takes the device-pipeline setting the port's
backend resolves to (on for ``torch-cpu``), as in
``tests/test_torch_demand.py``.  Both run the host permute: on the CPU
torch sees no CUDA device (the device transport over repeated devices is
``tests/test_torch_distributed.py``'s).

Beyond the mirror: a demand cell at four shards, the numpy mirror of
``tests/test_serve_distributed.py``'s sharded ``FactServer`` (each
served result held against a reference numpy replay of its write
prefix), and the serving launcher at ``--shards 4``.
"""

import dataclasses
import random
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.sharded as R_sharded
import repro_torch.core as P
import repro_torch.core.sharded as P_sharded
from repro.core.engine import _resolve_shards as ref_resolve_shards
from repro.core.querycache import QueryResultCache as RefResultCache
from repro.core.rulesets import rdfs_plus_rules as ref_rdfs_rules
from repro_torch.core.distributed import _owner
from repro_torch.core.engine import _resolve_shards
from repro_torch.core.querycache import QueryResultCache
from repro_torch.core.rulesets import rdfs_plus_rules

BACKENDS = ["numpy", "torch-cpu"]
# the reference engine's device pipeline per port backend
PIPELINE = {"numpy": "off", "torch-cpu": "on"}
LOG_KEYS = ("phase", "rows", "payload_bytes", "padded_bytes", "slot_cap",
            "owner_fresh", "owner_deleted", "device")

REF = SimpleNamespace(core=R, sh=R_sharded, rules=ref_rdfs_rules)
PORT = SimpleNamespace(core=P, sh=P_sharded, rules=rdfs_plus_rules)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(ns, backend, shards, **kw):
    """``EngineConfig`` of ``ns``'s package: the port on ``backend``, the
    reference on numpy with the matching device pipeline."""
    if ns is REF:
        return R.EngineConfig(backend="numpy", shards=shards,
                              device_pipeline=PIPELINE[backend], **kw)
    return P.EngineConfig(backend=backend, shards=shards, **kw)


def twins(backend, fn):
    """``fn(ns, make_cfg)`` on the port (``backend``) and on the reference
    (numpy); returns (port result, reference result)."""
    return tuple(fn(ns, lambda shards, ns=ns, **kw: cfg(ns, backend, shards,
                                                        **kw))
                 for ns in (PORT, REF))


def flushes(e):
    return [tuple(log[k] for k in LOG_KEYS) for log in e.exchange_log]


def rows_key(rows):
    return sorted(str(sorted(r.items())) for r in rows)


def seed_engine(ns, make_cfg, shards, n=80, seed=3, **kw):
    m = ns.core
    eng = m.HiperfactEngine(make_cfg(shards, **kw))
    for r in ns.rules():
        eng.add_rule(r)
    rnd = random.Random(seed)
    facts = [m.Fact("Schema", f"C{i}", "subClassOf", f"C{(i + 3) % 15}")
             for i in range(15)]
    facts += [m.Fact("Schema", "knows", "characteristic", "symmetric"),
              m.Fact("Schema", "anc", "characteristic", "transitive"),
              m.Fact("Schema", "p0", "subPropertyOf", "p1"),
              m.Fact("Schema", "p1", "domain", "C0"),
              m.Fact("Schema", "p0", "inverseOf", "q0")]
    eng.insert_facts(facts)
    data = []
    for i in range(n):
        data.append(m.Fact("Data", f"x{i}", "type", f"C{rnd.randrange(15)}"))
        data.append(m.Fact("Data", f"x{i}", "anc",
                           f"x{rnd.randrange(n // 3)}"))
        data.append(m.Fact("Data", f"x{i}", "knows", f"x{(i * 7) % n}"))
        data.append(m.Fact("Data", f"x{i}", "p0", f"x{(i * 3) % n}"))
    eng.insert_facts(data)
    return eng


def summary(ns, e):
    """What a sharded engine is held to: checksum, sizes, flushes."""
    return {"checksum": ns.sh.decoded_fact_checksum(e),
            "num_facts": e.num_facts(), "resident": e.resident_facts(),
            "flushes": flushes(e)}


# ---------------------------------------------------------------------------
# Dispatch + ownership


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_dispatch_by_shards(backend):
    def run(ns, make_cfg):
        m = ns.core
        assert type(m.HiperfactEngine(make_cfg(1))) is m.HiperfactEngine
        e = m.HiperfactEngine(make_cfg(4))
        assert isinstance(e, ns.sh.ShardedEngine)
        return (len(e.workers), [w.shard for w in e.workers],
                e.exchange.device, e.exchange.n_shards)
    got, want = twins(backend, run)
    assert got == want == (4, [0, 1, 2, 3], False, 4)
    # one "device" off the CUDA backend: auto degrades to the unsharded
    # engine on both of the port's CPU backends
    assert _resolve_shards(cfg(PORT, backend, "auto")) == 1
    assert ref_resolve_shards(cfg(REF, backend, "auto")) == 1
    with pytest.raises(ValueError):
        _resolve_shards(cfg(PORT, backend, 0))
    # every worker runs its own Ops of the engine's backend
    e = P.HiperfactEngine(cfg(PORT, backend, 4))
    assert len({id(w.ops) for w in e.workers}) == 4
    assert {w.ops.name for w in e.workers} == {e.ops.name}
    assert all(w.store.strings is e.store.strings for w in e.workers)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_of_is_deterministic_and_balanced(backend):
    """The port's host ``shard_of`` (numpy) and its device twin
    ``_owner`` on CPU tensors (torch-cpu) equal the reference's
    ``shard_of`` lane for lane, negative lanes included."""
    if backend == "numpy":
        owner = P_sharded.shard_of
    else:
        def owner(lanes, n):
            return _owner(torch.from_numpy(lanes), n).numpy()
    lanes = np.arange(10_000, dtype=np.int64)
    a = owner(lanes, 8)
    np.testing.assert_array_equal(a, owner(lanes, 8))
    np.testing.assert_array_equal(a, R_sharded.shard_of(lanes, 8))
    counts = np.bincount(a, minlength=8)
    assert counts.min() > 0.7 * counts.max()  # splitmix64 spreads keys
    neg = np.array([-1, -2, -(1 << 62), -(1 << 63), (1 << 63) - 1],
                   np.int64)
    for n in (3, 4, 7, 8):
        got = owner(neg, n)
        assert ((got >= 0) & (got < n)).all()
        np.testing.assert_array_equal(got, R_sharded.shard_of(neg, n))


# ---------------------------------------------------------------------------
# Rule rewrite: home island + hashed/replicated views


def rewrite_twins(backend, rule_fn):
    """``_pick_home``/``_rewrite_rule`` of the port and the reference on
    the same rule, and the views a 4-shard engine of each registers."""
    def run(ns, make_cfg):
        m = ns.core
        r = rule_fn(m)
        home = ns.sh._pick_home(r)
        rw, views = ns.sh._rewrite_rule(r, home)
        e = m.HiperfactEngine(make_cfg(4))
        e.add_rule(r)
        worker_types = [[c.fact_type for c in wr.conditions]
                        for w in e.workers for wr in w.rules]
        return {"home": home,
                "types": [c.fact_type for c in rw.conditions],
                "views": [(t, None if c is None else int(c))
                          for t, c in views],
                "registered": {t: sorted(-1 if c is None else int(c)
                                         for c in cs)
                               for t, cs in e._views.items()},
                "worker_types": worker_types}
    got, want = twins(backend, run)
    assert got == want
    return got


@pytest.mark.parametrize("backend", BACKENDS)
def test_rewrite_two_island_join_hashes_anchor(backend):
    got = rewrite_twins(backend, lambda m: m.Rule(
        "spo", (m.cond("Schema", "?p", "subPropertyOf", "?q"),
                m.cond("Data", "?x", "?p", "?y")),
        (m.AddAction("Data", m.term("?x"), m.term("?q"), m.term("?y")),)))
    assert got["home"] is not None
    assert sum(t.startswith(P_sharded.VIEW_PREFIX)
               for t in got["types"]) == 1
    assert len(got["views"]) == 1
    ftype, comp = got["views"][0]
    assert ftype in ("Schema", "Data")
    assert comp is not None


@pytest.mark.parametrize("backend", BACKENDS)
def test_rewrite_schema_only_rule_is_replicated(backend):
    got = rewrite_twins(backend, lambda m: m.Rule(
        "sco", (m.cond("Schema", "?a", "subClassOf", "?b"),
                m.cond("Schema", "?b", "subClassOf", "?c")),
        (m.AddAction("Schema", m.term("?a"), "subClassOf", m.term("?c")),)))
    assert got["home"] is not None
    assert sum(t.startswith(P_sharded.VIEW_PREFIX)
               for t in got["types"]) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_condition_rule_needs_no_views(backend):
    got = rewrite_twins(backend, lambda m: m.Rule(
        "sym", (m.cond("Data", "?x", "knows", "?y"),),
        (m.AddAction("Data", m.term("?y"), "knows", m.term("?x")),)))
    assert got["views"] == [] and got["registered"] == {}
    assert got["types"] == ["Data"]


# ---------------------------------------------------------------------------
# Parity: sharded fixpoint == unsharded fixpoint == the reference's


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shards", [2, 4, 7])
def test_closure_checksum_parity(shards, backend):
    def run(ns, make_cfg):
        e = seed_engine(ns, make_cfg, shards)
        st = e.infer()
        return e, st.facts_inferred, summary(ns, e)
    (eN, nN, got), (_, rN, want) = twins(backend, run)
    e1 = seed_engine(PORT, lambda s, **kw: cfg(PORT, backend, s, **kw), 1)
    s1 = e1.infer()
    assert P_sharded.decoded_fact_checksum(e1) == got["checksum"]
    assert e1.store.num_facts() == eN.num_facts()
    assert s1.facts_inferred == nN == rN
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_append_parity_with_empty_frontier_rounds(backend):
    def run(ns, make_cfg):
        m = ns.core
        e1, e4 = seed_engine(ns, make_cfg, 1), seed_engine(ns, make_cfg, 4)
        e1.infer(), e4.infer()
        n0 = len(e4.exchange_log)
        sums = []
        for batch in ([m.Fact("Data", "z9", "knows", "z8")],
                      [m.Fact("Data", "z8", "knows", "z9")]):
            for e in (e1, e4):
                e.insert_facts(batch)
                e.infer()
            sums.append((ns.sh.decoded_fact_checksum(e1),
                         ns.sh.decoded_fact_checksum(e4)))
        init = sum(log["rows"] for log in e4.exchange_log[:n0]
                   if log["phase"] == "infer")
        delta = sum(log["rows"] for log in e4.exchange_log[n0:]
                    if log["phase"] == "infer")
        return sums, init, delta, summary(ns, e4)
    got, want = twins(backend, run)
    sums, init, delta, _ = got
    assert all(a == b for a, b in sums)
    assert 0 < delta < init / 2, (delta, init)
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_shard_only_derivation(backend):
    def rule(m):
        return m.Rule("t", (m.cond("E", "?x", "next", "?y"),
                            m.cond("E", "?y", "next", "?z")),
                      (m.AddAction("E", m.term("?x"), "next",
                                   m.term("?z")),))

    def run(ns, make_cfg):
        m = ns.core
        out = []
        for shards in (4, 1):
            e = m.HiperfactEngine(make_cfg(shards))
            e.add_rule(rule(m))
            e.insert_facts([m.Fact("E", "a", "next", "b"),
                            m.Fact("E", "b", "next", "c")])
            e.infer()
            out.append(ns.sh.decoded_fact_checksum(e))
            if shards == 4:
                got = {(r["x"], r["z"]) for r in e.query(
                    [m.cond("E", "?x", "next", "?z")])}
                out += [sorted(got), summary(ns, e)]
        return out
    got, want = twins(backend, run)
    assert got[0] == got[3]  # sharded == unsharded
    assert ("a", "c") in got[1]
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_delete_rule_parity(backend):
    def build(ns, make_cfg, shards):
        m = ns.core
        e = m.HiperfactEngine(make_cfg(shards))
        e.add_rule(m.Rule("mark", (m.cond("T", "?x", "flag", "off"),),
                          (m.AddAction("Dead", m.term("?x"), "is",
                                       "dead"),)))
        e.add_rule(m.Rule("reap", (m.cond("Dead", "?x", "is", "dead"),
                                   m.cond("T", "?x", "flag", "?v")),
                          (m.DeleteAction("T", m.term("?x"), "flag",
                                          m.term("?v")),)))
        e.insert_facts([m.Fact("T", f"n{i}", "flag",
                               "off" if i % 3 == 0 else "on")
                        for i in range(60)])
        e.infer()
        return e

    def run(ns, make_cfg):
        e1, e4 = build(ns, make_cfg, 1), build(ns, make_cfg, 4)
        sel = [ns.core.cond("T", "?x", "flag", "?v")]
        return (ns.sh.decoded_fact_checksum(e1), rows_key(e1.query(sel)),
                rows_key(e4.query(sel)), summary(ns, e4))
    got, want = twins(backend, run)
    assert got[0] == got[3]["checksum"]
    assert got[1] == got[2]
    assert all("'on'" in r for r in got[2])
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_parity_and_cache_counters(backend):
    def run(ns, make_cfg):
        m = ns.core
        e1, e4 = seed_engine(ns, make_cfg, 1), seed_engine(ns, make_cfg, 4)
        e1.infer(), e4.infer()
        q = [m.cond("Data", "?x", "type", "?c")]
        r1, r4 = e1.query(q), e4.query(q)
        assert rows_key(r1) == rows_key(r4)
        assert e4.last_infer.query_cache_misses >= 1
        hits0 = e4.last_infer.query_cache_hits
        r4b = e4.query(q)
        assert e4.last_infer.query_cache_hits == hits0 + 1
        assert rows_key(r4b) == rows_key(r4)
        e4.insert_facts([m.Fact("Data", "fresh", "type", "C0")])
        e4.infer()
        r4c = e4.query(q)
        assert len(r4c) > len(r4)
        assert {"x": "fresh", "c": "C0"} in r4c
        return (rows_key(r4c), e4.last_infer.query_cache_hits,
                e4.last_infer.query_cache_misses, hits0, summary(ns, e4))
    got, want = twins(backend, run)
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_views_hidden_from_api(backend):
    def run(ns, make_cfg):
        e4 = seed_engine(ns, make_cfg, 4)
        e4.infer()
        assert not any(t.startswith(P_sharded.VIEW_PREFIX)
                       for t, *_ in ns.sh.iter_decoded_facts(e4))
        assert e4.resident_facts() >= e4.num_facts()
        assert len(e4.shard_bytes()) == 4
        views = sorted({n for w in e4.workers for n in w.store.tables
                        if n.startswith(P_sharded.VIEW_PREFIX)})
        return views, sorted(ns.sh.iter_decoded_facts(e4)), summary(ns, e4)
    got, want = twins(backend, run)
    assert got[0]  # the rdfs rules do register views
    assert got == want


def test_query_result_cache_lru_and_keys():
    """The port's ``QueryResultCache`` (the sharded engine's parent-side
    result cache) through the reference test's sequence, stats equal to
    the reference cache's."""
    out = []
    for cls in (QueryResultCache, RefResultCache):
        c = cls(max_entries=2)
        k1 = cls.key((("T", "?x"),), ("tok", 1))
        k2 = cls.key((("T", "?x"),), ("tok", 2))
        assert k1 != k2
        assert c.lookup(k1) is None
        c.put(k1, [{"x": "a"}])
        assert [dict(r) for r in c.lookup(k1)] == [{"x": "a"}]
        c.put(k2, [{"x": "b"}])
        c.put(cls.key((("U",),), ("tok", 1)), [])
        assert c.lookup(k2) is not None
        s = c.stats()
        assert s["hits"] >= 2 and s["misses"] >= 1
        assert cls.key(([],), ("tok", 1)) is None
        out.append(s)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Signed delta frontiers across the exchange: deletes as first-class deltas


def mixed_stream_engine(ns, make_cfg, shards, eval_mode, lazy=False):
    m = ns.core
    e = m.HiperfactEngine(make_cfg(shards, eval_mode=eval_mode, lazy=lazy))
    e.add_rule(m.Rule("hot", (m.cond("Reading", "?s", "temp", "?t"),
                              m.cond("Zone", "?s", "in", "?z")),
                      (m.AddAction("Alert", m.term("?s"), "zone",
                                   m.term("?z")),)))
    e.add_rule(m.Rule("audit", (m.cond("Alert", "?s", "zone", "?z"),),
                      (m.AddAction("Audit", m.term("?z"), "saw",
                                   m.term("?s")),)))
    e.add_rule(m.Rule("q", (m.cond("Audit", "?z", "saw", "?s"),)))
    return e


def mixed_stream(m, e, rounds=3, n=40):
    stats = []
    for r in range(rounds):
        base = r * n
        e.insert_facts(
            [m.Fact("Reading", f"s{base + i}", "temp", f"t{i % 7}")
             for i in range(n)]
            + [m.Fact("Zone", f"s{base + i}", "in", f"z{i % 4}")
               for i in range(n)])
        e.infer()
        e.delete_facts([m.Fact("Reading", f"s{base + i}", "temp",
                               f"t{i % 7}") for i in range(0, n, 3)])
        stats.append(e.infer())
    return stats


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shards", [1, 4])
def test_mixed_append_delete_stream_parity(shards, backend):
    def run(ns, make_cfg):
        ef = mixed_stream_engine(ns, make_cfg, 1, "full")
        ed = mixed_stream_engine(ns, make_cfg, shards, "delta")
        mixed_stream(ns.core, ef)
        dstats = mixed_stream(ns.core, ed)
        return {"full": ns.sh.decoded_fact_checksum(ef),
                "delta": ns.sh.decoded_fact_checksum(ed),
                "stats": [(s.full_evals, s.facts_retracted, s.dred_scrubs,
                           s.facts_inferred, s.facts_deleted,
                           s.compensated_deletes) for s in dstats],
                "flushes": flushes(ed) if shards > 1 else None}
    got, want = twins(backend, run)
    assert got["full"] == got["delta"]
    assert all(s[0] == 0 for s in got["stats"])
    assert sum(s[1] for s in got["stats"]) > 0
    assert all(s[2] == 0 for s in got["stats"])
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_lazy_active_set_parity_sharded(backend):
    def run(ns, make_cfg):
        m = ns.core
        out = {}
        for shards in (1, 4):
            e = m.HiperfactEngine(make_cfg(shards, lazy=True))
            e.add_rule(m.Rule("used", (m.cond("A", "?x", "p", "?y"),
                                       m.cond("M", "?y", "m", "?z")),
                              (m.AddAction("B", m.term("?x"), "q",
                                           m.term("?z")),)))
            e.add_rule(m.Rule("unused", (m.cond("A", "?x", "p", "?y"),
                                         m.cond("M", "?y", "m", "?z")),
                              (m.AddAction("C", m.term("?x"), "r",
                                           m.term("?z")),)))
            e.add_rule(m.Rule("q", (m.cond("B", "?x", "q", "?z"),)))
            e.insert_facts([m.Fact("A", f"a{i}", "p", f"k{i % 5}")
                            for i in range(20)]
                           + [m.Fact("M", f"k{j}", "m", f"v{j}")
                              for j in range(5)])
            s = e.infer()
            assert s.rules_skipped_inactive > 0, shards
            out[shards] = (ns.sh.decoded_fact_checksum(e),
                           s.rules_skipped_inactive, s.facts_inferred)
            if shards == 4:
                assert not e.query([m.cond("C", "?x", "r", "?z")])
                out["flushes"] = flushes(e)
        return out
    got, want = twins(backend, run)
    assert got[1][0] == got[4][0]
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_compensated_delete_keeps_view_copies(backend):
    def build(ns, make_cfg, shards):
        m = ns.core
        e = m.HiperfactEngine(make_cfg(shards, eval_mode="delta"))
        e.add_rule(m.Rule("mk", (m.cond("Src", "?x", "is", "?v"),
                                 m.cond("Key", "?v", "ok", "?k")),
                          (m.AddAction("Out", m.term("?x"), "is",
                                       m.term("?v")),)))
        e.insert_facts([m.Fact("Src", f"x{i}", "is", f"v{i % 3}")
                        for i in range(12)]
                       + [m.Fact("Key", f"v{j}", "ok", f"k{j}")
                          for j in range(3)]
                       + [m.Fact("Out", f"x{i}", "is", f"v{i % 3}")
                          for i in range(6)])
        e.infer()
        e.delete_facts([m.Fact("Out", f"x{i}", "is", f"v{i % 3}")
                        for i in range(6)])
        return e, e.infer()

    def run(ns, make_cfg):
        (e1, s1), (e4, s4) = build(ns, make_cfg, 1), build(ns, make_cfg, 4)
        q = [ns.core.cond("Out", "?x", "is", "?v")]
        return (ns.sh.decoded_fact_checksum(e1), s1.compensated_deletes,
                s4.compensated_deletes, s4.full_evals,
                rows_key(e1.query(q)), rows_key(e4.query(q)),
                summary(ns, e4))
    got, want = twins(backend, run)
    assert got[0] == got[6]["checksum"]
    assert got[1] == got[2] == 6
    assert got[3] == 0
    assert got[4] == got[5] and len(got[5]) == 12
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_memo_counts_hits(backend):
    def run(ns, make_cfg):
        m = ns.core
        e = seed_engine(ns, make_cfg, 4)
        e.infer()
        q = [m.cond("Data", "?x", "anc", "?y"),
             m.cond("Data", "?y", "anc", "?z")]
        counts = []
        b = e.query(q, decode=False)
        counts.append((e.last_infer.gather_hits, e.last_infer.gather_misses))
        assert counts[0][1] >= 1
        e.query(q, decode=False)
        counts.append((e.last_infer.gather_hits, e.last_infer.gather_misses))
        assert counts[1] == (counts[0][0] + 1, counts[0][1])
        e.insert_facts([m.Fact("Data", "gm", "anc", "gm2")])
        e.infer()
        e.query(q, decode=False)
        counts.append((e.last_infer.gather_hits, e.last_infer.gather_misses))
        assert counts[2][1] >= 1
        return counts, b.n, rows_key(e.query(q)), summary(ns, e)
    got, want = twins(backend, run)
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_cache_token_survives_compensated_delete(backend):
    def run(ns, make_cfg):
        m = ns.core
        e = m.HiperfactEngine(make_cfg(4, eval_mode="delta"))
        e.add_rule(m.Rule("mk", (m.cond("Src", "?x", "is", "?v"),),
                          (m.AddAction("Out", m.term("?x"), "is",
                                       m.term("?v")),)))
        e.insert_facts([m.Fact("Src", f"x{i}", "is", f"v{i}")
                        for i in range(8)]
                       + [m.Fact("Out", f"x{i}", "is", f"v{i}")
                          for i in range(4)])
        e.infer()
        q = [m.cond("Out", "?x", "is", "?v")]
        r0 = e.query(q)
        hits0 = e.last_infer.query_cache_hits
        e.delete_facts([m.Fact("Out", f"x{i}", "is", f"v{i}")
                        for i in range(4)])
        s = e.infer()
        assert s.compensated_deletes == 4
        assert s.facts_deleted == 0
        r1 = e.query(q)
        assert e.last_infer.query_cache_hits == hits0 + 1
        assert len(r1) == len(r0) == 8
        return rows_key(r1), hits0, summary(ns, e)
    got, want = twins(backend, run)
    assert got == want


# ---------------------------------------------------------------------------
# Beyond the mirror: demand at four shards, a sharded FactServer, the
# launcher


def chain_facts(m, k=3, length=5):
    return [m.Fact("edge", f"c{j}_n{i}", "to", f"c{j}_n{i + 1}")
            for j in range(k) for i in range(length)]


def closure_rules(m):
    return [
        m.Rule("base", (m.cond("edge", "?x", "to", "?y"),),
               (m.AddAction("path", m.term("?x"), "to", m.term("?y")),)),
        m.Rule("rec", (m.cond("edge", "?x", "to", "?y"),
                       m.cond("path", "?y", "to", "?z")),
               (m.AddAction("path", m.term("?x"), "to", m.term("?z")),)),
    ]


DEMAND_COUNTERS = ("demand_rounds", "demand_cone_rows", "demand_fallbacks")


@pytest.mark.parametrize("backend", BACKENDS)
def test_demand_at_four_shards(backend):
    """``eval_mode="demand"`` over four shards: row sets and the demand
    counters equal the reference's, no fallback to ``infer()``, and the
    point query's rows equal the unsharded full closure's."""
    def run(ns, make_cfg):
        m = ns.core
        e = m.HiperfactEngine(make_cfg(4, eval_mode="demand"))
        e.add_rules(closure_rules(m))
        e.insert_facts(chain_facts(m))
        out = []
        for q in ([m.cond("path", "c0_n0", "to", "?z")],
                  [m.cond("path", "?x", "to", "c1_n5")],
                  [m.cond("edge", "?x", "to", "?y"),
                   m.cond("path", "?y", "to", "c2_n5")]):
            rows = rows_key(e.query(q))
            out.append((rows, {k: getattr(e.last_infer, k)
                               for k in DEMAND_COUNTERS}))
        e.insert_facts([m.Fact("edge", "c0_n5", "to", "c0_n6")])
        rows = rows_key(e.query([m.cond("path", "c0_n0", "to", "?z")]))
        out.append((rows, {k: getattr(e.last_infer, k)
                           for k in DEMAND_COUNTERS}))
        return out, flushes(e)
    got, want = twins(backend, run)
    assert got == want
    assert all(c["demand_fallbacks"] == 0 for _, c in got[0])
    full = P.HiperfactEngine(cfg(PORT, backend, 1, eval_mode="full"))
    full.add_rules(closure_rules(P))
    full.insert_facts(chain_facts(P))
    full.infer()
    assert got[0][0][0] == rows_key(
        full.query([P.cond("path", "c0_n0", "to", "?z")]))
    assert len(got[0][3][0]) == len(got[0][0][0]) + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_factserver_matches_unsharded(backend):
    """The numpy mirror of ``tests/test_serve_distributed.py``'s cell: a
    port ``FactServer`` over two shards, one writer and one reader
    racing, every served result equal to a reference numpy replay of the
    write prefix its token names."""
    from repro_torch.serve import FactServer

    def build(ns, make_cfg, shards):
        m = ns.core
        e = m.HiperfactEngine(make_cfg(shards, eval_mode="delta"))
        e.add_rules(closure_rules(m))
        e.insert_facts(chain_facts(m, k=3, length=4))
        e.infer()
        return e

    def port_cfg(shards, **kw):
        return dataclasses.replace(P.EngineConfig.infer1(backend),
                                   shards=shards, **kw)

    def ref_cfg(shards, **kw):
        return dataclasses.replace(R.EngineConfig.infer1("numpy"),
                                   shards=shards, **kw)

    extra = [(f"c0_n{4 + i}", f"c0_n{5 + i}") for i in range(4)]
    with FactServer(build(PORT, port_cfg, 2), batching=False,
                    record_history=True) as srv:
        assert isinstance(srv.engine, P_sharded.ShardedEngine)
        served = []
        q = [P.cond("path", "c0_n0", "to", "?z")]

        def writer():
            for a, b in extra:
                srv.append([P.Fact("edge", a, "to", b)])

        def reader():
            for _ in range(8):
                served.append(srv.serve(q))
        ts = [threading.Thread(target=writer),
              threading.Thread(target=reader)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        known = {tok for _, _, tok in srv.history}
        assert all(r.token in known for r in served), "torn read"
        final = srv.serve(q)
        history = list(srv.history)

    rq = [R.cond("path", "c0_n0", "to", "?z")]
    ref = build(REF, ref_cfg, 1)
    ref.insert_facts([R.Fact("edge", a, "to", b) for a, b in extra])
    ref.infer()
    key = lambda rows: sorted(tuple(sorted(r.items())) for r in rows)
    assert key(final.rows) == key(ref.query(rq))
    o = build(REF, ref_cfg, 1)
    by_token = {}
    for kind, facts, tok in history:
        if facts:
            rfacts = [R.Fact(f.fact_type, f.id, f.attr, f.val,
                             R.ValueType(int(f.valtype))) for f in facts]
            (o.insert_facts if kind == "append" else o.delete_facts)(rfacts)
            o.infer()
        by_token[tok] = key(o.query(rq))
    for r in served:
        assert key(r.rows) == by_token[r.token], r.token


def test_serve_launcher_runs_four_shards(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --backend torch-cpu --shards
    4`` serves its reads over a four-shard engine."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--backend", "torch-cpu", "--shards", "4", "--chains",
        "3", "--hops", "4", "--writers", "1", "--readers", "2",
        "--write-ops", "2", "--reads", "4"])
    serve.main()
    assert "served 8 reads in" in capsys.readouterr().out
