"""The port's ``FactServer`` over ``torch-cpu`` vs the reference.

Every numpy cell of ``tests/test_serving.py`` at one shard, run on the
port's serving tier: a served result must equal what the reference
engine on ``backend="numpy"`` gives after replaying exactly the write
prefix named by the result's token, and ``ServedResult.checksum()`` must
equal the reference server's for the same rows.  Port-only: a lock-free
batched probe that raises while a write moves the epoch (a half-swapped
index) is retried, not returned as an error.
"""

import dataclasses
import functools
import random
import threading
import time

import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.serve import FactServer as RefServer
from repro.serve import project_token as ref_project_token
from repro_torch.serve import FactServer, ServedResult, project_token

K_CHAINS, CHAIN_LEN = 3, 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain_facts(m, k=K_CHAINS, length=CHAIN_LEN):
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


def path_q(m):
    # single-condition point query: batch-eligible (rank-1 probe)
    return [m.cond("path", "c0_n0", "to", "?z")]


def join_q(m):
    # two conditions: always the evaluation path (tracked delta nodes)
    return [m.cond("edge", "?x", "to", "?y"), m.cond("path", "?y", "to", "?z")]


def edge_q(m, j=0):
    return [m.cond("edge", f"c{j}_n0", "to", "?y")]


def extra_edge(m):
    return m.Fact("edge", f"c0_n{CHAIN_LEN}", "to", f"c0_n{CHAIN_LEN + 1}")


def _cfg(m, backend, preset="infer1", **kw):
    return dataclasses.replace(getattr(m.EngineConfig, preset)(backend),
                               **kw)


def _build(m, backend, mode="delta", preset="infer1"):
    e = m.HiperfactEngine(_cfg(m, backend, preset, eval_mode=mode))
    e.add_rules(closure_rules(m))
    e.insert_facts(chain_facts(m))
    if mode != "demand":
        e.infer()
    return e


def _engine(mode="delta", preset="infer1"):
    return _build(P, "torch-cpu", mode, preset)


def _ref_engine(mode="delta", preset="infer1"):
    return _build(R, "numpy", mode, preset)


def rows_key(rows):
    return tuple(sorted(tuple(sorted(r.items())) for r in rows))


def to_ref(facts):
    return [R.Fact(f.fact_type, f.id, f.attr, f.val) for f in facts]


QUERIES = {"path": path_q, "join": join_q, "edge": edge_q,
           **{f"edge{j}": functools.partial(edge_q, j=j)
              for j in range(K_CHAINS)}}


def _oracle_replay(history, names):
    """Walk a server history once on a reference full engine and evaluate
    the named queries at every distinct token: ``{(token, name):
    rows_key}``.  A token maps to the *last* entry bearing it."""
    last_idx = {tok: i for i, (_, _, tok) in enumerate(history)}
    oracle = _ref_engine("full")
    out = {}
    for i, (kind, facts, tok) in enumerate(history):
        if facts:
            if kind == "append":
                oracle.insert_facts(to_ref(facts))
            elif kind == "delete":
                oracle.delete_facts(to_ref(facts))
            oracle.infer()
        if last_idx[tok] == i:
            for name in names:
                out[(tok, name)] = rows_key(oracle.query(QUERIES[name](R)))
    return out


# ---------------------------------------------------------------------------
# Basic serving semantics (single-threaded)


def test_serve_matches_engine_and_pins_token():
    with FactServer(_engine(), batching=False) as srv, \
            RefServer(_ref_engine(), batching=False) as rsrv:
        res, rres = srv.serve(path_q(P)), rsrv.serve(path_q(R))
        assert res.token == srv.snapshot_token() == rres.token
        assert rows_key(res.rows) == rows_key(srv.engine.query(path_q(P)))
        assert res.checksum() == rres.checksum()
        assert res.mode == rres.mode == "full"
        again = srv.serve(path_q(P))
        assert again.mode == "cache"
        assert again.checksum() == res.checksum()
        srv.append([extra_edge(P)])
        rsrv.append([extra_edge(R)])
        moved, rmoved = srv.serve(path_q(P)), rsrv.serve(path_q(R))
        assert moved.token != res.token
        assert moved.mode == rmoved.mode == "delta"
        assert len(moved.rows) == len(res.rows) + 1
        assert moved.checksum() == rmoved.checksum()
        st = srv.stats()
        assert st["served"]["full"] == 1 and st["served"]["delta"] == 1
        assert st["requery"] == rsrv.stats()["requery"]
        assert st["requery"]["full_evals"] == 1


def test_project_token_restricts_to_types():
    with FactServer(_engine(), batching=False) as srv:
        tok = srv.snapshot_token()
        sub = project_token(tok, ["path"])
        assert sub and all(e[0] == "path" for e in sub)
        assert sub == srv.engine._query_version_token(["path"])
        assert sub == ref_project_token(tok, ["path"])
        assert project_token(tok, ["path", "edge"]) == tok


def test_checksum_equals_reference_for_the_same_rows():
    rows = [{"z": "c0_n2", "y": 3}, {"z": "c0_n1", "y": -1.5}, {"z": "ä"}]
    ours = ServedResult(rows, (), "full")
    from repro.serve import ServedResult as RefResult
    assert ours.checksum() == RefResult(list(reversed(rows)), (),
                                        "cache").checksum()


def test_delete_served_results_track_tombstones():
    with FactServer(_engine(), batching=False) as srv:
        before = srv.serve(path_q(P))
        srv.delete([P.Fact("edge", "c0_n0", "to", "c0_n1")])
        after = srv.serve(path_q(P))
        assert after.token != before.token
        assert after.rows == []
        oracle = R.HiperfactEngine(_cfg(R, "numpy", eval_mode="full"))
        oracle.add_rules(closure_rules(R))
        oracle.insert_facts(chain_facts(R)[1:])
        oracle.infer()
        assert rows_key(after.rows) == rows_key(oracle.query(path_q(R)))


# ---------------------------------------------------------------------------
# Torn-read detectors: a read racing a paused (mid-flight) write blocks
# or retries, and never observes the half-written frontier.


@pytest.mark.serving_stress
def test_paused_write_blocks_readers_no_torn_state():
    with FactServer(_engine(), batching=False, record_history=True) as srv:
        pre = srv.snapshot_token()
        results = []
        done = threading.Event()

        def read():
            results.append(srv.serve(path_q(P)))
            done.set()

        with srv._paused_write() as eng:
            eng.insert_facts([extra_edge(P)])
            t = threading.Thread(target=read)
            t.start()
            assert not done.wait(0.10), "reader returned mid-write"
            eng.infer()
        t.join(timeout=30)
        assert done.is_set()
        res = results[0]
        assert res.token != pre
        assert res.token == srv.snapshot_token()
        assert len(res.rows) == CHAIN_LEN + 1
        oracle = _oracle_replay(
            [("init", None, pre), ("append", [extra_edge(P)], res.token)],
            ["path"])
        assert rows_key(res.rows) == oracle[(res.token, "path")]


@pytest.mark.serving_stress
@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_paused_write_blocks_batched_probes(preset):
    with FactServer(_engine(preset=preset), batch_window=0.001,
                    record_history=True) as srv:
        q = edge_q(P)
        results = []
        done = threading.Event()

        def read():
            results.append(srv.serve(q))
            done.set()

        with srv._paused_write() as eng:
            eng.insert_facts([P.Fact("edge", "c0_n0", "to", "c0_extra")])
            t = threading.Thread(target=read)
            t.start()
            assert not done.wait(0.10), "batched probe returned mid-write"
            eng.infer()
        t.join(timeout=30)
        assert done.is_set()
        res = results[0]
        assert res.mode == "batched"
        assert rows_key(res.rows) == rows_key(srv.engine.query(q))
        assert len(res.rows) == 2


@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_torn_batched_probe_is_retried(preset):
    """A lock-free probe that raises because a write moved the epoch under
    it (here: a paused write lands, then the probe fails as a torn index
    read would) is retried at the new frontier; one that raises at a
    stable epoch reaches the caller."""
    with FactServer(_engine(preset=preset), batch_window=None,
                    record_history=True) as srv:
        store = srv.engine.store
        real = store.lookup_many
        calls = []

        def torn_once(*a, **k):
            calls.append(srv._epoch)
            if len(calls) == 1:
                with srv._paused_write() as eng:
                    eng.insert_facts([P.Fact("edge", "c0_n0", "to",
                                             "c0_extra")])
                    eng.infer()
                raise IndexError("half-swapped index")
            return real(*a, **k)

        store.lookup_many = torn_once
        out = []
        t = threading.Thread(target=lambda: out.append(srv.serve(edge_q(P))))
        t.start()
        deadline = time.time() + 10
        while srv._batcher.queued() < 1:
            assert time.time() < deadline, "request never queued"
            time.sleep(0.001)
        assert srv.flush_batches() == 1
        t.join(timeout=30)
        (res,) = out
        assert len(calls) == 2 and calls[1] == calls[0] + 2
        assert srv.stats()["batch"]["torn_retries"] == 1
        assert res.token == srv.snapshot_token()
        assert rows_key(res.rows) == rows_key(srv.engine.query(edge_q(P)))
        assert len(res.rows) == 2

        def broken(*a, **k):
            raise IndexError("not a torn read")

        store.lookup_many = broken
        errs = []

        def read():
            try:
                srv.serve(edge_q(P, 1))
            except IndexError as exc:
                errs.append(exc)

        t = threading.Thread(target=read)
        t.start()
        deadline = time.time() + 10
        while srv._batcher.queued() < 1:
            assert time.time() < deadline, "request never queued"
            time.sleep(0.001)
        srv.flush_batches()
        t.join(timeout=30)
        assert len(errs) == 1 and srv.stats()["batch"]["torn_retries"] == 1


def test_torn_retry_takes_only_index_errors():
    """Only what a half-swapped mirror/permutation pair raises
    (``IndexError``, ``ValueError``) is retried as a torn read: any other
    error reaches the caller even when a write moved the epoch under it."""
    with FactServer(_engine(preset="query1"), batch_window=None,
                    record_history=True) as srv:
        calls = []

        def moved_then_broken(*a, **k):
            calls.append(srv._epoch)
            with srv._paused_write() as eng:
                eng.insert_facts([P.Fact("edge", "c0_n0", "to",
                                         f"c0_x{len(calls)}")])
                eng.infer()
            raise RuntimeError("not a torn read")

        srv.engine.store.lookup_many = moved_then_broken
        errs = []

        def read():
            try:
                srv.serve(edge_q(P))
            except RuntimeError as exc:
                errs.append(exc)

        t = threading.Thread(target=read)
        t.start()
        deadline = time.time() + 10
        while srv._batcher.queued() < 1:
            assert time.time() < deadline, "request never queued"
            time.sleep(0.001)
        srv.flush_batches()
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(errs) == 1 and len(calls) == 1
        assert srv.stats()["batch"]["torn_retries"] == 0


# ---------------------------------------------------------------------------
# The headline stress: concurrent writers and readers, every served
# result equal to the reference oracle at its snapshot token.


@pytest.mark.serving_stress
def test_concurrent_stress_matches_frozen_snapshot_oracle():
    n_writers, n_readers, writes_each, reads_each = 2, 4, 25, 40
    with FactServer(_engine("delta"), batch_window=0.001,
                    record_history=True) as srv:
        served = []
        served_lock = threading.Lock()
        errors = []

        def writer(w):
            try:
                appended = []
                for i in range(writes_each):
                    if w == 0 and i % 5 == 4 and appended:
                        srv.delete([appended.pop(0)])
                    else:
                        f = P.Fact("edge", f"w{w}_m{i}", "to",
                                   f"w{w}_m{i + 1}")
                        srv.append([f])
                        appended.append(f)
            except Exception as exc:  # noqa: BLE001 - surfaced below
                errors.append(exc)

        def reader(r):
            try:
                for i in range(reads_each):
                    name = "path" if i % 2 else "join"
                    res = srv.serve(QUERIES[name](P), tenant=f"t{r}")
                    with served_lock:
                        served.append((name, res))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = ([threading.Thread(target=writer, args=(w,))
                    for w in range(n_writers)] +
                   [threading.Thread(target=reader, args=(r,))
                    for r in range(n_readers)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(served) == n_readers * reads_each
        assert n_writers * writes_each + len(served) >= 200

        history = srv.history
        known = {tok for _, _, tok in history}
        torn = [res.token for _, res in served if res.token not in known]
        assert not torn, f"torn reads: tokens outside history: {torn[:3]}"

        oracle = _oracle_replay(history, ["path", "join"])
        for name, res in served:
            assert rows_key(res.rows) == oracle[(res.token, name)], (
                name, res.mode, res.token)

        st = srv.stats()
        assert sum(st["served"].values()) == len(served)
        assert st["requery"]["delta_folds"] > 0


@pytest.mark.serving_stress
def test_batched_probes_race_appends_on_ai_index():
    """Batched point queries on ``query1``'s AI index race appends, which
    swap the index's sorted mirror and permutation one after the other:
    ten threads, a shortened switch interval, and every read equal to
    the reference oracle at its token (a torn probe retries; it neither
    raises nor returns rows from two frontiers)."""
    import sys

    n_writers, n_readers, writes_each, reads_each = 2, 8, 10, 12
    qs = [edge_q(P, j) for j in range(K_CHAINS)] + [path_q(P)]
    names = ["edge0", "edge1", "edge2", "path"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with FactServer(_engine("delta", preset="query1"),
                        batch_window=0.0005, record_history=True) as srv:
            served, errors = [], []
            lock = threading.Lock()

            def writer(w):
                try:
                    for i in range(writes_each):
                        srv.append([P.Fact("edge", f"c{i % K_CHAINS}_n0",
                                           "to", f"w{w}_m{i}")])
                except Exception as exc:  # noqa: BLE001 - asserted below
                    errors.append(exc)

            def reader(r):
                try:
                    for i in range(reads_each):
                        k = (r + i) % len(qs)
                        res = srv.serve(qs[k], tenant=f"t{r % 3}")
                        with lock:
                            served.append((names[k], res))
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)

            threads = ([threading.Thread(target=writer, args=(w,))
                        for w in range(n_writers)]
                       + [threading.Thread(target=reader, args=(r,))
                          for r in range(n_readers)])
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            history = srv.history
            batched = srv.stats()["served"]["batched"]
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(served) == n_readers * reads_each == batched
    oracle = _oracle_replay(history, names)
    for name, res in served:
        assert rows_key(res.rows) == oracle[(res.token, name)], (
            name, res.token)


# ---------------------------------------------------------------------------
# Seeded interleavings of append / delete / query, each read held
# against a reference delta engine stepped in lockstep (counting
# semantics: a compensated delete keeps the token unmoved).


@pytest.mark.serving_stress
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_property_random_interleavings_match_oracle(seed):
    rng = random.Random(seed)
    srv = FactServer(_engine("delta"), batching=False, record_history=True)
    oracle = _ref_engine("delta")
    live, redundant = [], []
    compensated_checked = 0
    with srv:
        for step in range(60):
            op = rng.choice(["append", "append", "delete", "redundant",
                             "comp-delete", "query", "query"])
            if op == "append":
                f = (f"s{seed}_m{step}", f"s{seed}_m{step + 1}")
                srv.append([P.Fact("edge", f[0], "to", f[1])])
                oracle.insert_facts([R.Fact("edge", f[0], "to", f[1])])
                oracle.infer()
                live.append(f)
            elif op == "delete" and live:
                f = live.pop(rng.randrange(len(live)))
                srv.delete([P.Fact("edge", f[0], "to", f[1])])
                oracle.delete_facts([R.Fact("edge", f[0], "to", f[1])])
                oracle.infer()
            elif op == "redundant":
                # assert a fact the base rule already derives
                i = rng.randrange(CHAIN_LEN)
                f = (f"c0_n{i}", f"c0_n{i + 1}")
                srv.append([P.Fact("path", f[0], "to", f[1])])
                oracle.insert_facts([R.Fact("path", f[0], "to", f[1])])
                oracle.infer()
                redundant.append(f)
            elif op == "comp-delete" and redundant:
                f = redundant.pop()
                before = srv.snapshot_token()
                srv.delete([P.Fact("path", f[0], "to", f[1])], infer=False)
                oracle.delete_facts([R.Fact("path", f[0], "to", f[1])])
                assert srv.snapshot_token() == before
                compensated_checked += 1
            else:
                name = rng.choice(["path", "join", "edge1"])
                qp, qr = ((edge_q(P, 1), edge_q(R, 1)) if name == "edge1"
                          else (QUERIES[name](P), QUERIES[name](R)))
                res = srv.serve(qp)
                assert rows_key(res.rows) == rows_key(oracle.query(qr)), (
                    seed, step, res.mode)
    assert compensated_checked > 0, "schedule never hit the compensated path"


# ---------------------------------------------------------------------------
# Requery parity across eval modes as the watermark moves


@pytest.mark.parametrize("mode", ["full", "delta", "demand"])
def test_served_requery_parity_matrix(mode):
    steps = [("append", [extra_edge(P)]), ("delete", [extra_edge(P)])]
    oracle_rows = []
    for prefix in range(len(steps) + 1):
        e = _ref_engine("full")
        for kind, facts in steps[:prefix]:
            (e.insert_facts if kind == "append"
             else e.delete_facts)(to_ref(facts))
            e.infer()
        oracle_rows.append(rows_key(e.query(path_q(R))))
    expect = [oracle_rows[0], oracle_rows[1], oracle_rows[1],
              oracle_rows[2], oracle_rows[2]]

    with FactServer(_engine(mode), batching=False) as srv, \
            RefServer(_ref_engine(mode), batching=False) as rsrv:
        got, sums, rsums = [], [], []
        for i in range(len(steps) + 1):
            if i:
                kind, facts = steps[i - 1]
                (srv.append if kind == "append" else srv.delete)(facts)
                (rsrv.append if kind == "append"
                 else rsrv.delete)(to_ref(facts))
            for _ in range(1 if i == 0 else 2):   # repeat: cached
                res, rres = srv.serve(path_q(P)), rsrv.serve(path_q(R))
                got.append(rows_key(res.rows))
                sums.append((res.checksum(), res.mode))
                rsums.append((rres.checksum(), rres.mode))
        st = srv.stats()["requery"]
        assert st == rsrv.stats()["requery"]
    assert got == expect
    assert sums == rsums
    if mode == "delta":
        assert st["full_evals"] <= 1
        assert st["delta_folds"] > 0


@pytest.mark.parametrize("mode", ["full", "delta", "demand"])
def test_served_engine_with_shards_raises_naming_a9(mode):
    """The sharded engine is ported (ROADMAP A9): a ``FactServer`` over
    two shards serves the point query the reference's two-shard numpy
    engine answers, before and after an append."""
    def build(m, backend):
        e = m.HiperfactEngine(_cfg(m, backend, eval_mode=mode, shards=2))
        e.add_rules(closure_rules(m))
        e.insert_facts(chain_facts(m))
        if mode != "demand":
            e.infer()
        return e
    with FactServer(build(P, "torch-cpu"), batching=False) as srv, \
            RefServer(build(R, "numpy"), batching=False) as rsrv:
        assert len(srv.engine.workers) == 2
        for step in range(2):
            if step:
                srv.append([extra_edge(P)])
                rsrv.append(to_ref([extra_edge(P)]))
            res, rres = srv.serve(path_q(P)), rsrv.serve(path_q(R))
            assert rows_key(res.rows) == rows_key(rres.rows)
            assert res.checksum() == rres.checksum()


# ---------------------------------------------------------------------------
# Cross-request batching: coalescing, correctness, tenant fairness


@pytest.mark.serving_stress
@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_batch_manual_flush_coalesces_one_device_call(preset):
    with FactServer(_engine(preset=preset), batch_window=None,
                    max_batch=8) as srv:
        ops = srv.engine.ops
        probes = []
        real = ops.batch_probe

        def counted(*a, **k):
            probes.append(len(a[1]))
            return real(*a, **k)

        ops.batch_probe = counted
        qs = [edge_q(P, j) for j in range(3)] * 2
        results = [None] * len(qs)

        def run(i):
            results[i] = srv.serve(qs[i], tenant=f"t{i % 3}")

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(qs))]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while srv._batcher.queued() < len(qs):
            assert time.time() < deadline, "requests never queued"
            time.sleep(0.001)
        flushed = srv.flush_batches()
        for t in threads:
            t.join(timeout=30)
        assert flushed == len(qs)
        st = srv.stats()["batch"]
        assert st["device_calls"] == 1
        assert st["batched_queries"] == len(qs)
        assert st["coalesce_p50"] >= 2
        # the AI index resolves the whole wave in one batch_probe over
        # the three distinct anchors; LPIM probes on the host
        assert probes == ([3] if preset == "query1" else [])
        r = _ref_engine(preset=preset)
        for j, (q, res) in enumerate(zip(qs, results)):
            assert res.mode == "batched"
            assert rows_key(res.rows) == rows_key(srv.engine.query(q))
            assert rows_key(res.rows) == rows_key(r.query(edge_q(R, j % 3)))


@pytest.mark.serving_stress
def test_batch_tenant_round_robin_fairness():
    with FactServer(_engine(), batch_window=None, max_batch=4) as srv:
        q = edge_q(P)
        n_a, n_b = 4, 1
        threads = [threading.Thread(target=srv.serve, args=(q, "a"))
                   for _ in range(n_a)]
        threads += [threading.Thread(target=srv.serve, args=(q, "b"))]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while srv._batcher.queued() < n_a + n_b:
            assert time.time() < deadline
            time.sleep(0.001)
        wave = srv._batcher._take_wave()
        (bucket, reqs), = wave.items()
        # the minority tenant is admitted in the first wave
        assert {r.tenant for r in reqs} == {"a", "b"}
        assert len(reqs) == 4
        srv._batcher._run_bucket(bucket, reqs)
        srv.flush_batches()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)


@pytest.mark.serving_stress
def test_batch_background_window_serves_all_tenants():
    with FactServer(_engine(), batch_window=0.01, max_batch=3) as srv:
        q = path_q(P)
        results = []
        lock = threading.Lock()

        def run(i):
            res = srv.serve(q, tenant=f"t{i % 3}")
            with lock:
                results.append(res)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 7
        ref = rows_key(_ref_engine().query(path_q(R)))
        assert all(rows_key(r.rows) == ref for r in results)
        st = srv.stats()["batch"]
        assert st["batched_queries"] == 7
        assert st["device_calls"] >= 1


# ---------------------------------------------------------------------------
# Repeatability: identical single-threaded serve sequences give identical
# checksums, run to run and against the reference server


def _sequence(m, server_cls, engine):
    with server_cls(engine, batching=False) as srv:
        out = [srv.serve(path_q(m)).checksum(),
               srv.serve(join_q(m)).checksum()]
        srv.append([extra_edge(m)])
        out += [srv.serve(path_q(m)).checksum(),
                srv.serve(join_q(m)).checksum()]
        srv.delete([m.Fact("edge", "c1_n0", "to", "c1_n1")])
        out += [srv.serve(path_q(m)).checksum(),
                srv.serve(join_q(m)).checksum()]
        return out


def test_serve_sequence_is_deterministic():
    first = _sequence(P, FactServer, _engine("delta"))
    assert first == _sequence(P, FactServer, _engine("delta"))
    assert first == _sequence(R, RefServer, _ref_engine("delta"))
