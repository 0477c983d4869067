"""The port's distributed primitives vs the reference, on the CPU.

* ``FrontierExchange`` over repeated CPU devices (the port's device
  transport: upload, ``bucket_scatter`` per lane, the slot permute,
  download) against the reference's ``shard_map`` + ``lax.all_to_all``
  transport on forced host devices: the received lanes of every
  destination (values, dtypes, order) and the stats dict are identical,
  with the lane compression on and off.  The reference's device count
  locks at its first JAX call, so those cases run in a child process
  (the ``subproc`` fixture).
* ``DistributedClosure`` over eight CPU devices against the reference's
  over a 2 × 4 mesh: the same pairs in the same number of iterations.
* ``_owner`` (the device twin of ``shard_of``) for negative keys and
  non-power-of-two shard counts, the in-shard primitives against the
  reference's on the same inputs, and ``bucket_scatter``'s overflow
  count.
* A port ``ShardedEngine`` on ``torch-cpu`` whose exchange takes the
  device transport over four CPU devices: the numpy checksum, and the
  reference's flushes when its exchange is the ``shard_map`` one.
* The port's ``ReteEngine`` against the reference's on the rule sets of
  ``tests/test_engine.py``.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax x64 for the reference)
import repro.core.distributed as RD
import repro_torch.core.distributed as PD
from repro.core.sharded import shard_of as ref_shard_of

EXCHANGE_CHILD = """
import numpy as np, torch
from repro.distributed.pipeline import FrontierExchange as RefExchange
from repro_torch.distributed.pipeline import FrontierExchange

n, compress = {n}, {compress}
rng = np.random.RandomState({seed})
rounds = 0
for size in (0, 1, 7, 60, 300):
    # some sources send nothing; destinations skewed towards shard 0
    dest = [rng.choice(n, rng.randint(0, size + 1) if s % 3 else size,
                       p=np.r_[0.5, np.full(n - 1, 0.5 / (n - 1))]
                       ).astype(np.int32) for s in range(n)]
    key = [(rng.randint(0, 1 << 20, len(d)).astype(np.int64) << 32)
           | rng.randint(0, 40, len(d)) for d in dest]
    val = [rng.randint(-(1 << 62), 1 << 62, len(d)).astype(np.int64)
           if size % 2 else rng.randint(-5, 100, len(d)).astype(np.int64)
           for d in dest]
    meta = [rng.randint(0, 1 << 24, len(d)).astype(np.int64) for d in dest]
    ref = RefExchange(n, prefer_device=True, compress=compress)
    port = FrontierExchange(n, compress=compress,
                            devices=[torch.device("cpu")] * n)
    assert ref.device and port.device
    want, ws = ref.exchange(dest, key, val, meta)
    got, gs = port.exchange(dest, key, val, meta)
    assert gs == ws, (gs, ws)
    for d in range(n):
        for a, b in zip(got[d], want[d]):
            assert a.dtype == b.dtype and np.array_equal(a, b), (d, a, b)
    rounds += 1
print("exchange ok", n, compress, rounds)
"""


@pytest.mark.parametrize("compress", [False, True])
def test_exchange_matches_reference_shard_map(subproc, compress):
    out = subproc(EXCHANGE_CHILD.format(n=8, compress=compress, seed=5),
                  n_devices=8)
    assert "exchange ok 8" in out


CLOSURE_CHILD = """
import numpy as np, jax, torch
from jax.sharding import Mesh
from repro.core.distributed import ClosureConfig as RefConfig
from repro.core.distributed import DistributedClosure as RefClosure
from repro_torch.core.distributed import ClosureConfig, DistributedClosure

caps = dict(edge_cap=1 << 12, delta_cap=1 << 10, slot_cap=1 << 8,
            join_cap=1 << 12)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
for seed in (0, 1):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, 30, 60)
    dst = rng.randint(0, 30, 60)
    want, wi = RefClosure(mesh, RefConfig(**caps)).run(src, dst)
    got, gi = DistributedClosure([torch.device("cpu")] * 8,
                                 ClosureConfig(**caps)).run(src, dst)
    assert gi == wi and np.array_equal(got, want), (gi, wi)
    # the host oracle
    pairs = set(zip(src.tolist(), dst.tolist()))
    while True:
        more = {(a, d) for a, b in pairs for c, d in pairs if b == c}
        if more <= pairs:
            break
        pairs |= more
    assert sorted(got.tolist()) == sorted((a << 32) | b for a, b in pairs)
print("closure ok", len(got), gi)
"""


def test_closure_matches_reference_mesh(subproc):
    out = subproc(CLOSURE_CHILD, n_devices=8)
    assert "closure ok" in out


def test_closure_overflow_raises():
    """A slot capacity too small for the round's frontier trips the
    overflow count, which the host loop turns into an error."""
    src = np.arange(0, 200)
    dst = src + 1
    dc = PD.DistributedClosure(["cpu"] * 2, PD.ClosureConfig(
        edge_cap=1 << 10, delta_cap=1 << 8, slot_cap=4, join_cap=1 << 10))
    with pytest.raises(RuntimeError, match="capacity overflow"):
        dc.run(src, dst)


# ---------------------------------------------------------------------------
# In-shard primitives


@pytest.mark.parametrize("n_dev", [3, 4, 7, 8])
def test_owner_matches_shard_of(n_dev):
    rng = np.random.RandomState(n_dev)
    keys = np.r_[rng.randint(-(1 << 63), (1 << 63) - 1, 4000,
                             dtype=np.int64),
                 np.array([0, 1, -1, -2, -(1 << 63), (1 << 63) - 1],
                          np.int64)]
    got = PD._owner(torch.from_numpy(keys), n_dev).numpy()
    np.testing.assert_array_equal(got, ref_shard_of(keys, n_dev))
    want = np.asarray(RD._owner(RD.jnp.asarray(keys), n_dev))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PD._mix64(torch.from_numpy(keys)).numpy(),
        np.asarray(RD._mix64(RD.jnp.asarray(keys))))


@pytest.mark.parametrize("slot_cap", [2, 5, 64])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
def test_bucket_scatter_matches_reference_and_counts_overflow(slot_cap,
                                                              dtype):
    rng = np.random.RandomState(slot_cap)
    n, n_dev = 50, 4
    dest = rng.randint(0, n_dev, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    payload = rng.randint(-100, 100, n).astype(dtype)
    sentinel = int(np.iinfo(dtype).max)
    buf, ovf = PD.bucket_scatter(torch.from_numpy(dest),
                                 torch.from_numpy(payload), n_dev, slot_cap,
                                 torch.from_numpy(valid), sentinel=sentinel)
    wbuf, wovf = RD.bucket_scatter(RD.jnp.asarray(dest),
                                   RD.jnp.asarray(payload), n_dev, slot_cap,
                                   RD.jnp.asarray(valid), sentinel=sentinel)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(wbuf))
    counts = np.bincount(dest[valid], minlength=n_dev)
    assert int(ovf) == int(wovf) == int(np.maximum(counts - slot_cap,
                                                   0).sum())
    # each bucket keeps its rows in arrival order
    for d in range(n_dev):
        keep = payload[valid & (dest == d)][:slot_cap]
        got = buf.numpy()[d * slot_cap:(d + 1) * slot_cap]
        np.testing.assert_array_equal(got[:len(keep)], keep)
        assert (got[len(keep):] == sentinel).all()


def test_join_merge_and_compact_match_reference():
    rng = np.random.RandomState(11)
    S = PD.SENTINEL
    r_sorted = np.sort(np.r_[rng.randint(0, 40, 90), [S] * 6]).astype(
        np.int64)
    r_pay = rng.randint(0, 1 << 40, len(r_sorted)).astype(np.int64)
    l_key = np.r_[rng.randint(0, 50, 30), [S] * 4].astype(np.int64)
    l_pay = rng.randint(0, 1 << 40, len(l_key)).astype(np.int64)
    for cap in (8, 64, 512):
        got = PD.join_expand_bounded(*map(torch.from_numpy,
                                          (l_key, l_pay, r_sorted, r_pay)),
                                     cap)
        want = RD.join_expand_bounded(*map(RD.jnp.asarray,
                                           (l_key, l_pay, r_sorted, r_pay)),
                                      cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    store = np.sort(np.r_[rng.choice(1000, 60, replace=False),
                          [S] * 20]).astype(np.int64)
    new = np.r_[rng.randint(0, 1000, 40), [S] * 8].astype(np.int64)
    got = PD.merge_unique(torch.from_numpy(store), torch.from_numpy(new))
    want = RD.merge_unique(RD.jnp.asarray(store), RD.jnp.asarray(new))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    a, b = (np.sort(rng.randint(0, 30, k)).astype(np.int64)
            for k in (17, 23))
    np.testing.assert_array_equal(
        PD.merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(RD.merge_sorted(RD.jnp.asarray(a), RD.jnp.asarray(b))))
    vals = np.sort(rng.randint(0, 100, 40)).astype(np.int64)
    mask = rng.rand(40) > 0.5
    for cap in (5, 40):
        np.testing.assert_array_equal(
            PD.compact_masked(torch.from_numpy(vals), torch.from_numpy(mask),
                              cap, -7).numpy(),
            np.asarray(RD.compact_masked(RD.jnp.asarray(vals),
                                         RD.jnp.asarray(mask), cap, -7)))
    p = PD.pack_pair(torch.tensor([3, -1, 1 << 30], dtype=torch.int32),
                     torch.tensor([-5, 7, 0], dtype=torch.int32))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(RD.pack_pair(RD.jnp.asarray([3, -1, 1 << 30],
                                                          RD.jnp.int32),
                                           RD.jnp.asarray([-5, 7, 0],
                                                          RD.jnp.int32))))
    x, y = PD.unpack_pair(p)
    assert x.tolist() == [3, -1, 1 << 30] and y.tolist() == [-5, 7, 0]


# ---------------------------------------------------------------------------
# The sharded engine on the device transport over CPU devices


ENGINE_CHILD = """
import dataclasses, random, torch
import repro.core as R
import repro_torch.core as P
from repro.core.rulesets import rdfs_plus_rules as ref_rules
from repro.core.sharded import decoded_fact_checksum as ref_checksum
from repro.distributed.pipeline import FrontierExchange as RefExchange
from repro_torch.core.rulesets import rdfs_plus_rules
from repro_torch.core.sharded import ShardedEngine, decoded_fact_checksum
from repro_torch.distributed.pipeline import FrontierExchange

KEYS = ("phase", "rows", "payload_bytes", "padded_bytes", "slot_cap",
        "owner_fresh", "device", "compress", "padded_bytes_wire")

def facts(m):
    rnd = random.Random(1)
    out = [m.Fact("Schema", f"C{i}", "subClassOf", f"C{(i + 3) % 15}")
           for i in range(15)]
    out += [m.Fact("Schema", "anc", "characteristic", "transitive"),
            m.Fact("Schema", "knows", "characteristic", "symmetric"),
            m.Fact("Schema", "p0", "subPropertyOf", "p1")]
    for i in range(60):
        out += [m.Fact("Data", f"x{i}", "type", f"C{rnd.randrange(15)}"),
                m.Fact("Data", f"x{i}", "anc", f"x{rnd.randrange(20)}"),
                m.Fact("Data", f"x{i}", "knows", f"x{(i * 7) % 60}")]
    return out

torch.set_num_threads(1)
cfg = dataclasses.replace(P.EngineConfig.infer1("torch-cpu"), shards=4,
                          compress={compress})
e = P.HiperfactEngine(cfg)
assert isinstance(e, ShardedEngine) and not e.exchange.device
e.exchange = FrontierExchange(4, compress={compress},
                              devices=[torch.device("cpu")] * 4)
r = R.HiperfactEngine(dataclasses.replace(
    R.EngineConfig.infer1("numpy"), shards=4, device_pipeline="on"))
r.exchange = RefExchange(4, prefer_device=True, compress={compress})
one = P.HiperfactEngine(P.EngineConfig.infer1("numpy"))
for eng, rules, m in ((e, rdfs_plus_rules, P), (r, ref_rules, R),
                      (one, rdfs_plus_rules, P)):
    eng.add_rules(rules())
    eng.insert_facts(facts(m))
    eng.infer()
    eng.insert_facts([m.Fact("Data", "z0", "anc", "x0")])
    eng.infer()
assert decoded_fact_checksum(e) == decoded_fact_checksum(one) \
    == ref_checksum(r)
assert all(log["device"] for log in e.exchange_log)
got = [tuple(log[k] for k in KEYS) for log in e.exchange_log]
want = [tuple(log[k] for k in KEYS) for log in r.exchange_log]
assert got == want, (got, want)
assert all(log["padded_bytes"] == 16 * log["slot_cap"] * 24
           for log in e.exchange_log)
print("engine ok", len(got), decoded_fact_checksum(e))
"""


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_engine_device_transport_over_cpu(subproc, compress):
    """A ``torch-cpu`` ``ShardedEngine`` whose exchange is given four CPU
    devices takes the device transport on every flush, derives the
    numpy checksum, and flushes exactly as the reference engine whose
    exchange is the ``shard_map`` transport on four host devices."""
    out = subproc(ENGINE_CHILD.replace("{compress}", str(compress)),
                  n_devices=4)
    assert "engine ok" in out


# ---------------------------------------------------------------------------
# The Rete baseline


def _rule_sets(m):
    from repro_torch.core.rulesets import rdfs_plus_rules as port_rules
    from repro.core.rulesets import rdfs_plus_rules as ref_rules
    rdfs = (port_rules if m.__name__.startswith("repro_torch")
            else ref_rules)()
    kg = [m.Fact(*f) for f in (
        ("Schema", "A", "subClassOf", "B"), ("Schema", "B", "subClassOf", "C"),
        ("Schema", "C", "subClassOf", "D"),
        ("Schema", "knows", "characteristic", "symmetric"),
        ("Schema", "partOf", "characteristic", "transitive"),
        ("Data", "x", "type", "A"), ("Data", "y", "type", "B"),
        ("Data", "x", "knows", "y"), ("Data", "p1", "partOf", "p2"),
        ("Data", "p2", "partOf", "p3"), ("Data", "p3", "partOf", "p4"))]
    queries = [[m.cond("Data", "?x", "type", "D")],
               [m.cond("Data", "?a", "partOf", "?b")],
               [m.cond("Data", "?a", "knows", "?b")],
               [m.cond("Data", "?x", "type", "?t"),
                m.cond("Data", "?x", "knows", "?y")]]
    U = m.ValueType.UINT32
    ages = [m.Fact("Person", "p1", "age", 7, U),
            m.Fact("Person", "p2", "age", 30, U),
            m.Fact("AgeClass", "kid", "minAge", 0, U),
            m.Fact("AgeClass", "adult", "minAge", 18, U)]
    age_q = [m.cond("AgeClass", "?ac", "minAge", "?m", U),
             m.cond("Person", "?p", "age", "?a", U,
                    tests=[("?a", ">=", "?m")])]
    young = [m.cond("Person", "?p", "age", "?a", U, tests=[("?a", "<", 18)])]
    delete = [m.Rule("del-off", (m.cond("T", "?x", "flag", "off"),),
                     (m.DeleteAction("T", m.term("?x"), "flag", "off"),))]
    flags = [m.Fact("T", "a", "flag", "on"), m.Fact("T", "b", "flag", "off")]
    return {"rdfs": (rdfs, kg, queries),
            "join_tests": ([m.Rule("q", tuple(young))], ages,
                           [age_q, young]),
            "delete": (delete, flags, [[m.cond("T", "?x", "flag", "?v")]])}


@pytest.mark.parametrize("name", ["rdfs", "join_tests", "delete"])
def test_rete_baseline_matches_reference(name):
    import repro.core as R
    import repro_torch.core as P
    from repro.core.rete_baseline import ReteEngine as RefRete
    from repro_torch.core.rete_baseline import ReteEngine
    out = []
    for m, cls in ((P, ReteEngine), (R, RefRete)):
        rules, facts, queries = _rule_sets(m)[name]
        r = cls()
        for rule in rules:
            r.add_rule(rule)
        r.insert(facts)
        r.infer()
        out.append([sorted(tuple(sorted(b.items())) for b in r.query(q))
                    for q in queries])
    assert out[0] == out[1]
    assert any(out[0])
    if name == "delete":
        return  # the reference's engine tests hold deletes, not its Rete
    # the port's engine derives what the port's Rete network derives
    rules, facts, queries = _rule_sets(P)[name]
    e = P.HiperfactEngine(P.EngineConfig.infer1("numpy"))
    e.add_rules(rules)
    e.insert_facts(facts)
    e.infer()
    assert [sorted(tuple(sorted(b.items())) for b in e.query(q))
            for q in queries] == out[0]
