"""``TorchOps`` on CPU tensors (the ``torch-cpu`` backend) vs the
reference package's ``NumpyOps``, the documented parity oracle.

Every array primitive and every handle-tier method of the first slice is
run on seeded numpy inputs by both and compared exactly — join pairs and
join rows as sets, since pair order is unspecified.  The fallbacks are
forced too (width overflow, sentinel collisions, the capacity re-run),
and the device-residency contract is asserted on the transfer counter: a
re-evaluation sweep at fixed table versions costs zero transfers.  The
``ops`` fixture keeps resident columns raw (``compress=False``), so the
byte counts below are int64 lanes; the coded tier, the default, is held
against the same oracles in ``test_torch_compression.py``.
"""

import os
import zlib

import numpy as np
import pytest

from repro.backend.numpy_ops import NumpyOps as RefNumpyOps
from repro_torch import kernels
from repro_torch.backend import BACKENDS, get_backend
from repro_torch.backend.torch_ops import TorchOps
from repro_torch.core import EngineConfig, Fact, HiperfactEngine, Rule
from repro_torch.core.conditions import AddAction, cond, term

HOST = RefNumpyOps()
I64 = np.iinfo(np.int64)


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


@pytest.fixture
def ops():
    return TorchOps(device="cpu", block=256, compress=False)


def pair_set(li, ri):
    return sorted(zip(np.asarray(li).tolist(), np.asarray(ri).tolist()))


def rows_of(handles, n):
    return sorted(zip(*(h.host()[:n].tolist() for h in handles)))


def test_backend_names():
    assert BACKENDS == ("numpy", "torch", "torch-cpu")
    o = get_backend("torch-cpu")
    assert isinstance(o, TorchOps) and o.device.type == "cpu"
    # the reference's default rule: compressed unless REPRO_COMPRESS says
    # 0/false/off
    on = os.environ.get("REPRO_COMPRESS") not in ("0", "false", "off")
    assert o.compress is on and o.prefer_handles
    with pytest.raises(ValueError):
        get_backend("jax")


# ---------------------------------------------------------------------------
# array primitives


@pytest.mark.parametrize("n", [1, 5, 300, 1500])
def test_sort_perm_and_cache_hit(ops, n):
    keys = rng("perm", n).randint(-50, 50, n).astype(np.int64) << 33
    sk, perm = ops.sort_perm(keys, cache_key=("t", 1), version=3)
    wsk, wperm = HOST.sort_perm(keys)
    np.testing.assert_array_equal(sk, wsk)
    np.testing.assert_array_equal(perm, wperm)  # stable on every backend
    snap = ops.transfers.snapshot()
    sk2, perm2 = ops.sort_perm(keys, cache_key=("t", 1), version=3)
    d = ops.transfers.delta(snap)
    assert d.h2d_calls == 0 and d.d2h_calls == 0
    assert sk2 is sk and perm2 is perm
    # the sorted mirror stays on the device for batch_probe
    probes = np.concatenate([keys[:7], [I64.max, I64.min, 3]])
    snap = ops.transfers.snapshot()
    lo, hi = ops.batch_probe(sk, probes, cache_key=("t", 1), version=3)
    assert ops.transfers.delta(snap).h2d_calls == 1  # the probes only
    wlo, whi = HOST.batch_probe(wsk, probes)
    np.testing.assert_array_equal(lo, wlo)
    np.testing.assert_array_equal(hi, whi)


def test_sort_perm_tombstone_compaction(ops):
    r = rng("tomb")
    keys = r.randint(0, 20, 400).astype(np.int64)
    alive = r.rand(400) > 0.3
    n_dead = int((~alive).sum())
    for kw in ({}, {"cache_key": ("t", 2), "version": 1}):
        sk, perm = ops.sort_perm(keys, n_dead=n_dead, alive=alive, **kw)
        wsk, wperm = HOST.sort_perm(keys, n_dead=n_dead, alive=alive)
        np.testing.assert_array_equal(sk, wsk)
        np.testing.assert_array_equal(perm, wperm)
    sk, perm = ops.sort_perm(keys, n_dead=400, alive=np.zeros(400, bool),
                             cache_key=("t", 3), version=1)
    assert len(sk) == 0 and len(perm) == 0


def test_sort_perm_width_fallback(ops):
    keys = np.array([I64.max, I64.min, 0, 5, I64.min, -7], np.int64)
    kernels.reset_counts()
    sk, perm = ops.sort_perm(keys)
    assert kernels.FALLBACKS["stable_sort_perm"] == 1
    wsk, wperm = HOST.sort_perm(keys)
    np.testing.assert_array_equal(sk, wsk)
    np.testing.assert_array_equal(perm, wperm)


def _append_versions(r, n0, steps, step, lo=0, hi=40):
    """Versions of an append-only column: ``n0`` rows, then ``steps``
    appends of ``step`` rows each."""
    col = r.randint(lo, hi, n0 + steps * step).astype(np.int64)
    return [col[:n0 + i * step] for i in range(steps + 1)]


def test_sort_perm_merge_maintenance(ops):
    """Appends at a fixed capacity merge the sorted tail into the resident
    run (only the tail goes up) and give exactly the stable full sort."""
    r = rng("merge")
    versions = _append_versions(r, 100, 5, 17)
    for v, col in enumerate(versions):
        snap, work = ops.transfers.snapshot(), ops.sort_work.snapshot()
        sk, perm = ops.sort_perm(col, cache_key=("m", 1), version=v)
        wsk, wperm = HOST.sort_perm(col)
        np.testing.assert_array_equal(sk, wsk)
        np.testing.assert_array_equal(perm, wperm)
        w = ops.sort_work.delta(work)
        assert (w.full_sorts, w.delta_merges) == ((1, 0) if v == 0 else (0, 1))
        if v:  # the tail upload, then the two mirrors down
            d = ops.transfers.delta(snap)
            assert d.h2d_calls == 1 and d.h2d_bytes == 17 * 8
        lo, hi = ops.batch_probe(sk, np.arange(-1, 42), cache_key=("m", 1),
                                 version=v)
        wlo, whi = HOST.batch_probe(wsk, np.arange(-1, 42))
        np.testing.assert_array_equal(lo, wlo)
        np.testing.assert_array_equal(hi, whi)


def test_sort_perm_merge_kmin_shift_and_fallbacks(ops):
    r = rng("merge2")
    base = r.randint(100, 200, 150).astype(np.int64)
    seq = [base,
           np.concatenate([base, [5, 300, 100]]),       # kmin moves: re-base
           np.concatenate([base, [5, 300, 100], r.randint(0, 400, 200)]),
           ]  # 353 rows outgrow the 256 bucket: full sort at a new cap
    wide = np.concatenate([seq[-1], [I64.max - 1]])  # span too wide to tag
    seq += [wide, np.concatenate([wide, [7]])]
    want = [(1, 0), (0, 1), (1, 0), (1, 0), (1, 0)]
    kernels.reset_counts()
    for v, (col, (full, merges)) in enumerate(zip(seq, want)):
        work = ops.sort_work.snapshot()
        sk, perm = ops.sort_perm(col, cache_key=("m", 2), version=v)
        wsk, wperm = HOST.sort_perm(col)
        np.testing.assert_array_equal(sk, wsk)
        np.testing.assert_array_equal(perm, wperm)
        w = ops.sort_work.delta(work)
        assert (w.full_sorts, w.delta_merges) == (full, merges), v
    assert kernels.FALLBACKS["stable_sort_perm"] == 2


def test_sort_perm_merge_compaction_threshold(ops):
    r = rng("merge3")
    versions = _append_versions(r, 20, TorchOps.MIRROR_COMPACT_RUNS + 1, 2)
    for v, col in enumerate(versions):
        sk, perm = ops.sort_perm(col, cache_key=("m", 3), version=v)
    np.testing.assert_array_equal(perm, HOST.sort_perm(col)[1])
    # one cold sort, the threshold's worth of merges, then a compaction
    w = ops.sort_work
    assert w.delta_merges == TorchOps.MIRROR_COMPACT_RUNS
    assert (w.full_sorts, w.compactions) == (2, 1)


def test_sort_perm_merge_with_tombstones(ops):
    """Bounded tombstone drift rides the merge path (the mirror keeps dead
    rows; lookups alive-filter); churn past a quarter of the alive rows
    compacts them out with a full sort, and later appends merge into the
    compacted run."""
    r = rng("merge4")
    col = r.randint(0, 30, 200).astype(np.int64)
    alive = np.ones(200, bool)
    ops.sort_perm(col, cache_key=("m", 4), version=0)
    steps = [(10, 5), (10, 60), (10, 0)]  # (appended rows, newly dead)
    want = [(0, 1), (1, 0), (0, 1)]
    for v, ((add, kill), (full, merges)) in enumerate(zip(steps, want), 1):
        col = np.concatenate([col, r.randint(0, 30, add)])
        alive = np.concatenate([alive, np.ones(add, bool)])
        alive[r.choice(np.flatnonzero(alive), kill, replace=False)] = False
        n_dead = int((~alive).sum())
        work = ops.sort_work.snapshot()
        sk, perm = ops.sort_perm(col, cache_key=("m", 4), version=v,
                                 n_dead=n_dead, alive=alive)
        w = ops.sort_work.delta(work)
        assert (w.full_sorts, w.delta_merges) == (full, merges), v
        keep = alive[perm]  # what every lookup sees after alive-filtering
        wsk, wperm = HOST.sort_perm(col, n_dead=n_dead, alive=alive)
        np.testing.assert_array_equal(sk[keep], wsk)
        np.testing.assert_array_equal(perm[keep], wperm)


@pytest.mark.parametrize("n_a,n_b", [(1, 1), (50, 7), (7, 300), (600, 600)])
def test_merge_runs(ops, n_a, n_b):
    r = rng("mr", n_a, n_b)
    a = np.sort(r.randint(-20, 20, n_a)).astype(np.int64)
    b = np.sort(r.randint(-20, 20, n_b)).astype(np.int64)
    a[-1], b[-1] = I64.max, I64.max  # real keys equal to the pad
    np.testing.assert_array_equal(ops.merge_runs(a, b),
                                  HOST.merge_runs(a, b))
    np.testing.assert_array_equal(ops.merge_runs(a, b[:0]), a)


def test_sort_kv(ops):
    r = rng("kv")
    keys = r.randint(-(1 << 40), 1 << 40, 500).astype(np.int64)
    keys[::7] = keys[0]  # ties: stable on every backend
    vals = np.arange(500, dtype=np.int64)
    gk, gv = ops.sort_kv(keys, vals)
    wk, wv = HOST.sort_kv(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("algo", ["MJ", "HJ"])
def test_join_pairs(ops, algo):
    r = rng("join", algo)
    lk = r.randint(0, 40, 300).astype(np.int64) * (1 << 33)
    rk = r.randint(0, 40, 170).astype(np.int64) * (1 << 33)
    gli, gri = ops.join(lk, rk, algo)
    assert pair_set(gli, gri) == pair_set(*HOST.join(lk, rk, algo))
    # resident right side: the second call at the same version uploads
    # only the left keys
    ops.join_pairs(lk, rk, rkeys_key=("pk", 9), rkeys_version=1)
    snap = ops.transfers.snapshot()
    gli, gri = ops.join_pairs(lk, rk, rkeys_key=("pk", 9), rkeys_version=1)
    assert ops.transfers.delta(snap).h2d_calls == 1
    assert pair_set(gli, gri) == pair_set(*HOST.join_pairs(lk, rk))


def test_join_pairs_capacity_rerun_and_sentinels(ops):
    z = np.zeros(80, np.int64)  # 6400 pairs overflow the first bucket
    gli, gri = ops.join_pairs(z, z)
    assert len(gli) == 6400 and pair_set(gli, gri) == pair_set(
        *HOST.join_pairs(z, z))
    lk = np.array([I64.min, 3, I64.max], np.int64)
    rk = np.array([I64.max, 3, I64.min, 3], np.int64)
    kernels.reset_counts()
    gli, gri = ops.join_pairs(lk, rk)
    assert kernels.FALLBACKS["join_host_redo"] == 1
    assert pair_set(gli, gri) == pair_set(*HOST.join_pairs(lk, rk))


def test_semi_join(ops):
    r = rng("semi")
    keys = r.randint(0, 60, 333).astype(np.int64)
    keys[:3] = [I64.max, I64.min, 7]
    bound = r.randint(0, 30, 77).astype(np.int64)
    np.testing.assert_array_equal(ops.semi_join(keys, bound),
                                  HOST.semi_join(keys, bound))
    bound[0] = I64.max
    np.testing.assert_array_equal(ops.semi_join(keys, bound),
                                  HOST.semi_join(keys, bound))
    assert not ops.semi_join(keys, np.empty(0, np.int64)).any()


@pytest.mark.parametrize("wide", [False, True])
def test_dedup_rows(ops, wide):
    r = rng("dedup", wide)
    cols = [r.randint(0, k, 600).astype(np.int64) for k in (5, 3, 4)]
    if wide:
        cols[1][::50] = I64.max
        cols[1][1::50] = I64.min
    kernels.reset_counts()
    got = ops.dedup_rows(cols)
    assert kernels.FALLBACKS["dedup_rows"] == int(wide)
    np.testing.assert_array_equal(got, HOST.dedup_rows(cols))


def test_unported_primitives_raise(ops):
    """Every primitive of ``Ops`` is ported now: ``unique_mask``,
    ``sketch`` and the compressed tier run and match the oracle (only
    the engine's sharded mode still raises)."""
    x = np.array([3, 3, 5, 9, 9, 9], np.int64)
    np.testing.assert_array_equal(ops.unique_mask(x), HOST.unique_mask(x))
    sk, want = ops.sketch(x), HOST.sketch(x)
    assert (sk["n"], sk["distinct"]) == (want["n"], want["distinct"])
    np.testing.assert_array_equal(sk["hist"], want["hist"])
    assert TorchOps(device="cpu", compress=True).compress is True


# ---------------------------------------------------------------------------
# handle tier


def both(ops, *arrays):
    """The same columns uploaded to the port and to the oracle."""
    return ([ops.upload(a) for a in arrays], [HOST.upload(a) for a in arrays])


def test_upload_materialize_iota_const(ops):
    a = rng("up").randint(-9, 9, 70).astype(np.int64)
    h = ops.upload(a)
    assert h.n == 70 and (h.lo, h.hi) == (a.min(), a.max())
    h._host = None  # force a real download
    np.testing.assert_array_equal(h.host(), a)
    np.testing.assert_array_equal(ops.iota_h(9).host(), HOST.iota_h(9).host())
    assert ops.iota_h(9) is ops.iota_h(9)  # memoized
    c = ops.const_h(-4, 300)
    c._host = None
    np.testing.assert_array_equal(c.host(), HOST.const_h(-4, 300).host())
    assert ops.upload(np.empty(0, np.int64)).n == 0


def test_upload_resident(ops):
    a = np.arange(50, dtype=np.int64) * 3
    h1 = ops.upload_resident(("bc", 1), 4, a)
    snap = ops.transfers.snapshot()
    assert ops.upload_resident(("bc", 1), 4, a) is h1
    assert ops.transfers.delta(snap).h2d_calls == 0
    b = np.concatenate([a, [7, 8]])
    h2 = ops.upload_resident(("bc", 1), 5, b, assume_prefix=True)
    h2._host = None
    np.testing.assert_array_equal(h2.host(), b)
    t = ops.upload_resident(("bc", 2), 1, a, transient=True)
    assert not t.stable and h1.stable


def test_upload_resident_extends_with_the_tail_only(ops):
    a = np.arange(40, dtype=np.int64)
    h1 = ops.upload_resident(("bx", 1), 1, a)
    b = np.concatenate([a, [-5, 99]])
    snap = ops.transfers.snapshot()
    h2 = ops.upload_resident(("bx", 1), 2, b)  # prefix checked on the host
    d = ops.transfers.delta(snap)
    assert d.h2d_calls == 1 and d.h2d_bytes == 16
    assert (h2.lo, h2.hi) == (-5, 99) and h2.stable
    h1._host = h2._host = None  # the older handle keeps its own buffer
    np.testing.assert_array_equal(h1.host(), a)
    np.testing.assert_array_equal(h2.host(), b)
    c = b.copy()
    c[0] = 7  # a rewritten prefix uploads the column whole
    c = np.concatenate([c, [1]])
    snap = ops.transfers.snapshot()
    h3 = ops.upload_resident(("bx", 1), 3, c)
    assert ops.transfers.delta(snap).h2d_bytes > 8
    h3._host = None
    np.testing.assert_array_equal(h3.host(), c)


@pytest.mark.parametrize("total", [40, 700])  # below / above one block
def test_concat_gather_select(ops, total):
    r = rng("cat", total)
    parts = [r.randint(0, 99, k).astype(np.int64)
             for k in (total // 2, 0, total - total // 2)]
    hs, ws = both(ops, *parts)
    cat, wcat = ops.concat_h(hs), HOST.concat_h(ws)
    assert cat.n == wcat.n == total
    np.testing.assert_array_equal(cat.host(), wcat.host())
    idx = r.randint(0, total, 33).astype(np.int64)
    (hi_,), (wi,) = both(ops, idx)
    g = ops.gather_h(cat, hi_)
    g._host = None
    np.testing.assert_array_equal(g.host(), HOST.gather_h(wcat, wi).host())
    mask = r.rand(total) > 0.5
    hm = ops.upload(mask.astype(np.int64))
    hm = ops.test_mask_h(hm, ops.const_h(1, total), "==", 2)
    (sel, g2), n = ops.select_mask_h([cat, ops.iota_h(total)], hm)
    wm = HOST.test_mask_h(HOST.upload(mask.astype(np.int64)),
                          HOST.const_h(1, total), "==", 2)
    (wsel, wg2), wn = HOST.select_mask_h([wcat, HOST.iota_h(total)], wm)
    assert n == wn
    sel._host = g2._host = None
    np.testing.assert_array_equal(sel.host(), wsel.host())
    np.testing.assert_array_equal(g2.host(), wg2.host())


def test_semi_join_pack_pairs(ops):
    r = rng("sjpp")
    k = r.randint(0, 40, 260).astype(np.int64)
    b = r.randint(0, 20, 50).astype(np.int64)
    (hk, hb), (wk, wb) = both(ops, k, b)
    m = ops.semi_join_h(hk, hb)
    m._host = None
    np.testing.assert_array_equal(m.host(), HOST.semi_join_h(wk, wb).host())
    assert not ops.semi_join_h(hk, ops.upload(np.empty(0))).host().any()
    p = ops.pack_pairs_h(hk, hk)
    p._host = None
    np.testing.assert_array_equal(p.host(),
                                  HOST.pack_pairs_h(wk, wk).host())


@pytest.mark.parametrize("algo", ["MJ", "HJ"])
def test_join_gather_h(ops, algo):
    r = rng("jg", algo)
    lk = r.randint(0, 25, 260).astype(np.int64) * (1 << 33)
    rk = r.randint(0, 25, 140).astype(np.int64) * (1 << 33)
    lv = r.randint(0, 4, 260).astype(np.int64)
    rv = r.randint(0, 4, 140).astype(np.int64)
    out = []
    for o in (ops, HOST):
        hk, hr, hlv, hrv = (o.upload(x) for x in (lk, rk, lv, rv))
        lout, rout, n = o.join_gather_h(hk, hr, [hk, hlv], [hrv],
                                        [(hlv, hrv)], algo)
        out.append((n, rows_of(lout + rout, n)))
    assert out[0] == out[1]


def test_join_gather_h_capacity_rerun(ops):
    z = np.zeros(60, np.int64)  # 3600 candidate pairs > the first bucket
    hz = ops.upload(z)
    lout, rout, n = ops.join_gather_h(hz, hz, [ops.iota_h(60)],
                                      [ops.iota_h(60)], (), "MJ")
    assert n == 3600
    assert rows_of(lout + rout, n) == sorted(
        (a, b) for a in range(60) for b in range(60))


def _splitmix64_inverse(y: int) -> int:
    """The int64 whose splitmix64 is ``y`` (every step is invertible)."""
    M = (1 << 64) - 1

    def unxorshift(z, s):
        x = z
        for _ in range(64 // s + 1):
            x = z ^ (x >> s)
        return x & M
    z = y & M
    z = unxorshift(z, 31)
    z = (z * pow(0x94D049BB133111EB, -1, 1 << 64)) & M
    z = unxorshift(z, 27)
    z = (z * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M
    z = unxorshift(z, 30)
    z = (z - 0x9E3779B97F4A7C15) & M
    return z - (1 << 64) if z >= 1 << 63 else z


def test_join_gather_h_sentinel_host_redo(ops):
    from repro_torch.backend.base import splitmix64
    # HJ: a right key hashing onto the right pad sentinel (hash_bad)
    bad = _splitmix64_inverse(1 << 63)
    assert splitmix64(np.array([bad], np.int64)).view(np.int64)[0] == I64.min
    lk = np.array([bad, 1, 2, bad], np.int64)
    rk = np.array([2, bad, 5], np.int64)
    # MJ: a left key equal to the right pad sentinel
    lk2 = np.array([I64.min, 4, 4], np.int64)
    rk2 = np.array([4, I64.min], np.int64)
    for (l, r_), algo in (((lk, rk), "HJ"), ((lk2, rk2), "MJ")):
        kernels.reset_counts()
        res = []
        for o in (ops, HOST):
            hl, hr = o.upload(l), o.upload(r_)
            lout, rout, n = o.join_gather_h(hl, hr, [o.iota_h(len(l))],
                                            [o.iota_h(len(r_))], (), algo)
            res.append((n, rows_of(lout + rout, n)))
        assert res[0] == res[1]
        assert kernels.FALLBACKS["join_host_redo"] == 1


def test_dedup_select_and_fresh_mask(ops):
    r = rng("ddfm")
    ids = r.randint(0, 8, 400).astype(np.int64)
    attrs = r.randint(0, 3, 400).astype(np.int64)
    vals = r.randint(0, 5, 400).astype(np.int64)
    hs, ws = both(ops, ids, attrs, vals)
    idx, n = ops.dedup_select_h(hs)
    widx, wn = HOST.dedup_select_h(ws)
    idx._host = None
    assert n == wn
    np.testing.assert_array_equal(idx.host()[:n], widx.host()[:wn])
    old_k = (r.randint(0, 8, 300).astype(np.int64) << 32) | r.randint(0, 3,
                                                                      300)
    old_v = r.randint(0, 5, 300).astype(np.int64)
    kn, wkn = ops.pack_pairs_h(hs[0], hs[1]), HOST.pack_pairs_h(ws[0], ws[1])
    want = HOST.fresh_mask_h(wkn, ws[2], old_k, old_v).host()
    for kw in ({}, {"cache_uid": 77, "version": 2}):
        f = ops.fresh_mask_h(kn, hs[2], old_k, old_v, **kw)
        f._host = None
        np.testing.assert_array_equal(f.host(), want)
    assert ops.fresh_mask_h(kn, hs[2], old_k[:0], old_v[:0]).host().all()


@pytest.mark.parametrize("vt", [2, 5, 6, 4])  # INT64, FLOAT, DOUBLE, UINT64
@pytest.mark.parametrize("op", ["==", "!=", ">=", "<=", ">", "<"])
def test_test_mask_h(ops, op, vt):
    from repro_torch.core.facts import ValueType, encode_lane_array
    r = rng("tm", op, vt)
    if vt in (5, 6):
        raw = r.randn(2, 90) * 100
        raw[1, ::4] = raw[0, ::4]
    elif vt == 4:
        raw = r.randint(0, 1 << 62, (2, 90)).astype(np.uint64) * 3
        raw[1, ::4] = raw[0, ::4]
    else:
        raw = r.randint(-50, 50, (2, 90))
    a, b = (encode_lane_array(x, ValueType(vt)) for x in raw)
    (ha, hb), (wa, wb) = both(ops, a, b)
    m = ops.test_mask_h(ha, hb, op, vt)
    m._host = None
    np.testing.assert_array_equal(m.host(),
                                  HOST.test_mask_h(wa, wb, op, vt).host())


def test_cross_join_h(ops):
    a, b = np.arange(7, dtype=np.int64), np.arange(5, dtype=np.int64) * 10
    (ha, hb), (wa, wb) = both(ops, a, b)
    lout, rout, n = ops.cross_join_h([ha], [hb], 7, 5)
    wl, wr, wn = HOST.cross_join_h([wa], [wb], 7, 5)
    assert n == wn == 35
    assert rows_of(lout + rout, n) == rows_of(wl + wr, wn)


# ---------------------------------------------------------------------------
# device residency: a fixed-version sweep moves nothing


def island_rule():
    return Rule("r3", (cond("T", "?x", "type", "?t"),
                       cond("T", "?x", "knows", "?y"),
                       cond("T", "?y", "type", "?u")),
                (AddAction("T", term("?x"), "sees", term("?u")),))


def island_facts():
    facts = [Fact("T", f"n{i}", "type", f"c{i % 3}") for i in range(12)]
    facts += [Fact("T", f"n{i}", "knows", f"n{(i + 1) % 12}")
              for i in range(12)]
    return facts


@pytest.mark.parametrize("preset", ["query1", "infer1"])
def test_island_fixpoint_zero_transfers_full_sweep(preset):
    """A full rule re-evaluation sweep (joins + actions + write-side
    dedup/anti-join) at fixed table versions costs zero transfers."""
    cfg = getattr(EngineConfig, preset)(backend="torch-cpu")
    cfg.eval_mode = "full"
    e = HiperfactEngine(cfg)
    e.add_rule(island_rule())
    e.insert_facts(island_facts())
    assert e.infer().facts_inferred > 0
    snap = e.ops.transfers.snapshot()
    e._rule_seen_versions.clear()  # forces re-evaluation of every rule
    s2 = e.infer()
    d = e.ops.transfers.delta(snap)
    assert s2.facts_inferred == 0
    assert d.h2d_calls == 0 and d.d2h_calls == 0, d
