"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Each test carries the ``cuda`` marker and skips where torch sees no CUDA
device; on a card (``python -m pytest -m cuda tests/test_torch_cuda.py``)
each integer kernel must give bit-identical output to its plain version
and each float kernel must agree with its plain version within a stated
tolerance — the plain versions are held against the reference Pallas
kernels on the CPU by ``test_torch_kernels.py`` and
``test_torch_lm_kernels.py``.  The LM models' prefill and decode on the
card are held against the same models' CPU runs, and so is the MoE
layer, with and without dropped pairs.  This file imports nothing of
JAX, so it runs where only the port is installed.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                     probe_sorted_plain)
from repro_torch.kernels.sortmerge.sortmerge import (SORT_FUSE, SORT_KV_REG,
                                                     SORT_KV_TILE,
                                                     SORT_LOWER_TIERS,
                                                     SORT_MIN_TILES, SORT_REG,
                                                     SORT_TILE, bitonic_sort,
                                                     bitonic_sort_kv,
                                                     bitonic_sort_kv_plain,
                                                     bitonic_sort_plain,
                                                     merge_ranks,
                                                     merge_ranks_plain)
from repro_torch.kernels.uniquefilter.uniquefilter import (
    unique_mask_sorted, unique_mask_sorted_plain)


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def keys_with_extremes(r, n, dtype):
    info = np.iinfo(dtype)
    x = r.randint(-1000, 1000, n).astype(dtype)
    if n >= 4:
        x[r.choice(n, 3, replace=False)] = [info.max, info.min, info.max]
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    # the plain versions' float32 products in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4096, 5000, 1 << 15])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_bitonic_sort_equals_plain(cuda, n, dtype):
    x = T(keys_with_extremes(rng("csort", n), n,
                             np.int32 if dtype == torch.int32
                             else np.int64)).to(cuda)
    before = kernels.LAUNCHES["bitonic_sort"]
    got = bitonic_sort(x)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic_sort_plain(x))
    assert kernels.LAUNCHES["bitonic_sort"] == before + (n > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 100, 4096, 9000, 1 << 15])
def test_cuda_bitonic_sort_kv_equals_plain(cuda, n):
    r = rng("ckv", n)
    k = T(r.randint(0, 50, n).astype(np.int64)).to(cuda)
    v = T(r.permutation(n).astype(np.int32)).to(cuda)
    gk, gv = bitonic_sort_kv(k, v)
    wk, wv = bitonic_sort_kv_plain(k, v)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def boundary_sizes(top):
    """Sizes on each side of the sort kernel's boundaries, for its top tier
    and each smaller one: the register width, a warp's span, the tile, the
    tile times the fused levels' reach, the size from which the tier is
    taken, and one size past 2^21."""
    sizes = {(1 << 21) + 5}
    for tile, reg in (top, *SORT_LOWER_TIERS):
        reach = tile << SORT_FUSE
        sizes |= {reg, 32 * reg, tile, tile + 1, reach, reach + 3,
                  SORT_MIN_TILES * tile, SORT_MIN_TILES * tile + 1}
    return sorted(n for n in sizes if n <= 1 << 22)


def ties_and_max(r, n, dtype):
    """Keys with many ties, real keys equal to the dtype's max (the pad
    value) and its min."""
    info = np.iinfo(dtype)
    x = r.randint(-20, 20, n).astype(dtype)
    x[r.choice(n, min(n, 6), replace=False)] = [info.max, info.min,
                                                info.max, 0, info.max,
                                                info.min][:min(n, 6)]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n", boundary_sizes((SORT_TILE, SORT_REG)))
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_bitonic_sort_boundaries(cuda, n, dtype):
    x = T(ties_and_max(rng("cbound", n, str(dtype)), n,
                       np.int32 if dtype == torch.int32
                       else np.int64)).to(cuda)
    before_x = x.clone()
    before = kernels.LAUNCHES["bitonic_sort"]
    got = bitonic_sort(x)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic_sort_plain(x))
    assert torch.equal(x, before_x)  # the input is left as it was
    assert kernels.LAUNCHES["bitonic_sort"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", boundary_sizes((SORT_KV_TILE, SORT_KV_REG)))
def test_cuda_bitonic_sort_kv_boundaries(cuda, n):
    r = rng("ckvbound", n)
    k = T(ties_and_max(r, n, np.int64)).to(cuda)
    v = T(r.permutation(n).astype(np.int32)).to(cuda)
    k0, v0 = k.clone(), v.clone()
    before = kernels.LAUNCHES["bitonic_sort_kv"]
    gk, gv = bitonic_sort_kv(k, v)
    torch.cuda.synchronize()
    wk, wv = bitonic_sort_kv_plain(k, v)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    assert kernels.LAUNCHES["bitonic_sort_kv"] == before + 1


I64 = np.iinfo(np.int64)


def probe_case(form: str, n: int, m: int, salt=()):
    """(left keys, sorted right keys) of one of the forms the engine gives
    the probe; ``tests/test_torch_probe_plan.py`` uses them too."""
    r = rng("probe", form, n, m, *salt)
    if form == "dense":  # many matches, keys inside and outside
        right = np.sort(r.randint(0, 190, m))
        left = r.randint(-5, 200, n)
    elif form == "random":  # runs of 1-3, keys inside and outside
        right = np.sort(r.randint(0, max(m // 2, 1), m))
        left = r.randint(-3, max(m // 2, 1) + 3, n)
    elif form == "one_run":  # a single run of length m
        right = np.full(m, 7)
        left = r.choice([6, 7, 8], n)
    elif form == "join_pads":  # left pads INT64_MAX, right pads INT64_MIN
        right = r.randint(0, 20, m)
        right[m // 2:] = I64.min
        right = np.sort(right)
        left = r.randint(-2, 22, n)
        left[n - n // 3:] = I64.max
    elif form == "batch_probe":  # an INT64_MAX tail on the right buffer
        real = max(m // 3, 1)
        right = np.concatenate([np.sort(r.randint(0, 40, real)),
                                np.full(m - real, I64.max)])[:m]
        left = r.randint(-1, 41, n)
        left[n // 2:] = I64.max
    elif form == "outside":  # every key below or above every right key
        right = np.sort(r.randint(100, 200, m))
        left = np.where(r.rand(n) < 0.5, r.randint(I64.min, 100, n),
                        r.randint(200, I64.max, n))
    else:
        raise ValueError(form)
    return left.astype(np.int64), right.astype(np.int64)


# the kernel's table holds 2^14 splitters: m on each side of it and of its
# double; n not a multiple of the keys a thread takes
PROBE_TABLE = 1 << 14
PROBE_SHAPES = [
    ("dense", 1, 1), ("dense", 1000, 37), ("dense", 5000, 1 << 14),
    ("dense", 3, 1), ("random", 4097, PROBE_TABLE - 1),
    ("random", 4097, PROBE_TABLE), ("random", 4099, PROBE_TABLE + 1),
    ("random", 30001, 2 * PROBE_TABLE + 1), ("random", 1 << 20, 1 << 21),
    ("one_run", 4097, PROBE_TABLE + 1), ("one_run", 999, 1 << 21),
    ("outside", 5001, 1 << 18), ("join_pads", 4097, PROBE_TABLE - 1),
    ("join_pads", 1 << 21, 1 << 21), ("batch_probe", 4097, PROBE_TABLE + 1),
    ("batch_probe", 1 << 21, 1 << 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("form,n,m", PROBE_SHAPES)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "left[1:]"])
def test_cuda_probe_equals_plain(cuda, form, n, m, offset):
    left, right = probe_case(form, n + offset, m)
    lk = T(left).to(cuda)[offset:]  # offset 1: 8 bytes past 16-aligned
    rs = T(right).to(cuda)
    before = kernels.LAUNCHES["probe_sorted"]
    lo, hi = probe_sorted(lk, rs)
    plo, phi = probe_sorted_plain(lk, rs)
    torch.cuda.synchronize()
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    assert kernels.LAUNCHES["probe_sorted"] == before + 1


def rank_case(form: str, n: int, m: int, salt=()):
    """(keys in any order, sorted run) of one of the rank kernel's forms;
    ``tests/test_torch_rank_plan.py`` uses them too."""
    r = rng("ranks", form, n, m, *salt)
    if form == "dups":  # unsorted keys with duplicates, runs in the other
        other = np.sort(r.randint(0, max(m // 4, 2), m))
        x = r.randint(-2, max(m // 4, 2) + 2, n)
    elif form == "pads":  # merge_runs: both runs sorted, INT64_MAX tails
        real_m, real_n = max(m - m // 3, 1), max(n - n // 4, 1)
        other = np.concatenate([np.sort(r.randint(0, 50, real_m)),
                                np.full(m - real_m, I64.max)])
        x = np.concatenate([np.sort(r.randint(0, 50, real_n)),
                            np.full(n - real_n, I64.max)])
    elif form == "extremes":  # keys at and beyond both ends of int64
        other = np.sort(r.randint(-100, 100, m))
        other[:1], other[-1:] = I64.min, I64.max
        x = r.choice([I64.min, I64.max, -100, 0, 99, 100], n)
    else:
        raise ValueError(form)
    return x.astype(np.int64), other.astype(np.int64)


# the rank kernel's tree holds 2^14 keys (fewer for n <= 2^13): m on each
# side of it, below 32, and the engine's largest merge both ways
RANK_SHAPES = [(1 << 21, 1 << 13), (1 << 13, 1 << 21),
               ((1 << 13) + 1, 1 << 21), (4097, PROBE_TABLE - 1),
               (4097, PROBE_TABLE), (4097, PROBE_TABLE + 1), (100, 20),
               (30001, 2 * PROBE_TABLE + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("side_right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("n,m", [(1, 1), (1000, 37), (5000, 1 << 14),
                                 *RANK_SHAPES])
def test_cuda_merge_ranks_equals_plain(cuda, n, m, side_right):
    r = rng("cranks", n, m)
    x = T(r.randint(-5, 200, n).astype(np.int64)).to(cuda)
    other = T(np.sort(r.randint(0, 190, m)).astype(np.int64)).to(cuda)
    before = kernels.LAUNCHES["merge_ranks"]
    got = merge_ranks(x, other, side_right=side_right)
    torch.cuda.synchronize()
    assert torch.equal(got, merge_ranks_plain(x, other, side_right))
    assert kernels.LAUNCHES["merge_ranks"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("side_right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("n,m", RANK_SHAPES)
@pytest.mark.parametrize("form", ["dups", "pads", "extremes"])
def test_cuda_merge_ranks_forms(cuda, form, n, m, side_right):
    """Keys in any order with duplicates, INT64_MAX pad tails on both runs
    (as merge_runs gives them), keys at both ends of int64."""
    x, other = (T(a).to(cuda) for a in rank_case(form, n, m))
    before = kernels.LAUNCHES["merge_ranks"]
    got = merge_ranks(x, other, side_right=side_right)
    torch.cuda.synchronize()
    assert torch.equal(got, merge_ranks_plain(x, other, side_right))
    assert kernels.LAUNCHES["merge_ranks"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 31, 33, 1000, 4097, 1 << 16,
                               (1 << 21) + 3])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "x[1:]"])
def test_cuda_unique_mask_equals_plain(cuda, n, offset):
    r = rng("cuniq", n)
    x = np.sort(r.randint(0, max(n // 8, 1), n + offset)).astype(np.int64)
    if n >= 4:  # the int64 extremes at both ends
        x[0], x[-1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    # offset 1: a contiguous view 8 bytes past a 16-byte boundary
    xt = T(x).to(cuda)[offset:]
    before = kernels.LAUNCHES["unique_mask_sorted"]
    got = unique_mask_sorted(xt)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == (n,)
    assert torch.equal(got, unique_mask_sorted_plain(xt))
    assert kernels.LAUNCHES["unique_mask_sorted"] == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda):
    with pytest.raises(TypeError):
        bitonic_sort(torch.zeros(8, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        probe_sorted(torch.zeros(8, dtype=torch.int64, device=cuda),
                     torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError):  # narrow codes widen before the kernel
        unique_mask_sorted(torch.zeros(8, dtype=torch.int16, device=cuda))
    with pytest.raises(ValueError):
        unique_mask_sorted(torch.zeros(16, dtype=torch.int64,
                                       device=cuda)[::2])


KG = [("Schema", "A", "subClassOf", "B"), ("Schema", "B", "subClassOf", "C"),
      ("Schema", "knows", "characteristic", "symmetric"),
      ("Schema", "partOf", "characteristic", "transitive"),
      ("Data", "x", "type", "A"), ("Data", "y", "type", "B"),
      ("Data", "x", "knows", "y"), ("Data", "p1", "partOf", "p2"),
      ("Data", "p2", "partOf", "p3"), ("Data", "p3", "partOf", "p4")]


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_cuda_engine_equals_numpy(cuda, preset):
    """The engine on the ``torch`` backend launches the path's kernels and
    matches the ``numpy`` backend.  The facts go in two batches, so the
    AI index of ``query1`` merges the second into its sorted mirrors (an
    LPIM index re-sorts only after four 4096-row pages of appends).  The
    unique-mask kernel runs under the sketch planner only (below)."""
    from repro_torch.core import EngineConfig, Fact, HiperfactEngine
    from repro_torch.core.conditions import cond
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    out = []
    for backend in ("torch", "numpy"):
        cfg = getattr(EngineConfig, preset)(backend=backend)
        cfg.eval_mode = "full"
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        kernels.reset_counts()
        e.insert_facts([Fact(*f) for f in KG[:6]])
        e.insert_facts([Fact(*f) for f in KG[6:]])
        s = e.infer()
        rows = {tuple(sorted(r.items()))
                for r in e.query([cond("Data", "?a", "partOf", "?b")])}
        if backend == "torch":
            skip = {"unique_mask_sorted"} | (
                {"merge_ranks"} if preset == "infer1" else set())
            assert all(kernels.LAUNCHES[k] > 0
                       for k in kernels.ENGINE_KERNELS if k not in skip)
        out.append((s.facts_inferred, rows, decoded_fact_checksum(e)))
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("sort_mode", ["sortkeys", "sketch"])
def test_cuda_compressed_engine_equals_numpy(cuda, sort_mode):
    """The compressed tier on the card: ``query1`` with ``compress=True``
    (and the device sketch planner) matches the ``numpy`` backend, keeps
    its resident columns coded, and the sketch run goes through the
    unique-mask kernel."""
    from repro_torch.core import EngineConfig, Fact, HiperfactEngine
    from repro_torch.core.conditions import cond
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    out = []
    for backend in ("torch", "numpy"):
        cfg = EngineConfig.query1(backend=backend)
        cfg.eval_mode, cfg.compress, cfg.sort_mode = "full", True, sort_mode
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        kernels.reset_counts()
        e.insert_facts([Fact(*f) for f in KG[:6]])
        e.insert_facts([Fact(*f) for f in KG[6:]])
        s = e.infer()
        rows = {tuple(sorted(r.items()))
                for r in e.query([cond("Data", "?a", "partOf", "?b")])}
        if backend == "torch":
            st = e.ops.residency_stats()
            assert st["compress"] and st["columns_coded"] > 0
            assert (kernels.LAUNCHES["unique_mask_sorted"] > 0) == (
                sort_mode == "sketch")
        out.append((s.facts_inferred, rows, decoded_fact_checksum(e)))
    assert out[0] == out[1]


@pytest.mark.cuda
def test_cuda_ops_unique_mask_and_sketch(cuda):
    """``Ops.unique_mask`` and ``Ops.sketch`` on the card equal the numpy
    backend's (a narrow upload, then the kernel)."""
    from repro_torch.backend import fresh_backend
    ops, host = fresh_backend("torch", compress=True), fresh_backend("numpy")
    r = rng("cops")
    x = np.sort(r.randint(0, 300, 5000)).astype(np.int64) + (1 << 40)
    np.testing.assert_array_equal(ops.unique_mask(x), host.unique_mask(x))
    col = r.randint(-50, 50, 3000).astype(np.int64) << 20
    got, want = ops.sketch(col), host.sketch(col)
    assert (got["n"], got["distinct"]) == (want["n"], want["distinct"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    np.testing.assert_array_equal(got["dhist"], want["dhist"])


LUBM_POINT = [[("Data", "stu0_0_0", "type", "?t")],
              [("Data", "?x", "memberOf", "dept0_0")]]


@pytest.mark.cuda
def test_cuda_demand_equals_numpy(cuda):
    """``eval_mode="demand"`` on the card over ``lubm_like(20)``: the
    ``LUBM_QUERIES`` and two point queries give the port's ``numpy``
    backend's row sets and demand counters, with no fallback, through
    the sort and probe kernels."""
    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.core.conditions import cond
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES, lubm_like
    facts = lubm_like(20)
    queries = LUBM_QUERIES + [[cond(*c) for c in q] for q in LUBM_POINT]
    out = []
    for backend in ("torch", "numpy"):
        cfg = EngineConfig.infer1(backend=backend)
        cfg.eval_mode = "demand"
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        e.insert_facts(facts)
        kernels.reset_counts()
        rows = [{tuple(sorted(r.items())) for r in e.query(q)}
                for q in queries]
        st = e.last_infer
        if backend == "torch":
            assert kernels.LAUNCHES["bitonic_sort"] > 0
            assert kernels.LAUNCHES["probe_sorted"] > 0
        assert st.demand_fallbacks == 0 and st.demand_cone_rows > 0
        out.append((rows, st.demand_rounds, st.demand_cone_rows))
    assert out[0] == out[1]


@pytest.mark.cuda
def test_cuda_fact_server_threads_equal_numpy(cuda):
    """``FactServer`` over a ``query1`` delta engine on the card: two
    writers append while two readers send batched point queries; every
    read equals a ``numpy`` engine stepped through the write history to
    the read's token, and the batched reads launch ``probe_sorted``."""
    import threading

    from repro_torch.core import EngineConfig, Fact, HiperfactEngine
    from repro_torch.core.conditions import cond
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.serve import FactServer

    def engine(backend):
        cfg = EngineConfig.query1(backend=backend)
        cfg.eval_mode = "delta"
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        e.insert_facts([Fact(*f) for f in KG])
        e.infer()
        return e

    qs = [[cond("Data", "?a", "partOf", "?b")],
          [cond("Data", "x", "type", "?t")],
          [cond("Data", "p1", "?r", "?o")]]
    srv = FactServer(engine("torch"), record_history=True)
    served, errors = [], []

    def writer(w):
        try:
            for i in range(6):
                srv.append([Fact("Data", f"p{w}_{i}", "partOf", "p1"),
                            Fact("Data", f"w{w}_{i}", "type", "A")])
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    def reader(r):
        try:
            for i in range(12):
                q = qs[(r + i) % len(qs)]
                served.append((q, srv.serve(q, tenant=f"t{i % 2}")))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    kernels.reset_counts()
    threads = ([threading.Thread(target=writer, args=(w,)) for w in range(2)]
               + [threading.Thread(target=reader, args=(r,))
                  for r in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    srv.close()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert kernels.LAUNCHES["probe_sorted"] > 0
    assert srv.stats()["served"]["batched"] == len(served) == 24
    last = {tok: i for i, (_, _, tok) in enumerate(srv.history)}
    oracle, checked = engine("numpy"), 0
    for i, (_, facts, tok) in enumerate(srv.history):
        if facts:
            oracle.insert_facts(facts)
            oracle.infer()
        if last[tok] != i:
            continue
        for q, res in served:
            if res.token == tok:
                assert ({tuple(sorted(r.items())) for r in res.rows}
                        == {tuple(sorted(r.items()))
                            for r in oracle.query(q)})
                checked += 1
    assert checked == len(served)



@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_cuda_frontier_exchange_equals_host(cuda, compress):
    """The exchange's device transport over ``[cuda] * 4`` (the scatter
    and slot permute on the card) returns exactly the host permute's
    lanes, in the same order, and the same payload accounting; the
    padded bytes are the bounded buffers' ``4 * 4 * slot_cap`` rows."""
    from repro_torch.distributed.pipeline import FrontierExchange
    r = rng("cxchg", compress)
    dest = [r.randint(0, 4, n).astype(np.int32) for n in (0, 5, 300, 77)]
    key = [(r.randint(0, 1 << 20, len(d)).astype(np.int64) << 32)
           | r.randint(0, 40, len(d)) for d in dest]
    val = [r.randint(-(1 << 62), 1 << 62, len(d)).astype(np.int64)
           for d in dest]
    meta = [r.randint(0, 1 << 24, len(d)).astype(np.int64) for d in dest]
    dev = FrontierExchange(4, compress=compress, devices=[cuda] * 4)
    host = FrontierExchange(4, prefer_device=False, compress=compress)
    assert dev.device and not host.device
    got, gs = dev.exchange(dest, key, val, meta)
    want, ws = host.exchange(dest, key, val, meta)
    for d in range(4):
        for a, b in zip(got[d], want[d]):
            np.testing.assert_array_equal(a, b)
    for k in ("rows", "payload_bytes", "payload_bytes_wire", "slot_cap"):
        assert gs[k] == ws[k], k
    assert gs["padded_bytes"] == 16 * gs["slot_cap"] * 24


@pytest.mark.cuda
def test_cuda_sharded_engine_equals_numpy(cuda):
    """``shards=4`` on the card over ``lubm_like(5)``: once with the
    exchange's device transport over ``[cuda] * 4``, once on its default
    (the host permute on one card), each equal to the unsharded numpy
    engine (checksum, ``facts_inferred``, the ``LUBM_QUERIES`` row sets)
    through the workers' sort and probe kernels; and the distributed
    closure over ``[cuda] * 4`` against its closed form."""
    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.core.distributed import ClosureConfig, DistributedClosure
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import ShardedEngine, decoded_fact_checksum
    from repro_torch.datasets import LUBM_QUERIES, lubm_like
    from repro_torch.distributed.pipeline import FrontierExchange
    facts = lubm_like(5)
    out = []
    for backend, shards, devices in (("numpy", 1, None),
                                     ("torch", 4, [cuda] * 4),
                                     ("torch", 4, None)):
        cfg = EngineConfig.infer1(backend=backend)
        cfg.eval_mode, cfg.shards = "full", shards
        e = HiperfactEngine(cfg)
        if devices is not None:
            e.exchange = FrontierExchange(4, compress=e.exchange.compress,
                                          devices=devices)
        e.add_rules(rdfs_plus_rules())
        kernels.reset_counts()
        e.insert_facts(facts)
        s = e.infer()
        rows = [{tuple(sorted(r.items())) for r in e.query(q)}
                for q in LUBM_QUERIES]
        if shards > 1:
            assert isinstance(e, ShardedEngine)
            assert {log["device"] for log in e.exchange_log} == {
                devices is not None}
            assert all(kernels.LAUNCHES[k] > 0 for k in
                       ("bitonic_sort", "bitonic_sort_kv", "probe_sorted"))
        out.append((s.facts_inferred, rows, decoded_fact_checksum(e)))
    assert out[0] == out[1] == out[2]
    n, hops = 16, 16
    src = np.arange(n * hops) + np.arange(n * hops) // hops
    pairs, iters = DistributedClosure([cuda] * 4, ClosureConfig()).run(
        src, src + 1)
    assert len(pairs) == n * hops * (hops + 1) // 2 and iters == hops


# -- the LM kernels ------------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}


def flash_inputs(cuda, dtype, salt, B, Sq, Skv, Hq, Hkv, hd):
    r = rng(salt, B, Sq, Skv, Hq, hd)
    return [T(r.randn(B, S, H, hd).astype(np.float32)).to(cuda, dtype)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd", [
    (1, 1, 1, 1, 1, 16), (2, 77, 77, 8, 2, 32), (1, 20, 91, 4, 1, 64),
    (2, 130, 130, 32, 4, 128), (1, 50, 13, 2, 2, 16), (1, 33, 33, 12, 1, 16),
    # the tensor-core route's edges in 16 bits: Sq of 1, 63, 64, 65, 130
    # and 2049 around its 128-row tiles and 128-key tiles, Sq < Skv and
    # Sq > Skv, groups of 1, 4 and 8
    (1, 1, 1, 8, 1, 128), (1, 1, 300, 4, 4, 64), (1, 63, 63, 4, 1, 64),
    (2, 64, 100, 8, 8, 128), (1, 65, 65, 8, 1, 64), (1, 130, 40, 8, 2, 128),
    (1, 2049, 2049, 8, 1, 128),
    # the CUDA-core kernel's second instantiation (128 < hd <= 256):
    # recurrentgemma-9b's 16 query heads over one kv head (4 positions a
    # block), ragged lengths both ways, a single query, hd 192 and 132;
    # at 600 and 130 positions the window skips whole kv tiles
    (1, 77, 300, 16, 1, 256), (2, 600, 600, 16, 1, 256),
    (1, 1, 50, 16, 1, 256), (2, 130, 130, 8, 2, 192),
    (1, 300, 77, 4, 4, 192), (1, 65, 65, 2, 1, 132),
    # the tensor-core route's hd-256 tiles (128 rows, 64 keys, 64-row
    # output stores) in 16 bits: Sq and Skv of 1, 63, 64, 65 and 129,
    # Skv < 64, a 4097-position tail past every tile, groups of 1, 8 and
    # 16 (the 17-key window skips whole kv tiles past 64 positions)
    (1, 1, 1, 16, 1, 256), (1, 63, 63, 8, 1, 256), (1, 64, 64, 1, 1, 256),
    (2, 65, 65, 16, 1, 256), (1, 129, 129, 8, 8, 256),
    (1, 1, 129, 16, 1, 256), (1, 129, 63, 16, 1, 256),
    (1, 4097, 4097, 16, 1, 256),
    # phi-3-vision-4.2b's head layout (32/32 heads at hd 96, a group of
    # 1): 16 bits on the tensor-core route's hd-96 tiles (hd 128's over
    # two boxes, the columns past 96 zero-filled), float32 on the
    # CUDA-core kernel
    (2, 600, 600, 32, 32, 96), (1, 77, 300, 32, 32, 96),
    # the hd-96 tiles' edges in 16 bits: Sq and Skv of 1, 63, 64, 65, 129
    # and 2049 around the 128-row and 128-key tiles, Skv < 128 and Sq >
    # Skv, groups of 1, 4 and 8
    (1, 1, 1, 8, 1, 96), (1, 63, 63, 4, 4, 96), (1, 64, 64, 8, 8, 96),
    (2, 65, 65, 4, 1, 96), (1, 129, 129, 8, 1, 96), (1, 1, 129, 4, 1, 96),
    (1, 129, 63, 8, 8, 96), (1, 2049, 2049, 8, 1, 96),
    # the hd-64 kernel's edges in 16 bits (192-row blocks of three
    # warpgroups, 128-key tiles): Sq and Skv of 1, 63, 64, 65, 191, 192,
    # 193, 432 and 1500 (whisper-tiny's prompt and frames), Sq > Skv,
    # groups of 1, 4 and 8; rows that fit one warpgroup over many kv
    # tiles (48 -> 1500, and 432's last tile) split the tiles
    (1, 1, 1, 8, 1, 64), (2, 64, 64, 4, 4, 64), (1, 191, 191, 8, 8, 64),
    (2, 192, 192, 6, 6, 64), (1, 193, 193, 4, 1, 64),
    (1, 193, 65, 8, 1, 64), (1, 65, 193, 8, 8, 64),
    (2, 432, 1500, 6, 6, 64), (1, 1500, 1500, 6, 6, 64),
    (1, 1500, 432, 4, 1, 64), (1, 48, 1500, 8, 1, 64),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_cuda_flash_attention_equals_plain(cuda, B, Sq, Skv, Hq, Hkv, hd,
                                           causal, window, dtype):
    """Ragged lengths, Sq != Skv both ways, groups of 1 to 12 heads;
    float32 within 1e-5 (sums reassociated), bf16 and fp16 within an
    ulp of the output (2e-2, 4e-3).  16-bit inputs at head dim 64, 96,
    128 or 256 take the tensor-core route, the rest (float32, and 16-bit
    inputs at the other head dims up to 256) the CUDA-core one."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        WGMMA_HEAD_DIMS, _route, flash_attention, flash_attention_plain)
    q, k, v = flash_inputs(cuda, dtype, "cflash", B, Sq, Skv, Hq, Hkv, hd)
    before = dict(kernels.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    wgmma = _route(dtype, hd, Hq, Hkv) == "wgmma"
    assert wgmma == (dtype != torch.float32 and hd in WGMMA_HEAD_DIMS)
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + 1)
    assert kernels.LAUNCHES["flash_attention_wgmma"] == (
        before["flash_attention_wgmma"] + wgmma)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,hd,causal", [
    (2, 300, 300, 16, 128, True), (2, 2048, 2048, 16, 128, True),
    (2, 1500, 1500, 6, 64, False), (2, 432, 1500, 6, 64, False),
    (2, 2048, 2048, 32, 96, True)],
    ids=["moonshot-300", "moonshot-2048", "whisper-encoder",
         "whisper-cross", "phi-3-vision"])
def test_cuda_fused_attention_mha_equals_plain(cuda, B, Sq, Skv, H, hd,
                                               causal):
    """The model's entry point at multi-head attention (H query heads
    over H kv heads, a group of 1) in bf16, on the tensor-core route,
    within ``FLASH_TOL``: moonshot-v1-16b-a3b's (16 heads, hd 128,
    causal; 2048 is its prefill length), whisper-tiny's non-causal
    ones (6 heads, hd 64, over 1500 encoder frames: the encoder's own
    rows and a 432-token decoder prompt's cross-attention) and
    phi-3-vision-4.2b's prefill (32 heads, hd 96, causal, 2048
    positions)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import fused_attention
    q, k, v = flash_inputs(cuda, torch.bfloat16, "cmha", B, Sq, Skv, H, H,
                           hd)
    before = dict(kernels.LAUNCHES)
    got = fused_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_wgmma"] == (
        before["flash_attention_wgmma"] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 128), (16, 1, 256),
                                       (32, 32, 96), (6, 6, 64),
                                       (8, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_cuda_flash_attention_wgmma_deterministic(cuda, dtype, Hq, Hkv, hd):
    """The tensor-core route sums in a fixed order (no atomics): two calls
    on the same inputs give bitwise-equal outputs, at hd 128 and on the
    hd-256, hd-96 and hd-64 tiles."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    q, k, v = flash_inputs(cuda, dtype, "cdet", 2, 300, 300, Hq, Hkv, hd)
    before = kernels.LAUNCHES["flash_attention_wgmma"]
    a = flash_attention(q, k, v, causal=True, window=100)
    b = flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_wgmma"] == before + 2
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_misaligned(cuda):
    """TMA reads 16-byte-aligned tensors only: a contiguous view two bytes
    into a buffer raises before any launch."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    n = 1 * 64 * 2 * 64
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    q = buf[1:n + 1].view(1, 64, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    before = dict(kernels.LAUNCHES)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(*args)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,Q,nh,hp,N", [
    (1, 2, 32, 2, 16, 8), (2, 3, 64, 4, 32, 16), (1, 1, 70, 3, 12, 20),
    (1, 2, 256, 4, 64, 128),
    # mamba2-1.3b's full width, the kernel's hp = 128 instance, N = 64,
    # and Q = 70 (no row or column tile divides it) at mamba2's widths
    (2, 8, 256, 64, 64, 128), (1, 2, 256, 4, 128, 128),
    (1, 2, 256, 4, 64, 64), (1, 2, 70, 4, 64, 128),
    # a head shard of mamba2-1.3b's prefill on a 2x4 mesh: 16 of 64 heads
    (1, 8, 256, 16, 64, 128),
])
def test_cuda_ssd_intra_equals_plain(cuda, b, nc, Q, nh, hp, N):
    """Within 1e-4 of max|y| and max|state| (sums over Q and N
    reassociated)."""
    from repro_torch.kernels.ssd.ssd import ssd_intra, ssd_intra_plain
    r = rng("cssd", b, nc, Q, nh, hp, N)
    dlog = -np.abs(r.randn(b, nc, Q, nh)) * 0.05
    ins = [np.cumsum(dlog, axis=2), r.randn(b, nc, Q, nh, hp),
           r.randn(b, nc, Q, N), r.randn(b, nc, Q, N)]
    cum, u, B, C = (T(a.astype(np.float32)).to(cuda) for a in ins)
    before = kernels.LAUNCHES["ssd_intra"]
    y, st = ssd_intra(cum, u, B, C)
    yp, sp = ssd_intra_plain(cum, u, B, C)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ssd_intra"] == before + 1
    for got, want in ((y, yp), (st, sp)):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
def test_cuda_lm_wrappers_reject_bad_input(cuda):
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.ssd.ssd import ssd_intra
    q = torch.zeros(1, 4, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q.half(), q.half())
    for hd in (258, 260, 512):  # past 256, or not a multiple of 4
        with pytest.raises(ValueError):
            z = torch.zeros(1, 4, 2, hd, device=cuda)
            flash_attention(z, z, z)
    with pytest.raises(ValueError):
        flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                        q)
    x = torch.zeros(1, 1, 8, 2, device=cuda)
    with pytest.raises(TypeError):
        ssd_intra(x.double(), torch.zeros(1, 1, 8, 2, 4, device=cuda),
                  torch.zeros(1, 1, 8, 3, device=cuda),
                  torch.zeros(1, 1, 8, 3, device=cuda))


def scan_reference(a, b, h0):
    """The RG-LRU recurrence h_t = a_t h_{t-1} + b_t stepped in float64
    on the host."""
    h = np.zeros(a[:, 0].shape) if h0 is None else h0.astype(np.float64)
    out = np.empty(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", [
    (1, 1, 32), (2, 7, 40), (2, 127, 33), (2, 129, 96), (1, 1000, 64),
    # recurrentgemma-9b's prefill: 2 prompts of 4096 tokens, d = 4096,
    # and a channel shard of it on a 2x4 mesh: one prompt, 1024 channels
    (2, 4096, 4096), (1, 4096, 1024)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_linear_scan_equals_plain(cuda, B, S, D, with_h0):
    """Within 1e-5 of max(1, max|h|) of the plain passes on the card and
    of the recurrence in float64 (both sum the same terms in another
    order in float32); decays from U(0.9, 1), so the state carries over
    the whole sequence."""
    from repro_torch.kernels.rglru_scan.scan import (linear_scan,
                                                     linear_scan_plain)
    r = rng("cscan", B, S, D, with_h0)
    a = r.uniform(0.9, 1.0, (B, S, D)).astype(np.float32)
    b = r.randn(B, S, D).astype(np.float32)
    h0 = r.randn(B, D).astype(np.float32) if with_h0 else None
    ta, tb = T(a).to(cuda), T(b).to(cuda)
    th = None if h0 is None else T(h0).to(cuda)
    before = kernels.LAUNCHES["linear_scan"]
    got = linear_scan(ta, tb, th)
    plain = linear_scan_plain(ta, tb, th)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linear_scan"] == before + 1
    want = scan_reference(a, b, h0)
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float((got - plain).abs().max()) <= bound
    assert float(np.abs(got.double().cpu().numpy() - want).max()) <= bound


@pytest.mark.cuda
def test_cuda_linear_scan_rejects_bad_input(cuda):
    """A gradient (the kernel has no backward), another dtype, a strided
    input or mismatched shapes raise and launch nothing; under
    ``torch.no_grad()`` the same inputs launch."""
    from repro_torch.kernels.rglru_scan.scan import linear_scan
    a = torch.rand(2, 40, 8, device=cuda)
    b = torch.randn(2, 40, 8, device=cuda)
    before = kernels.LAUNCHES["linear_scan"]
    with pytest.raises(RuntimeError, match="training route"):
        linear_scan(a.clone().requires_grad_(), b)
    with pytest.raises(TypeError):
        linear_scan(a.double(), b.double())
    with pytest.raises(ValueError):
        linear_scan(a.transpose(0, 1).contiguous().transpose(0, 1), b)
    with pytest.raises(ValueError):
        linear_scan(a, b, torch.zeros(8, 2, device=cuda))
    with pytest.raises(ValueError):
        linear_scan(a, b.cpu())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linear_scan"] == before
    with torch.no_grad():
        linear_scan(a.clone().requires_grad_(), b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linear_scan"] == before + 1


@pytest.mark.cuda
def test_cuda_recurrentgemma_scan_launches(cuda):
    """recurrentgemma-9b's smoke config on the card: the prefill and a
    check forward (``hidden``) launch the scan kernel once per RG-LRU
    block each, 2 x its RG-LRU layers, and equal the CPU's logits within
    1e-4 of their scale (float32); a training step (B 2 x 64, past the
    32-key window) launches no kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.config import BlockKind
    from repro_torch.models.params import tree_map
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              dtype="float32")
    n_rec = sum(k == BlockKind.RECURRENT for k in cfg.block_kinds())
    assert n_rec > 0
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    r = rng("cscan-rg")
    for blk in (*p_cpu["blocks"].values(), *p_cpu.get("tail", [])):
        if "rglru" in blk:  # zero taps at init: the conv would give 0
            for k in ("conv_w", "conv_b"):
                blk["rglru"][k] = T((r.randn(*blk["rglru"][k].shape) * 0.5)
                                    .astype(np.float32))
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = T(r.randint(0, cfg.vocab, (2, 64)).astype(np.int32))
    kernels.reset_counts()
    with torch.no_grad():
        logits, _ = gpu.prefill_fn(p_gpu, toks[:, :40].to(cuda), 48)
        gpu.hidden(p_gpu, toks[:, :40].to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linear_scan"] == 2 * n_rec
    want, _ = cpu.prefill_fn(p_cpu, toks[:, :40], 48)
    assert float((logits.cpu() - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))
    kernels.reset_counts()
    batch = {k: toks.to(cuda) for k in ("tokens", "labels")}
    step = build_train_step(gpu, OptimizerConfig())
    _, met = step(init_train_state(p_gpu), batch)
    torch.cuda.synchronize()
    assert torch.isfinite(torch.as_tensor(float(met["loss"])))
    assert not any(kernels.counts()["launches"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_apply_moe_equals_cpu(cuda, dtype, cf):
    """The MoE layer (router, dispatch, experts, combine; stock torch
    ops) at moonshot's smoke width on the card against the same call on
    the CPU, at capacity factors where no pair drops (4.0) and where
    pairs drop (1.0, 0.5): no host sync inside the call on the card, the
    same pairs dropped, y within 1e-5 in float32 and 3e-2 * max(1,
    scale) in bfloat16, aux within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, moe
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", smoke=True),
                              dtype=dtype, capacity_factor=cf)
    p_cpu = init_params(moe.moe_spec(cfg), 0, device="cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = T(rng("cmoe", cf).randn(2, 64, cfg.d_model).astype(
        np.float32)).to(tdt)
    outs = []
    for params, dev in ((p_gpu, cuda), (p_cpu, "cpu")):
        moe.reset_dropped()
        xd = x.to(dev)
        # the layer makes no host sync on the card (its drop count stays
        # on the device until read)
        torch.cuda.set_sync_debug_mode("error" if dev == cuda else 0)
        try:
            y, aux = moe.apply_moe(params, xd, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append((y.float().cpu(), float(aux), moe.dropped_pairs()))
    (y, aux, dropped), (y_cpu, aux_cpu, dropped_cpu) = outs
    assert dropped == dropped_cpu and (dropped > 0) == (cf < 4.0), dropped
    scale = float(y_cpu.abs().max())
    tol = 1e-5 if dtype == "float32" else 3e-2 * max(1.0, scale)
    assert float((y - y_cpu).abs().max()) <= tol
    assert abs(aux - aux_cpu) <= 1e-6


@pytest.mark.cuda
def test_cuda_init_params_16bit_store(cuda, monkeypatch):
    """``store=cfg.dtype`` on the card, each 16-bit leaf drawn one slice
    of its leading dim at a time: seeded, the cast leaves in bf16 and
    the rest in float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params, params
    from repro_torch.models.params import is_leaf_spec, tree_leaves
    monkeypatch.setattr(params, "_DRAW_ELEMS", 1)
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    spec = build_model(cfg).spec()
    a, b = (init_params(spec, 5, store=cfg.dtype) for _ in range(2))
    for s, x, y in zip(tree_leaves(spec, is_leaf_spec), tree_leaves(a),
                       tree_leaves(b)):
        assert x.is_cuda and tuple(x.shape) == s.shape
        assert x.dtype == (torch.bfloat16 if s.cast else torch.float32)
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b",
                                  "recurrentgemma-9b",
                                  "moonshot-v1-16b-a3b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_cuda_model_equals_cpu(cuda, arch, dtype):
    """A smoke model's prefill (a 40-token prompt: the attention kernel's
    branch, whole SSD chunks plus a pad, a full 32-slot ring for the
    hybrid's local attention, the MoE dispatch at moonshot's capacity
    factor of 4.0, whisper's 16 encoder frames, phi-3-vision's 8 patches
    in front) and two decode steps on the card (whisper's without a host
    sync), against
    the same weights on the CPU: float32 within 1e-4 of the logits'
    scale, bfloat16 within 3e-2 * max(1, scale).  One prefill forward
    launches its kernel once per attention (or SSD) layer; whisper's
    once per decoder layer for its self-attention and once for its
    cross-attention (16 frames take the encoder's full attention)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    r = rng("ctaps")
    # zero taps at init: every SSM block would give 0, every RG-LRU
    # block's conv its bias alone
    for blk in (*p_cpu.get("blocks", {}).values(), *p_cpu.get("tail", [])):
        for name in ("ssm", "rglru"):
            if name not in blk:
                continue
            for k in ("conv_w", "conv_b"):
                blk[name][k] = T((r.randn(*blk[name][k].shape) * 0.5)
                                 .astype(np.float32))
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = T(rng("cmodel", arch).randint(0, cfg.vocab, (2, 42)).astype(
        np.int32))
    extra, pre = {}, 0
    if cfg.family == "encdec":
        extra["frames"] = T((rng("cframes").randn(2, cfg.enc_seq, cfg.d_model)
                             * 0.02).astype(np.float32))
    if cfg.family == "vlm":
        pre = cfg.n_patches
        extra["patches"] = T((rng("cpatches").randn(2, pre, cfg.d_model)
                              * 0.02).astype(np.float32))
    kernels.reset_counts()
    outs = []
    for model, params, dev in ((gpu, p_gpu, cuda), (cpu, p_cpu, "cpu")):
        t = toks.to(dev)
        kw = {k: x.to(dev) for k, x in extra.items()}
        logits, cache = model.prefill_fn(params, t[:, :40], pre + 48, **kw)
        steps = [logits]
        # whisper's decode step makes no host sync on the card (no RoPE;
        # its sinusoidal row is gathered by the device tensor ``lens``)
        quiet = dev == cuda and cfg.family == "encdec"
        for i in (40, 41):
            torch.cuda.set_sync_debug_mode("error" if quiet else 0)
            try:
                logits, cache = model.decode_fn(params, t[:, i], cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            steps.append(logits)
        outs.append([x.float().cpu() for x in steps])
    torch.cuda.synchronize()
    from repro_torch.models.config import BlockKind
    kinds = cfg.block_kinds()
    name = "ssd_intra" if cfg.family == "ssm" else "flash_attention"
    n = sum(k in (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.SSM,
                  BlockKind.MOE) for k in kinds)
    if cfg.family == "encdec":
        n *= 2  # self- and cross-attention in each decoder layer
    assert kernels.LAUNCHES[name] == n  # one prefill forward
    # and the hybrid's RG-LRU blocks the scan kernel, once each
    assert kernels.LAUNCHES["linear_scan"] == sum(
        k == BlockKind.RECURRENT for k in kinds)
    for got, want in zip(*outs):
        scale = float(want.abs().max())
        bound = 1e-4 * scale if dtype == "float32" else 3e-2 * max(1.0,
                                                                    scale)
        assert float((got - want).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flash_attention", "ssd_intra"])
def test_cuda_lm_kernels_refuse_a_gradient(cuda, route):
    """The attention and SSD kernels have no backward: a CUDA input that
    requires grad raises (naming the training route) and launches
    nothing, where a silent launch would drop the gradient; the same
    inputs under ``torch.no_grad()`` launch the kernel, and CPU inputs
    that require grad run the plain version, which autograd
    differentiates."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.ssd.ssd import ssd_intra
    r = rng("refuse", route)
    if route == "flash_attention":
        args = [T(r.randn(1, 40, 4, 64).astype(np.float32)).to(torch.bfloat16)
                for _ in range(3)]
        fn = flash_attention
    else:
        b, nc, Q, nh, hp, N = 1, 2, 32, 2, 16, 16
        args = [T(np.cumsum(-np.abs(r.randn(b, nc, Q, nh)), 2)
                  .astype(np.float32)),
                T(r.randn(b, nc, Q, nh, hp).astype(np.float32)),
                T(r.randn(b, nc, Q, N).astype(np.float32)),
                T(r.randn(b, nc, Q, N).astype(np.float32))]
        fn = ssd_intra
    dev = [a.to(cuda).requires_grad_() for a in args]
    before = kernels.LAUNCHES[route]
    with pytest.raises(RuntimeError, match="training route"):
        fn(*dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == before
    with torch.no_grad():
        out = fn(*dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[route] == before + 1
    cpu = [a.requires_grad_() for a in args]
    got = fn(*cpu)
    loss = sum(x.float().sum() for x in (got if isinstance(got, tuple)
                                        else (got,)))
    loss.backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in cpu)
    assert kernels.LAUNCHES[route] == before + 1
    del out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-7b", "starcoder2-15b",
                                  "mistral-large-123b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b",
                                  "mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-tiny", "phi-3-vision-4.2b"])
def test_cuda_grads_equal_cpu(cuda, arch):
    """A smoke model's loss and every gradient leaf on the card against
    the same weights and batch on the CPU, in float32 with TF32 off: B = 2
    sequences of 64 positions (attention's chunked branch, two SSD
    chunks, the hybrid past its 32-key window), loss to 1e-5, each leaf
    to 1e-4 of its largest entry or of 1e-3 of the largest over all
    leaves where that is more.  The training route launches no kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import loss_and_grads
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    r = rng("cgrad", arch)
    for blk in (*p_cpu.get("blocks", {}).values(), *p_cpu.get("tail", [])):
        for name in ("ssm", "rglru"):
            if name in blk:
                for k in ("conv_w", "conv_b"):
                    blk[name][k] = T((r.randn(*blk[name][k].shape) * 0.5)
                                     .astype(np.float32))
    St = 64 - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {k: T(r.randint(0, cfg.vocab, (2, St)).astype(np.int32))
             for k in ("tokens", "labels")}
    batch["labels"][:, ::7] = -1
    if cfg.family == "vlm":
        batch["patches"] = T((r.randn(2, cfg.n_patches, cfg.d_model)
                              * 0.02).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = T((r.randn(2, cfg.enc_seq, cfg.d_model)
                             * 0.02).astype(np.float32))
    kernels.reset_counts()
    got = loss_and_grads(gpu, tree_map(lambda x: x.to(cuda), p_cpu),
                         {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert not any(kernels.counts()["launches"].values())
    want = loss_and_grads(cpu, p_cpu, batch)
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * max(
        1.0, abs(float(want[0])))
    gl, wl = tree_leaves(got[2]), tree_leaves(want[2])
    top = max(float(w.abs().max()) for w in wl)
    for g, w in zip(gl, wl):
        assert g.is_cuda and g.shape == w.shape
        bound = 1e-4 * max(float(w.abs().max()), 1e-3 * top)
        assert float((g.cpu() - w).abs().max()) <= bound


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip(cuda, tmp_path):
    """A tree of CUDA tensors saves and restores bit for bit onto the
    card, each leaf with its dtype (the 0-d int32 ``step`` too)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.params import tree_leaves
    r = rng("ckpt")
    t = {"params": {"w": T(r.randn(64, 32).astype(np.float32)).to(cuda),
                    "ids": T(r.randint(0, 9, 7).astype(np.int64)).to(cuda)},
         "opt": {"m": [torch.zeros(5, device=cuda),
                       torch.full((3,), 0.5, device=cuda)],
                 "step": torch.tensor(11, dtype=torch.int32, device=cuda)}}
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, t)
    got = cm.restore(3, t)
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert b.is_cuda and b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_save_async_snapshot_survives_in_place_update(cuda, tmp_path):
    """``save_async`` returns holding a host copy of every CUDA leaf:
    AdamW-style in-place writes queued right after it (on the card's
    stream, before the write thread runs) do not reach the checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.params import tree_leaves
    r = rng("ckpt-async")
    t = {"p": [T(r.randn(1 << 20).astype(np.float32)).to(cuda)
               for _ in range(4)],
         "step": torch.tensor(2, dtype=torch.int32, device=cuda)}
    before = [x.cpu() for x in tree_leaves(t)]
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(1, t)
    for x in tree_leaves(t):
        x.add_(1)
    cm.wait()
    got = cm.restore(1, t)
    for a, b in zip(before, tree_leaves(got)):
        assert b.is_cuda and torch.equal(b.cpu(), a)


# -- the LM's sharded forms over one card's device list -------------------------


def cuda_mesh(cuda, shape=(2, 4), axes=("data", "model")):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(shape, axes, devices=["cuda:0"] * int(
        np.prod(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b",
                                  "mamba2-1.3b", "recurrentgemma-9b"])
def test_cuda_sharded_forms_equal_cpu(cuda, arch):
    """A smoke model on a 2x4 mesh over ``[cuda:0] * 8`` (float32, B 4,
    64 positions): its loss, prefill (the KV cache split over ``model``)
    and two decode steps against the single-device model on the CPU on
    the same weights, within 1e-4 of the scale; the sharded prefill
    launches its kernels on every shard (``R * M`` a layer): attention
    on every head shard, the SSD on every head shard, the RG-LRU scan on
    every channel shard."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (activation_hints,
                                                  shardings_for)
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    mesh = cuda_mesh(cuda)
    model = build_model(cfg, activation_hints(cfg, mesh, 4, "train"))
    p_gpu = tree_map(lambda x, sh: sh.place(x.to(cuda)), p_cpu,
                     shardings_for(cpu.spec(), mesh))
    r = rng("csharded", arch)
    toks = T(r.randint(0, cfg.vocab, (4, 64)).astype(np.int32))
    batch = {"tokens": toks, "labels": T(r.randint(0, cfg.vocab, (4, 64))
                                         .astype(np.int32))}
    outs = []
    for m, p, dev in ((model, p_gpu, cuda), (cpu, p_cpu, "cpu")):
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = m.loss_fn(p, b)
        kernels.reset_counts()
        with torch.no_grad():
            logits, cache = m.prefill_fn(p, b["tokens"][:, :62], 64)
        launched = dict(kernels.LAUNCHES)
        steps = [loss, logits]
        for i in (62, 63):
            logits, cache = m.decode_fn(p, b["tokens"][:, i], cache)
            steps.append(logits)
        outs.append([x.float().cpu() for x in steps])
        if dev == cuda:
            kinds = [k.value for k in cfg.block_kinds()]
            per = {"ssd_intra": kinds.count("ssm"),
                   "linear_scan": kinds.count("rglru"),
                   "flash_attention": len(kinds) - kinds.count("ssm")
                   - kinds.count("rglru")}
            for name, n in per.items():   # R * M a layer
                assert launched[name] == 8 * n, name
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_sharded_train_step_equals_cpu(cuda):
    """The FSDP+TP step (qwen2-7b smoke, float32, B 8 x S 64) on a 2x4
    mesh over ``[cuda:0] * 8`` against the single-device step on the CPU:
    the loss within 1e-4, the params within 1e-5 where the gradient is
    not float32 noise and within 2 lr everywhere (AdamW's first step is
    about ``lr * sign(g)``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (activation_hints,
                                                  is_sharded, shardings_for)
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state, loss_and_grads)
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              dtype="float32")
    cpu = build_model(cfg, device="cpu")
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    mesh = cuda_mesh(cuda)
    model = build_model(cfg, activation_hints(cfg, mesh, 8, "train"))
    p_gpu = tree_map(lambda x, sh: sh.place(x.to(cuda)), p_cpu,
                     shardings_for(cpu.spec(), mesh))
    r = rng("cstep")
    batch = {k: T(r.randint(0, cfg.vocab, (8, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    _, _, g = loss_and_grads(cpu, p_cpu, batch)
    top = max(float(x.abs().max()) for x in tree_leaves(g))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    s0, m0 = build_train_step(cpu, opt)(init_train_state(p_cpu), batch)
    s1, m1 = build_train_step(model, opt)(
        init_train_state(p_gpu), {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(m1["loss"]) - float(m0["loss"])) < 1e-4
    for a, b, gl in zip(tree_leaves(tree_map(
            lambda x: x.gather("cpu"), s1["params"], is_leaf=is_sharded)),
            tree_leaves(s0["params"]), tree_leaves(g)):
        d = (a - b).abs()
        noise = gl.abs() <= 1e-5 * max(float(gl.abs().max()), 1e-3 * top)
        assert float(torch.where(noise, 0.0, d).max()) <= 1e-5
        assert float(d.max()) <= 2e-3 + 1e-6


@pytest.mark.cuda
def test_cuda_pipeline_and_compressed_step(cuda):
    """``pipeline_apply`` over ``[cuda:0] * 4`` against the sequential
    loop (1e-5), and the int8 compressed step over ``data 8`` on the card
    against the same step on ``[cpu] * 8`` (loss within 1e-4, params
    within 2 lr: an int8 code may flip at a near-tie)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig,
                                   build_dp_compressed_step,
                                   init_compressed_state)
    r = rng("cpipe")
    W = T((r.randn(8, 16, 16) * 0.2).astype(np.float32)).to(cuda)
    h = T(r.randn(8, 16).astype(np.float32)).to(cuda)
    want = h
    for i in range(8):
        want = torch.tanh(want @ W[i])
    got = pipeline_apply(lambda w, x: torch.tanh(x @ w), W, h,
                         mesh=cuda_mesh(cuda, (4,), ("pod",)), n_stages=4,
                         n_micro=4, axis="pod")
    assert float((got - want).abs().max()) <= 1e-5
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              dtype="float32")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {k: T(r.randint(0, cfg.vocab, (8, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    p_cpu = init_params(build_model(cfg, device="cpu").spec(), 0,
                        device="cpu")
    runs = []
    for dev, mesh in ((cuda, cuda_mesh(cuda, (8,), ("data",))),
                      ("cpu", make_host_mesh((8,), ("data",),
                                             devices=["cpu"] * 8))):
        params = tree_map(lambda x: x.to(dev), p_cpu)
        model = build_model(cfg, device=dev)
        s, m = build_dp_compressed_step(model, opt, mesh)(
            init_compressed_state(params, 8, mesh),
            {k: v.to(dev) for k, v in batch.items()})
        runs.append((float(m["loss"]), [x.cpu() for x in tree_leaves(
            s["params"])]))
    assert abs(runs[0][0] - runs[1][0]) < 1e-4
    for a, b in zip(runs[0][1], runs[1][1]):
        assert float((a - b).abs().max()) <= 2e-3 + 1e-6
