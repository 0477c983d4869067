"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Each test carries the ``cuda`` marker and skips where torch sees no CUDA
device; on a card (``python -m pytest -m cuda tests/test_torch_cuda.py``)
each integer kernel must give bit-identical output to its plain version
and each float kernel must agree with its plain version within a stated
tolerance — the plain versions are held against the reference Pallas
kernels on the CPU by ``test_torch_kernels.py`` and
``test_torch_lm_kernels.py``.  The LM models' prefill and decode on the
card are held against the same models' CPU runs.  This file imports nothing of JAX, so it
runs where only the port is installed.
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
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_cuda_flash_attention_equals_plain(cuda, B, Sq, Skv, Hq, Hkv, hd,
                                           causal, window, dtype):
    """Ragged lengths, Sq != Skv both ways, groups of 1 to 12 heads;
    float32 within 1e-5 (sums reassociated), bf16 and fp16 within an
    ulp of the output (2e-2, 4e-3).  16-bit inputs at head dim 64 or 128
    take the tensor-core route, the rest the CUDA-core one."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _route, flash_attention, flash_attention_plain)
    q, k, v = flash_inputs(cuda, dtype, "cflash", B, Sq, Skv, Hq, Hkv, hd)
    before = dict(kernels.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    wgmma = _route(dtype, hd, Hq, Hkv) == "wgmma"
    assert wgmma == (dtype != torch.float32 and hd in (64, 128))
    assert kernels.LAUNCHES["flash_attention"] == (
        before["flash_attention"] + 1)
    assert kernels.LAUNCHES["flash_attention_wgmma"] == (
        before["flash_attention_wgmma"] + wgmma)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_cuda_flash_attention_wgmma_deterministic(cuda, dtype):
    """The tensor-core route sums in a fixed order (no atomics): two calls
    on the same inputs give bitwise-equal outputs."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    q, k, v = flash_inputs(cuda, dtype, "cdet", 2, 300, 300, 8, 2, 128)
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
    with pytest.raises(ValueError):  # head dim over 128
        z = torch.zeros(1, 4, 2, 256, device=cuda)
        flash_attention(z, z, z)
    with pytest.raises(ValueError):
        flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                        q)
    x = torch.zeros(1, 1, 8, 2, device=cuda)
    with pytest.raises(TypeError):
        ssd_intra(x.double(), torch.zeros(1, 1, 8, 2, 4, device=cuda),
                  torch.zeros(1, 1, 8, 3, device=cuda),
                  torch.zeros(1, 1, 8, 3, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_cuda_model_equals_cpu(cuda, arch, dtype):
    """A smoke model's prefill (a 40-token prompt: the attention kernel's
    branch, whole SSD chunks plus a pad) and two decode steps on the
    card, against the same weights on the CPU: float32 within 1e-4 of
    the logits' scale, bfloat16 within 3e-2 * max(1, scale)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    p_cpu = init_params(cpu.spec(), 0, device="cpu")
    if cfg.family == "ssm":  # zero taps at init: every block would give 0
        ssm = p_cpu["blocks"]["b0"]["ssm"]
        r = rng("ctaps")
        for k in ("conv_w", "conv_b"):
            ssm[k] = T((r.randn(*ssm[k].shape) * 0.5).astype(np.float32))
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    toks = T(rng("cmodel", arch).randint(0, cfg.vocab, (2, 42)).astype(
        np.int32))
    kernels.reset_counts()
    outs = []
    for model, params, dev in ((gpu, p_gpu, cuda), (cpu, p_cpu, "cpu")):
        t = toks.to(dev)
        logits, cache = model.prefill_fn(params, t[:, :40], 48)
        steps = [logits]
        for i in (40, 41):
            logits, cache = model.decode_fn(params, t[:, i], cache)
            steps.append(logits)
        outs.append([x.float().cpu() for x in steps])
    torch.cuda.synchronize()
    name = "flash_attention" if cfg.family == "dense" else "ssd_intra"
    assert kernels.LAUNCHES[name] == cfg.n_layers  # one prefill forward
    for got, want in zip(*outs):
        scale = float(want.abs().max())
        bound = 1e-4 * scale if dtype == "float32" else 3e-2 * max(1.0,
                                                                    scale)
        assert float((got - want).abs().max()) <= bound
