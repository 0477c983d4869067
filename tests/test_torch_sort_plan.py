"""The CUDA sort kernels' launch plan, held against the network (CPU).

``csrc/bitonic_sort.cu`` regroups the bitonic network's ``(k, j)`` passes
into tile launches (shared-memory sub-networks, warp levels, register
levels) and fused cross-tile launches; ``sortmerge.launch_plan`` mirrors
that grouping.  Here the plan, flattened, must be ``_passes`` in order, and
applying each group as the kernel does (a sub-network of ``2**r`` elements
at ``base + m * j / 2**(r-1)`` gathered, put through ``r`` levels and
scattered back) must give exactly the plain versions' output, the payload
order of tied keys included.  The kernels themselves are held against the
plain versions on a card (``test_torch_cuda.py``).
"""

import importlib.util
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.sortmerge import sortmerge
from repro_torch.kernels.sortmerge.sortmerge import (
    SORT_CROSS_LEVELS, SORT_FUSE, SORT_KV_REG, SORT_KV_TILE,
    SORT_LOWER_TIERS, SORT_MIN_TILES,
    SORT_REG, SORT_TILE, _pad_pow2, _passes, bitonic_sort_kv_plain,
    bitonic_sort_plain, launch_plan, sort_tier)

CU = (Path(sortmerge.__file__).resolve().parents[1] / "csrc"
      / "bitonic_sort.cu")

# (tile, register width, register-fused levels, levels of a cross launch):
# the kernels' own tiers, then others
CONFIGS = [(SORT_TILE, SORT_REG, SORT_FUSE, SORT_CROSS_LEVELS),
           (SORT_KV_TILE, SORT_KV_REG, SORT_FUSE, SORT_CROSS_LEVELS),
           *((tile, reg, SORT_FUSE, SORT_CROSS_LEVELS)
             for tile, reg in SORT_LOWER_TIERS),
           (1 << 14, 16, 1, 1), (1 << 13, 8, 3, 3), (1 << 12, 8, 2, 6),
           (1 << 11, 4, 4, 4), (1 << 10, 2, 4, 9), (1 << 9, 16, 2, 5),
           (1 << 14, 32, 4, 7), (1 << 13, 32, 3, 8)]


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def flat(plan):
    return [lv for _, steps in plan for _, levels in steps for lv in levels]


def test_constants_match_the_cuda_source():
    """Every constant of the kernel that decides the grouping equals its
    mirror: tiers, fusion, the levels per barrier and cross_smem's block."""
    src = CU.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", src, re.M)}
    want = {"SORT_TILE_LOG2": SORT_TILE.bit_length() - 1,
            "SORT_REG_LOG2": SORT_REG.bit_length() - 1,
            "SORT_KV_TILE_LOG2": SORT_KV_TILE.bit_length() - 1,
            "SORT_KV_REG_LOG2": SORT_KV_REG.bit_length() - 1,
            "SORT_FUSE": SORT_FUSE, "SORT_MIN_TILES": SORT_MIN_TILES,
            "SORT_CROSS_LEVELS": SORT_CROSS_LEVELS,
            "SMEM_LEVELS": sortmerge._SMEM_LEVELS,
            "XS_THREADS": sortmerge._XS_THREADS,
            "XS_REG_LOG2": sortmerge._XS_REG_LOG2}
    assert {k: consts.get(k) for k in want} == want
    assert sortmerge._CROSS_BLOCK == consts["XS_THREADS"] << consts[
        "XS_REG_LOG2"]
    assert "#ifndef" not in src and "#define" not in src
    lower = re.search(r"LOWER_TIERS\[\]\[2\] = \{(.*)\};", src).group(1)
    assert [tuple(map(int, t)) for t in re.findall(r"\{(\d+), (\d+)\}",
                                                    lower)] == [
        (t.bit_length() - 1, r.bit_length() - 1) for t, r in SORT_LOWER_TIERS]


def global_kernels(source: Path) -> set:
    """Names of the ``__global__`` functions of a CUDA source."""
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
        r"\s*)?(\w+)\s*\(", source.read_text()))


def test_profiles_name_every_engine_kernel():
    """chip_smoke.py sums the device time of the port's engine kernels and
    of the sorts by kernel name: every ``__global__`` of their sources is
    named there, and nothing else."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csrc = CU.parent
    assert global_kernels(CU) == set(smoke.SORT_KERNELS) == {
        "tile_network", "cross_fused", "cross_smem"}
    engine = set().union(*(global_kernels(csrc / f) for f in (
        "bitonic_sort.cu", "probe_sorted.cu", "merge_ranks.cu",
        "unique_mask.cu")))
    assert engine == set(smoke.OUR_KERNELS)
    assert all(smoke.is_sort_kernel(f"void (anonymous namespace)::{k}<long "
                                    "long, true>(long long*, int*, long)")
               for k in smoke.SORT_KERNELS)
    assert not any(smoke.is_sort_kernel(k) for k in smoke.OUR_KERNELS[3:])


@pytest.mark.parametrize("n,kv,tier", [
    (1 << 21, False, (1 << 14, 32)), (1 << 22, False, (1 << 14, 32)),
    (1 << 20, False, (1 << 13, 16)), (1 << 19, False, (1 << 12, 16)),
    (1 << 18, False, (1 << 10, 8)), (2, False, (1 << 10, 8)),
    (1 << 21, True, (1 << 13, 16)), (1 << 20, True, (1 << 13, 16)),
    (1 << 19, True, (1 << 12, 16)), (1 << 18, True, (1 << 10, 8)),
    (1 << 13, True, (1 << 10, 8))])
def test_sort_tier_by_size(n, kv, tier):
    """The tier fills the card: n holds SORT_MIN_TILES tiles of it, or it
    is the smallest."""
    assert sort_tier(n, kv) == tier
    plan = launch_plan(n, kv=kv)
    assert flat(plan) == list(_passes(n))
    # cross launches take shared-memory groups only from 2^20 elements
    if n < 1 << 20:
        assert all(where != "smem" for kind, steps in plan if kind == "cross"
                   for where, _ in steps)


@pytest.mark.parametrize("tile,reg,fuse,cross", CONFIGS)
def test_plan_flattens_to_the_network(tile, reg, fuse, cross):
    for lg in range(1, 23):
        n = 1 << lg
        plan = launch_plan(n, tile, reg, fuse, cross_levels=cross)
        assert flat(plan) == list(_passes(n)), n
        for kind, steps in plan:
            for where, levels in steps:
                k = levels[0][0]
                assert all(kk == k for kk, _ in levels)
                js = [j for _, j in levels]
                assert js == [js[0] >> m for m in range(len(js))]
                if where == "cross":
                    assert kind == "cross" and len(steps) == 1
                    assert 1 <= len(js) <= fuse and js[-1] >= tile
                elif kind == "cross":  # shared-memory groups of a launch
                    run = [j for _, lv in steps for _, j in lv]
                    assert fuse < len(run) <= cross and run[-1] >= tile
                    assert 1 <= len(js) <= 4
                elif where == "smem":
                    assert 1 <= len(js) <= min(reg.bit_length() - 1, 4)
                    assert js[-1] >= 32 * reg and js[0] < tile
                elif where == "shuffle":
                    assert reg <= js[-1] and js[0] < 32 * reg
                else:
                    assert js[0] < reg and js[-1] == 1
        if n <= tile:
            assert len(plan) == 1


@pytest.mark.parametrize("n,tile,fuse,cross,launches", [
    (1 << 21, 1 << 14, 4, 9, 15),   # keys at the table shape
    (1 << 21, 1 << 14, 4, 4, 18),   # ... with register-fused launches only
    (1 << 20, 1 << 13, 4, 9, 15),   # key-value pairs, a 2^13 tile
    (1 << 20, 1 << 13, 4, 4, 18),
    (1 << 20, 1 << 14, 4, 4, 15),   # key-value pairs, a 2^14 tile
    (1 << 18, 1 << 10, 4, 9, 17),   # 2^18 with shared-memory cross launches
    (1 << 18, 1 << 10, 4, 4, 21),   # ... and as the kernel runs it
    (1 << 21, 1 << 12, 1, 1, 55),   # the first design: 4096 tile, no fusion
    (1 << 20, 1 << 12, 1, 1, 45),
    (1 << 14, 1 << 14, 4, 9, 1),    # n <= tile: one launch
    (2, 1 << 14, 4, 9, 1)])
def test_plan_launch_counts(n, tile, fuse, cross, launches):
    assert len(launch_plan(n, tile, 16, fuse, cross_levels=cross)) == launches


def _level(kp, vp, k, j):
    """One pass (k, j) as the plain key-value version runs it."""
    idx = torch.arange(kp.shape[0])
    part = idx ^ j
    pk, pv = kp[part], vp[part]
    is_lo = (idx & j) == 0
    a = torch.where(is_lo, kp, pk)
    b = torch.where(is_lo, pk, kp)
    swap = torch.where((idx & k) == 0, a > b, a < b)
    return torch.where(swap, pk, kp), torch.where(swap, pv, vp)


def _subnets(kp, vp, levels):
    """Levels j, j/2, ... of stage k applied as the kernel applies a fused
    group: sub-network q holds base + m*s, s = j / 2^(r-1)."""
    n, r = kp.shape[0], len(levels)
    k, j = levels[0]
    s, width = j >> (r - 1), 1 << r
    q = torch.arange(n >> r)
    base = ((q & ~(s - 1)) << r) | (q & (s - 1))
    pos = base[:, None] + torch.arange(width)[None, :] * s
    # the sub-networks cover the array exactly once
    assert torch.equal(torch.sort(pos.flatten()).values, torch.arange(n))
    x, v = kp[pos].clone(), vp[pos].clone()
    asc = (base & k) == 0
    h = width // 2
    while h >= 1:
        for m in range(width):
            if m & h:
                continue
            a, b = x[:, m].clone(), x[:, m | h].clone()
            va, vb = v[:, m].clone(), v[:, m | h].clone()
            sw = torch.where(asc, a > b, a < b)
            x[:, m], x[:, m | h] = torch.where(sw, b, a), torch.where(sw, a, b)
            v[:, m], v[:, m | h] = (torch.where(sw, vb, va),
                                    torch.where(sw, va, vb))
        h //= 2
    kp, vp = kp.clone(), vp.clone()
    kp[pos], vp[pos] = x, v
    return kp, vp


def apply_plan(keys, vals, plan):
    for _, steps in plan:
        for where, levels in steps:
            if where in ("cross", "smem"):
                keys, vals = _subnets(keys, vals, levels)
            else:
                for k, j in levels:
                    keys, vals = _level(keys, vals, k, j)
    return keys, vals


def padded(x, fill):
    return _pad_pow2(torch.from_numpy(np.ascontiguousarray(x)), fill)


@pytest.mark.parametrize("tile,reg,fuse,cross", CONFIGS)
@pytest.mark.parametrize("n", [3, 64, 1000, (1 << 13) + 5, (1 << 15) - 7])
def test_plan_applied_equals_plain_kv(tile, reg, fuse, cross, n):
    r = rng("plan-kv", n, tile, reg, fuse)
    mx = np.iinfo(np.int64).max
    k = r.randint(0, 40, n).astype(np.int64)      # many ties
    k[r.choice(n, min(n, 3), replace=False)] = mx  # real keys at the pad
    v = r.permutation(n).astype(np.int32)
    kp, vp = padded(k, mx), padded(v, 0)
    gk, gv = apply_plan(kp, vp, launch_plan(kp.shape[0], tile, reg, fuse,
                                            cross_levels=cross))
    wk, wv = bitonic_sort_kv_plain(torch.from_numpy(k), torch.from_numpy(v))
    assert torch.equal(gk[:n], wk) and torch.equal(gv[:n], wv)


@pytest.mark.parametrize("tile,reg,fuse,cross", CONFIGS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plan_applied_equals_plain_keys(tile, reg, fuse, cross, dtype):
    n = (1 << 14) + 3
    r = rng("plan-keys", tile, reg, fuse, dtype.__name__)
    info = np.iinfo(dtype)
    x = r.randint(-50, 50, n).astype(dtype)
    x[r.choice(n, 6, replace=False)] = [info.max, info.min] * 3
    xp = padded(x, info.max)
    got, _ = apply_plan(xp, torch.zeros_like(xp, dtype=torch.int32),
                        launch_plan(xp.shape[0], tile, reg, fuse,
                                    cross_levels=cross))
    assert torch.equal(got[:n], bitonic_sort_plain(torch.from_numpy(x)))


@pytest.mark.parametrize("n", [1, 5, 8, 9])
def test_pad_fills_only_the_tail(n):
    x = torch.arange(n, dtype=torch.int64) * 3 - 7
    before = x.clone()
    out = _pad_pow2(x, 99)
    n_pad = 1 << max(n - 1, 0).bit_length()
    assert out.shape == (n_pad,) and out.data_ptr() != x.data_ptr()
    assert torch.equal(out[:n], x) and bool((out[n:] == 99).all())
    assert torch.equal(x, before)


def test_sort_sizes_count_by_log2():
    kernels.reset_counts()
    kernels.count_sort_size("bitonic_sort", 1 << 21)
    kernels.count_sort_size("bitonic_sort", 1 << 21)
    kernels.count_sort_size("bitonic_sort_kv", 1024)
    assert kernels.counts()["sort_sizes"] == {
        "bitonic_sort": {21: 2}, "bitonic_sort_kv": {10: 1}}
    kernels.reset_counts()
    assert kernels.counts()["sort_sizes"] == {"bitonic_sort": {},
                                             "bitonic_sort_kv": {}}
