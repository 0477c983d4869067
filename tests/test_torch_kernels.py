"""Port kernels vs the reference Pallas kernels (CPU, interpret mode).

Each plain PyTorch version in ``repro_torch.kernels`` runs the same
network or search as its Pallas kernel, so the outputs must be *equal*,
the key-value payload and the order of tied keys included.  Inputs are
made with numpy from a seed and handed to both packages.  The composites
(tagged stable sort, chained-sort dedup, the fused join in MJ and HJ,
the two-run merge, the index-mirror merge and the unique filter) are held
against the reference composites run with ``force_pallas=True,
interpret=True``; join outputs are compared as row multisets because
pair order is unspecified.  The CUDA kernels themselves are held
against these plain versions on a card (``test_torch_cuda.py``).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend.base import splitmix64
from repro.kernels.mergejoin.mergejoin import probe_sorted as pallas_probe
from repro.kernels.mergejoin.ops import (
    merge_join_gather_bounded as ref_join_gather)
from repro.kernels.sortmerge.ops import device_dedup_rows as ref_dedup
from repro.kernels.sortmerge.ops import device_merge_runs as ref_merge_runs
from repro.kernels.sortmerge.ops import (
    device_stable_sort_perm as ref_stable_perm)
from repro.kernels.sortmerge.ops import (
    merge_sorted_mirror_impl as ref_merge_mirror)
from repro.kernels.sortmerge.ops import (
    tagged_from_sorted as ref_tagged_from_sorted)
from repro.kernels.sortmerge.sortmerge import bitonic_sort as pallas_sort
from repro.kernels.sortmerge.sortmerge import (
    bitonic_sort_kv as pallas_sort_kv)
from repro.kernels.sortmerge.sortmerge import merge_ranks as pallas_ranks
from repro.kernels.uniquefilter.ops import (
    unique_sorted_bounded as ref_unique_sorted)
from repro.kernels.uniquefilter.ref import unique_mask_ref as jnp_unique_ref
from repro.kernels.uniquefilter.uniquefilter import (
    unique_mask_sorted as pallas_unique_mask)
from repro_torch import kernels
from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                     probe_sorted_plain)
from repro_torch.kernels.mergejoin.ref import join_pairs_ref, probe_ref
from repro_torch.kernels.mergejoin.ops import (merge_join_bounded,
                                               merge_join_gather_bounded,
                                               splitmix64_dev)
from repro_torch.kernels.sortmerge.ops import (device_dedup_rows,
                                               device_merge_runs,
                                               device_stable_sort_perm,
                                               fits_tagged_width,
                                               merge_sorted_mirror_impl,
                                               tag_bits_for,
                                               tagged_from_sorted)
from repro_torch.kernels.sortmerge.ref import (merge_ranks_ref, sort_kv_ref,
                                               sort_ref)
from repro_torch.kernels.sortmerge.sortmerge import (bitonic_sort,
                                                     bitonic_sort_kv,
                                                     bitonic_sort_kv_plain,
                                                     bitonic_sort_plain,
                                                     merge_ranks)
from repro_torch.kernels.uniquefilter.ops import unique_sorted_bounded
from repro_torch.kernels.uniquefilter.ref import unique_mask_ref
from repro_torch.kernels.uniquefilter.uniquefilter import (
    unique_mask_sorted, unique_mask_sorted_plain)

BLOCK = 256
SIZES = [0, 1, 7, 64, 100, 1000, 2048]
DTYPES = [np.int32, np.int64]


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def keys_with_extremes(r, n, dtype):
    """Random keys with ties, and the dtype's extremes (the pad value
    among them) mixed in."""
    info = np.iinfo(dtype)
    x = r.randint(-1000, 1000, n).astype(dtype)
    if n >= 4:
        x[r.choice(n, 3, replace=False)] = [info.max, info.min, info.max]
    return x


# -- bitonic sort --------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bitonic_sort_plain_equals_pallas(n, dtype):
    x = keys_with_extremes(rng("sort", n, dtype.__name__), n, dtype)
    got = bitonic_sort(T(x)).numpy()  # CPU tensor: the plain version
    assert got.dtype == dtype and got.shape == (n,)
    if n == 0:
        return
    want = np.asarray(pallas_sort(jnp.asarray(x), block=BLOCK,
                                  interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sort_ref(T(x)).numpy())


@pytest.mark.parametrize("n", SIZES)
def test_bitonic_sort_kv_plain_equals_pallas(n):
    r = rng("kv", n)
    k = r.randint(0, 50, n).astype(np.int64)  # many ties: order is visible
    v = r.permutation(n).astype(np.int32)
    gk, gv = bitonic_sort_kv(T(k), T(v))
    if n == 0:
        assert gk.numel() == 0 and gv.numel() == 0
        return
    wk, wv = pallas_sort_kv(jnp.asarray(k), jnp.asarray(v), block=BLOCK,
                            interpret=True)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # unstable network, same multiset of pairs as the stable oracle
    rk, rv = sort_kv_ref(T(k), T(v))
    np.testing.assert_array_equal(gk.numpy(), rk.numpy())
    assert sorted(zip(gk.tolist(), gv.tolist())) == sorted(
        zip(rk.tolist(), rv.tolist()))


def test_bitonic_sort_kv_pad_value_ties():
    """Real keys equal to the int64-max pad keep their payloads: the
    network moves a pair only on a strict violation, in both packages."""
    mx = np.iinfo(np.int64).max
    k = np.array([mx, 3, mx, 1, 3, mx, 0], np.int64)
    v = np.arange(7, dtype=np.int32)
    gk, gv = bitonic_sort_kv(T(k), T(v))
    wk, wv = pallas_sort_kv(jnp.asarray(k), jnp.asarray(v), block=BLOCK,
                            interpret=True)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert sorted(gv.tolist()) == list(range(7))


# -- sorted probe ------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(10, 10), (64, 128), (200, 37), (1, 1),
                                 (1000, 2048), (7, 1)])
def test_probe_plain_equals_pallas(n, m):
    r = rng("probe", n, m)
    lk = r.randint(-5, 35, n).astype(np.int64)
    rs = np.sort(r.randint(0, 30, m)).astype(np.int64)
    lo, hi = probe_sorted(T(lk), T(rs))
    wlo, whi = pallas_probe(jnp.asarray(lk), jnp.asarray(rs), block=BLOCK,
                            interpret=True)
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
    rlo, rhi = probe_ref(T(lk), T(rs))
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


@pytest.mark.parametrize("side_right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("n,m", [(10, 10), (64, 128), (200, 37), (1, 1),
                                 (1000, 2048), (7, 1), (0, 5)])
def test_merge_ranks_plain_equals_pallas(n, m, side_right):
    r = rng("ranks", n, m, side_right)
    x = r.randint(-5, 35, n).astype(np.int64)
    other = np.sort(r.randint(0, 30, m)).astype(np.int64)
    if m > 2:
        other[-2:] = np.iinfo(np.int64).max  # pad tail above every key
    got = merge_ranks(T(x), T(other), side_right=side_right)
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = pallas_ranks(jnp.asarray(x), jnp.asarray(other),
                        side_right=side_right, block=BLOCK, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, merge_ranks_ref(T(x), T(other), side_right))


def test_probe_empty_right_side():
    lo, hi = probe_sorted(T(np.arange(5, dtype=np.int64)),
                          T(np.empty(0, np.int64)))
    assert lo.tolist() == [0] * 5 and hi.tolist() == [0] * 5


# -- unique mask -----------------------------------------------------------------


def _sorted_with_ties(case: str, n: int) -> np.ndarray:
    """Sorted int64 keys for the unique-mask cases: runs that straddle
    every 256-lane block edge, and the int64 extremes."""
    r = rng("uniq", case, n)
    if case == "edges":  # runs of 3 centred on each block boundary
        x = np.arange(n, dtype=np.int64) // 3 * 7
        for e in range(256, n, 256):
            x[e - 1:e + 2] = x[e - 1]
        return np.sort(x)
    if case == "extremes":
        x = np.sort(r.randint(-5, 5, n)).astype(np.int64)
        if n >= 6:
            x[:2] = np.iinfo(np.int64).min
            x[-3:] = np.iinfo(np.int64).max
        return x
    return np.sort(r.randint(0, max(n // 4, 1), n)).astype(np.int64)


@pytest.mark.parametrize("case", ["ties", "edges", "extremes"])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 700, 1024])
def test_unique_mask_plain_equals_pallas(case, n):
    """The plain version equals the Pallas kernel (interpret mode, 256-lane
    blocks: ties across block edges, ``n`` not a multiple of the block,
    ``n = 1``, the extremes — which are also the Pallas pad value) and the
    independent stock-torch oracle."""
    x = _sorted_with_ties(case, n)
    got = unique_mask_sorted(T(x))  # CPU tensor: the plain version
    assert got.dtype == torch.bool and got.shape == (n,)
    want = np.asarray(pallas_unique_mask(jnp.asarray(x), block=BLOCK,
                                         interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp_unique_ref(jnp.asarray(x))))
    assert torch.equal(got, unique_mask_ref(T(x)))
    assert torch.equal(got, unique_mask_sorted_plain(T(x)))


def test_unique_mask_empty():
    assert unique_mask_sorted(T(np.empty(0, np.int64))).shape == (0,)
    assert unique_mask_ref(T(np.empty(0, np.int64))).shape == (0,)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_unique_sorted_bounded_equals_reference(dtype):
    """Sort + mask + compaction, narrow code buffers widened on entry."""
    r = rng("usb", dtype.__name__)
    x = r.randint(-100, 100, 300).astype(dtype)
    vals, cnt = unique_sorted_bounded(T(x))
    wvals, wcnt = ref_unique_sorted(jnp.asarray(x), force_pallas=True,
                                    interpret=True)
    assert int(cnt) == int(wcnt) == len(np.unique(x))
    assert vals.dtype == torch.int64
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wvals))
    np.testing.assert_array_equal(vals.numpy()[:int(cnt)], np.unique(x))


# -- composites vs the reference composites ------------------------------------


@pytest.mark.parametrize("n,cap", [(1, 256), (100, 256), (300, 512),
                                   (1000, 1024)])
def test_stable_sort_perm_equals_reference(n, cap):
    r = rng("perm", n, cap)
    keys = np.full(cap, 12345, np.int64)  # pad content is arbitrary
    keys[:n] = r.randint(-20, 20, n) * (1 << 20)
    kmin, kmax = int(keys[:n].min()), int(keys[:n].max())
    assert fits_tagged_width(kmin, kmax, cap)
    tb = tag_bits_for(cap)
    sk, perm = device_stable_sort_perm(T(keys), n, kmin, tag_bits=tb)
    wsk, wperm = ref_stable_perm(jnp.asarray(keys), n, kmin, tag_bits=tb,
                                 block=BLOCK, force_pallas=True,
                                 interpret=True)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(wsk))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    # stable: equal keys keep input order
    np.testing.assert_array_equal(perm.numpy()[:n],
                                  np.argsort(keys[:n], kind="stable"))


@pytest.mark.parametrize("n,cap", [(5, 256), (200, 256), (700, 1024)])
def test_dedup_rows_equals_reference(n, cap):
    r = rng("dedup", n, cap)
    cols = [np.zeros(cap, np.int64) for _ in range(3)]
    for c, hi in zip(cols, (6, 3, 4)):
        c[:n] = r.randint(0, hi, n)
    kmins = [int(c[:n].min()) for c in cols]
    tb = tag_bits_for(cap)
    rows, cnt = device_dedup_rows(tuple(T(c) for c in cols), n, kmins,
                                  tag_bits=tb)
    wrows, wcnt = ref_dedup(tuple(jnp.asarray(c) for c in cols), n,
                            jnp.asarray(kmins, jnp.int64), tag_bits=tb,
                            block=BLOCK, force_pallas=True, interpret=True)
    assert int(cnt) == int(wcnt)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(wrows))
    # first occurrence of every distinct row, ascending
    _, first = np.unique(np.stack([c[:n] for c in cols], 1), axis=0,
                         return_index=True)
    np.testing.assert_array_equal(rows.numpy()[:int(cnt)], np.sort(first))


@pytest.mark.parametrize("n_a,n_b,cap_b", [(1, 1, 32), (100, 20, 32),
                                           (300, 200, 256), (5, 400, 512)])
def test_merge_runs_equals_reference(n_a, n_b, cap_b):
    r = rng("mruns", n_a, n_b)
    cap = 1 << (n_a + n_b - 1).bit_length()
    a = np.full(cap, np.iinfo(np.int64).max, np.int64)
    b = np.full(cap_b, np.iinfo(np.int64).max, np.int64)
    a[:n_a] = np.sort(r.randint(-30, 30, n_a))
    b[:n_b] = np.sort(r.randint(-30, 30, n_b))
    got = device_merge_runs(T(a), T(b), n_a, n_b)
    want = ref_merge_runs(jnp.asarray(a), jnp.asarray(b), n_a, n_b,
                          block=BLOCK, force_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:n_a + n_b],
                                  np.sort(np.concatenate([a[:n_a],
                                                          b[:n_b]])))


@pytest.mark.parametrize("n_run,delta_start,n_total,dcap", [
    (300, 300, 340, 64),    # full mirror, window past the run
    (500, 500, 512, 32),    # window slides back at the top of the buffer
    (250, 300, 330, 32),    # compacted run: fewer lanes than source rows
    (0, 0, 100, 128)])      # empty run
def test_merge_sorted_mirror_equals_reference(n_run, delta_start, n_total,
                                              dcap):
    r = rng("mirror", n_run, delta_start, n_total)
    cap, tb = 512, tag_bits_for(512)
    buf = np.full(cap, np.iinfo(np.int64).max, np.int64)
    buf[:n_total] = r.randint(-40, 40, n_total)
    kmin_old = int(buf[:delta_start].min()) if delta_start else 0
    kmin = min(kmin_old, int(buf[:n_total].min()) - 3)  # the minimum moves
    # the resident run: a stable sort of n_run of the first delta_start rows
    rows = np.sort(r.choice(delta_start, n_run, replace=False))
    order = rows[np.argsort(buf[rows], kind="stable")]
    sk = np.full(cap, np.iinfo(np.int64).max, np.int64)
    perm = np.arange(cap, dtype=np.int64)
    sk[:n_run], perm[:n_run] = buf[order], order
    base = tagged_from_sorted(T(sk), T(perm), n_run, kmin_old, tag_bits=tb)
    wbase = ref_tagged_from_sorted(jnp.asarray(sk), jnp.asarray(perm), n_run,
                                   kmin_old, tag_bits=tb)
    np.testing.assert_array_equal(base.numpy(), np.asarray(wbase))
    got = merge_sorted_mirror_impl(T(buf), base, n_run, delta_start, n_total,
                                   kmin, kmin_old, dcap=dcap, tag_bits=tb)
    want = ref_merge_mirror(jnp.asarray(buf), wbase, n_run, delta_start,
                            n_total, kmin, kmin_old, dcap=dcap, tag_bits=tb,
                            block=BLOCK, force_pallas=True, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the merged mirror is the stable sort of the run's rows plus the tail
    src = np.concatenate([order, np.arange(delta_start, n_total)])
    n_real = len(src)
    src = np.sort(src)
    want_perm = src[np.argsort(buf[src], kind="stable")]
    np.testing.assert_array_equal(got[1].numpy()[:n_real], want_perm)
    np.testing.assert_array_equal(got[0].numpy()[:n_real], buf[want_perm])


def _join_rows(louts, routs, total):
    cols = [np.asarray(c)[:total] for c in list(louts) + list(routs)]
    return sorted(zip(*(c.tolist() for c in cols)))


@pytest.mark.parametrize("hash_keys", [False, True], ids=["MJ", "HJ"])
@pytest.mark.parametrize("n_l,n_r,out_cap", [(40, 30, 256), (200, 100, 512),
                                             (64, 64, 16)])
def test_join_gather_equals_reference(hash_keys, n_l, n_r, out_cap):
    r = rng("join", hash_keys, n_l, n_r)
    cap_l = 1 << max(n_l - 1, 1).bit_length()
    cap_r = 1 << max(n_r - 1, 1).bit_length()
    lk = r.randint(0, 12, cap_l).astype(np.int64) * (1 << 33)
    rk = r.randint(0, 12, cap_r).astype(np.int64) * (1 << 33)
    lv = r.randint(0, 3, cap_l).astype(np.int64)
    rv = r.randint(0, 3, cap_r).astype(np.int64)
    lp = np.arange(cap_l, dtype=np.int64)
    rp = np.arange(cap_r, dtype=np.int64) + 1000
    louts, routs, st = merge_join_gather_bounded(
        T(lk), T(rk), n_l, n_r, (T(lp), T(lv)), (T(rp),), (T(lv),),
        (T(rv),), out_cap=out_cap, hash_keys=hash_keys)
    wl, wr, wst = ref_join_gather(
        jnp.asarray(lk), jnp.asarray(rk), n_l, n_r,
        (jnp.asarray(lp), jnp.asarray(lv)), (jnp.asarray(rp),),
        (jnp.asarray(lv),), (jnp.asarray(rv),), out_cap=out_cap,
        block=BLOCK, force_pallas=True, interpret=True, hash_keys=hash_keys)
    st, wst = st.tolist(), np.asarray(wst).tolist()
    assert st == wst
    total, total0 = st[0], st[1]
    if total0 <= out_cap:  # complete result: compare the row multisets
        assert (_join_rows([c.numpy() for c in louts],
                           [c.numpy() for c in routs], total)
                == _join_rows(wl, wr, total))
        # and against a nested-loop oracle
        ok = [(int(a), int(lv[a]), int(rp[b])) for a in range(n_l)
              for b in range(n_r) if lk[a] == rk[b] and lv[a] == rv[b]]
        assert sorted(ok) == _join_rows([c.numpy() for c in louts],
                                        [c.numpy() for c in routs], total)


def test_merge_join_bounded_pairs():
    r = rng("mjb")
    lk = np.full(128, np.iinfo(np.int64).max, np.int64)
    rk = np.full(64, np.iinfo(np.int64).min, np.int64)
    lk[:100] = r.randint(0, 15, 100)
    rk[:50] = r.randint(0, 15, 50)
    li, ri, valid, total = merge_join_bounded(T(lk), T(rk), out_cap=4096)
    got = sorted((int(a), int(b)) for a, b, v in
                 zip(li.tolist(), ri.tolist(), valid.tolist()) if v)
    want = join_pairs_ref(lk[:100], rk[:50])
    assert got == want and int(total) == len(want)


def test_splitmix64_bit_exact():
    r = rng("mix")
    x = r.randint(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096,
                  dtype=np.int64)
    x[:6] = [0, 1, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min, 42]
    got = splitmix64_dev(T(x)).numpy()
    want = splitmix64(x.view(np.uint64)).view(np.int64)
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_launch_nothing():
    kernels.reset_counts()
    bitonic_sort(T(np.arange(9, dtype=np.int64)))
    probe_sorted(T(np.arange(3, dtype=np.int64)),
                 T(np.arange(4, dtype=np.int64)))
    merge_ranks(T(np.arange(3, dtype=np.int64)),
                T(np.arange(4, dtype=np.int64)))
    unique_mask_sorted(T(np.arange(5, dtype=np.int64)))
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.rglru_scan.scan import linear_scan
    from repro_torch.kernels.ssd.ssd import ssd_intra
    q = torch.zeros(1, 5, 2, 8)
    flash_attention(q, q, q)
    ssd_intra(torch.zeros(1, 1, 4, 2), torch.zeros(1, 1, 4, 2, 3),
              torch.zeros(1, 1, 4, 5), torch.zeros(1, 1, 4, 5))
    linear_scan(torch.rand(1, 5, 3), torch.rand(1, 5, 3), torch.rand(1, 3))
    assert kernels.counts()["launches"] == {
        "bitonic_sort": 0, "bitonic_sort_kv": 0, "probe_sorted": 0,
        "merge_ranks": 0, "unique_mask_sorted": 0, "flash_attention": 0,
        "flash_attention_wgmma": 0, "ssd_intra": 0, "linear_scan": 0}
