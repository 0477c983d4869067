"""The compressed resident-column tier of the port vs the reference.

Mirrors ``tests/test_compression.py`` on the ``torch-cpu`` backend with
``compress=True``.  Three layers:

* ``repro_torch.backend.codecs`` (the port's copy) against the
  reference's ``repro.backend.codecs`` on the same columns — every codec
  field equal except the ``cid`` sequence number and the ``did`` token
  (both per-package counters) — and ``repro_torch.core.compress`` against
  ``repro.core.compress``;
* ``TorchOps(compress=True)`` — coded resident columns feeding sorts,
  merges, joins, probes, the write-side dedup, ``unique_mask`` and the
  device sketch — against the reference's ``NumpyOps``;
* the engine grid (MJ/HJ × SU/HU × sortkeys/sketch) with compression on,
  against the reference engine on ``backend="numpy"``: equal
  ``decoded_fact_checksum``.
"""

import dataclasses
import zlib
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.backend import codecs as ref_codecs
from repro.backend.numpy_ops import NumpyOps as RefNumpyOps
from repro.core import compress as ref_compress
from repro.core.rulesets import rdfs_plus_rules as ref_rules
from repro.core.sharded import decoded_fact_checksum as ref_checksum
from repro_torch.backend import codecs
from repro_torch.backend.torch_ops import (TorchOps, decode_dict,
                                           decode_for_n, decode_rle,
                                           decode_sorted_dict,
                                           decode_sorted_for, dict_crossmap,
                                           map_codes, narrow_sorted)
from repro_torch.core import EngineConfig, Fact, HiperfactEngine, Rule
from repro_torch.core import compress
from repro_torch.core.conditions import AddAction, cond, term
from repro_torch.core.rulesets import rdfs_plus_rules
from repro_torch.core.sharded import decoded_fact_checksum

HOST = RefNumpyOps()
I64 = np.iinfo(np.int64)


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def fresh_ops(compress=True):
    return TorchOps(device="cpu", block=256, compress=compress)


# -- columns that force each codec kind ---------------------------------------

def dict_col(n=600, salt=0):
    """Low cardinality, wide span -> dict codec."""
    vals = np.array([7, 10**12, 3 * 10**12, 9 * 10**14], np.int64)
    return vals[rng("dict", n, salt).randint(0, len(vals), n)]


def for_col(n=600, salt=0):
    """Dense range far from zero -> frame-of-reference codec."""
    return (10**10 + rng("for", n, salt).randint(0, 200, n)).astype(np.int64)


def rle_col(n=600, salt=0):
    """Run-heavy (grouped join output shape) -> RLE codec."""
    return np.repeat(np.arange(n // 50, dtype=np.int64) * 10**9, 50)[:n]


COLS = [dict_col, for_col, rle_col]
KINDS = {dict_col: "dict", for_col: "for", rle_col: "rle"}


def same_codec(a, b) -> bool:
    """Port and reference codecs agree on every field but ``cid`` and
    ``did`` (per-package counters)."""
    if a is None or b is None:
        return a is None and b is None
    for f in dataclasses.fields(a):
        if f.name in ("cid", "did"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def same_payload(a, b) -> bool:
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    return a is None and b is None or (np.array_equal(a, b)
                                       and a.dtype == b.dtype)


# -- codec unit layer, held against the reference's codecs ---------------------

def test_choose_codec_kinds():
    assert codecs.choose_codec(dict_col())[0].kind == "dict"
    assert codecs.choose_codec(for_col())[0].kind == "for"
    assert codecs.choose_codec(rle_col(), allow_rle=True)[0].kind == "rle"
    wide = rng("wide").randint(-2**60, 2**60, 600).astype(np.int64)
    assert codecs.choose_codec(wide) == (None, None)  # raw wins


@pytest.mark.parametrize("hint", [None, "for", "dict"])
@pytest.mark.parametrize("col_fn", COLS + [
    lambda: rng("wide").randint(-2**60, 2**60, 600).astype(np.int64),
    lambda: np.array([5, I64.max, 9, I64.min, 5] * 20, np.int64)],
    ids=["dict", "for", "rle", "wide", "extremes"])
def test_choose_codec_equals_reference(col_fn, hint):
    col = col_fn()
    for kw in ({"hint": hint}, {"hint": hint, "allow_rle": True,
                                "min_n": 16}):
        c, p = codecs.choose_codec(col, **kw)
        rc, rp = ref_codecs.choose_codec(col, **kw)
        assert same_codec(c, rc) and same_payload(p, rp)


@pytest.mark.parametrize("col_fn", COLS)
def test_codec_roundtrip(col_fn):
    col = col_fn()
    c, payload = codecs.choose_codec(col, allow_rle=True)
    np.testing.assert_array_equal(codecs.decode(c, payload), col)
    np.testing.assert_array_equal(ref_codecs.decode(c, payload), col)
    # rle capacity is counted in runs, flat codecs in rows
    cap = c.nruns if c.kind == "rle" else len(col)
    assert c.coded_nbytes(cap) < col.nbytes


@pytest.mark.parametrize("col_fn", [dict_col, for_col])
def test_encode_probes_out_of_domain(col_fn):
    col = col_fn()
    c, _ = codecs.choose_codec(col)
    rc, _ = ref_codecs.choose_codec(col)
    probes = np.concatenate([col[:5], [55, -3, I64.max, I64.min]])
    enc = codecs.encode_probes(c, probes)
    np.testing.assert_array_equal(enc, ref_codecs.encode_probes(rc, probes))
    assert (enc[5:] == c.no_match_code).all()
    assert (enc[:5] != c.no_match_code).all()
    # the never-matching code sits inside both pad sentinels
    info = np.iinfo(c.dtype)
    assert info.min < c.no_match_code < c.pad_code(I64.max) == info.max
    assert c.pad_code(I64.min) == info.min and c.pad_code(0) == 0


@pytest.mark.parametrize("col_fn", COLS)
@pytest.mark.parametrize("tail", ["inside", "above", "below"])
def test_try_encode_delta_equals_reference(col_fn, tail):
    col = col_fn()
    c, _ = codecs.choose_codec(col, allow_rle=True)
    rc, _ = ref_codecs.choose_codec(col, allow_rle=True)
    lo, hi = int(col.min()), int(col.max())
    delta = {"inside": col[:30],
             "above": np.full(20, hi + 50, np.int64),
             "below": np.full(20, lo - 10**6, np.int64)}[tail]
    got = codecs.try_encode_delta(c, delta)
    want = ref_codecs.try_encode_delta(rc, delta)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert same_codec(got[0], want[0]) and same_payload(got[1], want[1])
    assert got[0].cid == c.cid  # an append-extend keeps the code domain
    np.testing.assert_array_equal(
        codecs.encode_with(got[0], delta) if c.kind != "rle" else delta,
        ref_codecs.encode_with(want[0], delta) if c.kind != "rle" else delta)


def test_codec_identity_tokens():
    a, _ = codecs.choose_codec(dict_col(salt=1))
    b, _ = codecs.choose_codec(dict_col(salt=2))  # same dictionary content
    f1, _ = codecs.choose_codec(for_col(salt=1))
    f2, _ = codecs.choose_codec(for_col(salt=1))
    assert a.did == b.did and a.cid != b.cid
    assert codecs.same_code_domain(a, b) and codecs.same_code_domain(f1, f2)
    assert codecs.join_token(a) == codecs.join_token(b)
    assert codecs.join_token(f1) == codecs.join_token(f2)
    assert not codecs.same_code_domain(a, f1)
    r, _ = codecs.choose_codec(rle_col(), allow_rle=True)
    assert codecs.join_token(r) is None and codecs.join_token(None) is None
    for span in (-1, 0, 123, 124, 32763, 32764, 2**31 - 5, 2**31 - 4):
        assert codecs.smallest_dtype(span) == ref_codecs.smallest_dtype(span)


@pytest.mark.parametrize("col_fn", [
    lambda: np.repeat(np.asarray([5, 9, 5], np.int64), 500),
    lambda: np.arange(0, 10_000, 1, np.int64) + 2**40,
    lambda: rng("raw").randint(-2**60, 2**60, 100),
    lambda: np.repeat(np.asarray([3, 7, 3, 9], np.int64), [4, 2, 3, 1]),
    lambda: np.asarray([10**12, 3 * 10**12, 7] * 40, np.int64)],
    ids=["rle", "delta", "raw", "short-runs", "dict"])
def test_host_compressed_column_equals_reference(col_fn):
    """The host ``CompressedColumn`` extension (RLE, DELTA, DICT and the
    direct RLE operations) equals the reference's module."""
    a = np.asarray(col_fn(), np.int64)
    c, rc = compress.encode_column(a), ref_compress.encode_column(a)
    assert (c.codec, c.n, c.nbytes()) == (rc.codec, rc.n, rc.nbytes())
    np.testing.assert_array_equal(compress.decode_column(c), a)
    if c.codec == "rle":
        v = int(a[0])
        np.testing.assert_array_equal(compress.rle_equals(c, v), a == v)
        assert compress.rle_count(c, v) == int((a == v).sum())
    cb = compress.CompressedBindings({"k": a, "r": a[::-1].copy()})
    rcb = ref_compress.CompressedBindings({"k": a, "r": a[::-1].copy()})
    assert cb.codecs() == rcb.codecs() and cb.nbytes() == rcb.nbytes()
    np.testing.assert_array_equal(cb.col("r"), a[::-1])


# -- device decode and recode composites ---------------------------------------

def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_decode_composites():
    col = dict_col(300)
    c, codes = codecs.choose_codec(col)
    dvals = T(c.values)
    np.testing.assert_array_equal(decode_dict(T(codes), dvals).numpy(), col)
    fc = for_col(300)
    f, fcodes = codecs.choose_codec(fc)
    got = decode_for_n(T(np.r_[fcodes, [127, 127]].astype(fcodes.dtype)),
                       f.ref, 300, I64.max).numpy()
    np.testing.assert_array_equal(got[:300], fc)
    assert (got[300:] == I64.max).all()
    rc = rle_col(600)
    r, (vals, lens) = codecs.choose_codec(rc, allow_rle=True)
    v = np.r_[vals, np.zeros(3, np.int64)]  # run pads: length 0
    ln = np.r_[lens, np.zeros(3, np.int32)]
    np.testing.assert_array_equal(
        decode_rle(T(v), T(ln), 1024).numpy()[:600], rc)
    # sorted mirrors: narrow re-pad keeps them sorted; decode re-pads max
    sk = np.sort(codes.astype(np.int64))
    sk = np.r_[sk, np.full(212, I64.max)]
    nar = narrow_sorted(T(sk), 300, c.dtype)
    assert nar.dtype == torch.int8 and (nar.numpy()[300:] == 127).all()
    assert (np.diff(nar.numpy().astype(np.int64)) >= 0).all()
    dec = decode_sorted_dict(T(sk), 300, dvals).numpy()
    np.testing.assert_array_equal(dec[:300], np.sort(col))
    assert (dec[300:] == I64.max).all()
    dec = decode_sorted_for(T(np.r_[np.sort(fcodes).astype(np.int64), 0]),
                            300, f.ref).numpy()
    np.testing.assert_array_equal(dec[:300], np.sort(fc))
    assert dec[300] == I64.max


def test_dict_crossmap_recodes_shared_values():
    lv = np.array([7, 10**12, 3 * 10**12], np.int64)
    rv = np.array([10**12, 9 * 10**14], np.int64)
    cmap = dict_crossmap(T(lv), T(rv), 126).numpy()
    np.testing.assert_array_equal(cmap, [126, 0, 126])
    codes = np.array([0, 1, 2, 1, 127], np.int8)  # a garbage pad code last
    np.testing.assert_array_equal(map_codes(T(cmap), T(codes)).numpy(),
                                  [126, 0, 126, 0, 126])


# -- TorchOps resident layer ---------------------------------------------------

@pytest.mark.parametrize("col_fn", COLS)
def test_upload_resident_coded_roundtrip(col_fn):
    ops = fresh_ops()
    col = col_fn()
    h = ops.upload_resident(("rt", col_fn.__name__), 1, col)
    assert h.codec is not None and h.codec.kind == KINDS[col_fn]
    np.testing.assert_array_equal(h.data.numpy()[:h.n], col)
    st = ops.residency_stats()
    assert st["compress"] and st["resident_bytes_coded"] > 0
    assert st["resident_bytes_coded"] < st["resident_bytes_raw"]
    assert st["codecs"]["decode_calls"] == 1  # the .data access above


@pytest.mark.parametrize("col_fn", COLS)
def test_upload_resident_coded_tail_extension(col_fn):
    """An append ships only the encoded tail; the old handle stays valid
    and the new one decodes to the whole column."""
    ops = fresh_ops()
    col = col_fn(600)
    tail = col_fn(640)[600:] if col_fn is not rle_col else np.full(
        30, 11 * 10**9, np.int64)
    h1 = ops.upload_resident(("ext", col_fn.__name__), 1, col)
    col2 = np.concatenate([col, tail])
    snap = ops.transfers.snapshot()
    h2 = ops.upload_resident(("ext", col_fn.__name__), 2, col2)
    d = ops.transfers.delta(snap)
    assert h2.codec.cid == h1.codec.cid
    assert ops.residency_stats()["codecs"]["recode_rebuilds"] == 0
    assert 0 < d.h2d_bytes < len(tail) * 8
    np.testing.assert_array_equal(h1.data.numpy()[:h1.n], col)
    np.testing.assert_array_equal(h2.data.numpy()[:h2.n], col2)


@pytest.mark.parametrize("col_fn", COLS)
def test_sort_perm_coded_parity(col_fn):
    ops = fresh_ops()
    col = col_fn()
    sk, perm = ops.sort_perm(col, cache_key=("sp", col_fn.__name__),
                             version=1)
    wsk, wperm = HOST.sort_perm(col)
    np.testing.assert_array_equal(perm, wperm)
    np.testing.assert_array_equal(sk, wsk)
    kinds = ops.residency_stats()["codecs"]
    assert kinds["dict"] + kinds["for"] == 1  # the column was coded


@pytest.mark.parametrize("hint", ["for", "dict"])
def test_sort_perm_codec_hint(hint):
    """The index build's hint picks the codec without a scan of the
    other kind, as the reference's does."""
    ops = fresh_ops()
    col = for_col(400)
    ops.sort_perm(col, cache_key=("h", hint), version=1, hint=hint)
    assert ops.residency_stats()["codecs"][hint] == 1
    np.testing.assert_array_equal(
        ops.sort_perm(col, cache_key=("h", hint), version=1)[1],
        HOST.sort_perm(col)[1])


def test_zero_transfer_repeat_with_compression():
    """Fixed-version sweep: cached coded state costs zero transfers."""
    ops = fresh_ops()
    col = dict_col(2000)
    s1, p1 = ops.sort_perm(col, cache_key=("zt", 1), version=1)
    snap = ops.transfers.snapshot()
    s2, p2 = ops.sort_perm(col, cache_key=("zt", 1), version=1)
    d = ops.transfers.delta(snap)
    assert d.h2d_calls == 0 and d.d2h_calls == 0
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(p1, p2)
    assert ops.residency_stats()["codecs"]["dict"] >= 1


def test_dict_append_extension_keeps_cid():
    """In-order fresh values extend the dictionary without a rebuild, and
    the coded mirror absorbs the tail by merge (same ``cid``)."""
    ops = fresh_ops()
    vals = np.array([10**12, 3 * 10**12], np.int64)
    col = vals[rng("dx").randint(0, 2, 400)]
    ops.sort_perm(col, cache_key=("dx", 1), version=1)
    cid = ops.cache.get_any(("colbuf", ("dx", 1), I64.max)).value["codec"].cid
    col2 = np.concatenate([col, np.full(40, 9 * 10**14, np.int64)])
    work = ops.sort_work.snapshot()
    sk, perm = ops.sort_perm(col2, cache_key=("dx", 1), version=2)
    np.testing.assert_array_equal(perm, HOST.sort_perm(col2)[1])
    np.testing.assert_array_equal(sk, HOST.sort_perm(col2)[0])
    st = ops.residency_stats()["codecs"]
    assert st["dict_extends"] >= 1 and st["recode_rebuilds"] == 0
    cv = ops.cache.get_any(("colbuf", ("dx", 1), I64.max)).value
    assert cv["codec"].cid == cid and len(cv["codec"].values) == 3
    assert ops.sort_work.delta(work).delta_merges == 1


def test_dict_overflow_recode_rebuild():
    """Fresh values below the dictionary max break append-only order: the
    column recodes from scratch (counted, new ``cid``), the mirror run
    refuses to merge across the recode, and the result stays exact."""
    ops = fresh_ops()
    vals = np.array([10**12, 3 * 10**12], np.int64)
    col = vals[rng("ov").randint(0, 2, 400)]
    ops.sort_perm(col, cache_key=("ov", 1), version=1)
    col2 = np.concatenate([col, np.full(40, 5, np.int64)])  # < dict min
    work = ops.sort_work.snapshot()
    sk, perm = ops.sort_perm(col2, cache_key=("ov", 1), version=2)
    np.testing.assert_array_equal(perm, HOST.sort_perm(col2)[1])
    np.testing.assert_array_equal(sk, HOST.sort_perm(col2)[0])
    assert ops.residency_stats()["codecs"]["recode_rebuilds"] >= 1
    w = ops.sort_work.delta(work)
    assert (w.full_sorts, w.delta_merges) == (1, 0)


def test_coded_mirror_tombstone_compaction():
    """A full sort of a tombstoned coded column compacts in code domain
    (the alive rows re-encoded with the resident codec)."""
    ops = fresh_ops()
    r = rng("tomb")
    col = for_col(500)
    alive = r.rand(500) > 0.3
    n_dead = int((~alive).sum())
    sk, perm = ops.sort_perm(col, cache_key=("tb", 1), version=1,
                             n_dead=n_dead, alive=alive)
    wsk, wperm = HOST.sort_perm(col, n_dead=n_dead, alive=alive)
    np.testing.assert_array_equal(sk, wsk)
    np.testing.assert_array_equal(perm, wperm)
    col2 = np.concatenate([col, for_col(20, salt=3)])
    alive2 = np.concatenate([alive, np.ones(20, bool)])
    sk, perm = ops.sort_perm(col2, cache_key=("tb", 1), version=2,
                             n_dead=n_dead, alive=alive2)
    wsk, wperm = HOST.sort_perm(col2, n_dead=n_dead, alive=alive2)
    np.testing.assert_array_equal(sk, wsk)
    np.testing.assert_array_equal(perm, wperm)


def test_sentinel_keys_stay_correct():
    """Keys at the int64 extremes: low-cardinality columns still dict
    (the extremes live in the dictionary, codes stay narrow); wide
    high-cardinality columns fall back to raw.  Both sort bit-exactly."""
    ops = fresh_ops()
    col = np.array([5, I64.max, 9, I64.min, 5] * 20, np.int64)
    assert codecs.choose_codec(col)[0].kind == "dict"
    sk, perm = ops.sort_perm(col, cache_key=("sx", 1), version=1)
    np.testing.assert_array_equal(perm, np.argsort(col, kind="stable"))
    np.testing.assert_array_equal(sk, np.sort(col))
    lo, hi = ops.batch_probe(sk, np.array([I64.max, I64.min, 6], np.int64),
                             cache_key=("sx", 1), version=1)
    assert (hi - lo).tolist() == [20, 20, 0]
    wide = np.arange(300, dtype=np.int64) * (1 << 53)
    rng("sx").shuffle(wide)
    wide[0], wide[1] = I64.max, I64.min
    assert codecs.choose_codec(wide) == (None, None)
    sk2, perm2 = ops.sort_perm(wide, cache_key=("sx", 2), version=1)
    np.testing.assert_array_equal(perm2, np.argsort(wide, kind="stable"))
    np.testing.assert_array_equal(sk2, np.sort(wide))


def test_empty_and_tiny_columns_stay_raw():
    ops = fresh_ops()
    h = ops.upload_resident(("e", 1), 1, np.empty(0, np.int64))
    assert h.n == 0
    tiny = np.array([10**12, 3 * 10**12], np.int64)  # below the min_n gate
    h2 = ops.upload_resident(("e", 2), 1, tiny)
    assert h2.codec is None
    np.testing.assert_array_equal(h2.data.numpy()[:2], tiny)


def _join_rows(lout, rout, n):
    return sorted(zip(lout[0].host()[:n].tolist(), rout[0].host()[:n].tolist()))


@pytest.mark.parametrize("algo", ["MJ", "HJ"])
@pytest.mark.parametrize("kind", ["dict", "for"])
def test_code_domain_join_shared_codec(algo, kind):
    """Both sides resident with the same join token: the join runs over
    the narrow codes (counted) and matches the host oracle."""
    ops = fresh_ops()
    if kind == "dict":
        vals = np.array([7, 10**12, 3 * 10**12, 9 * 10**14], np.int64)
        l = vals[rng("cj", algo).randint(0, 4, 300)]
        r = vals[rng("cj2", algo).randint(0, 4, 200)]
    else:  # same minimum and width: one frame of reference
        l = for_col(300, salt=algo)
        r = for_col(200, salt=algo + "r")
        l[0] = r[0] = 10**10
        l[1] = r[1] = 10**10 + 199
    lk = ops.upload_resident(("cj-l", algo), 1, l)
    rk = ops.upload_resident(("cj-r", algo), 1, r)
    assert codecs.join_token(lk.codec) == codecs.join_token(rk.codec)
    lout, rout, n = ops.join_gather_h(lk, rk, [lk], [rk], [], algo)
    li, ri = HOST.join_pairs(l, r)
    assert n == len(li)
    assert _join_rows(lout, rout, n) == sorted(zip(l[li].tolist(),
                                                   r[ri].tolist()))
    assert ops.residency_stats()["codecs"]["code_joins"] == 1


@pytest.mark.parametrize("algo", ["MJ", "HJ"])
@pytest.mark.parametrize("smaller", ["left", "right"])
def test_cross_dict_recode_join(algo, smaller):
    """Different dictionaries: the smaller side recodes on the device
    (counted) and nothing decodes to the host."""
    ops = fresh_ops()
    lv = np.array([7, 10**12, 3 * 10**12], np.int64)
    rv = np.array([10**12, 9 * 10**14], np.int64)  # overlaps on 10**12
    nl, nr = (150, 300) if smaller == "left" else (300, 150)
    l = lv[rng("xd", algo).randint(0, 3, nl)]
    r = rv[rng("xd2", algo).randint(0, 2, nr)]
    lk = ops.upload_resident(("xd-l", algo), 1, l)
    rk = ops.upload_resident(("xd-r", algo), 1, r)
    lout, rout, n = ops.join_gather_h(lk, rk, [lk], [rk], [], algo)
    li, ri = HOST.join_pairs(l, r)
    assert n == len(li)
    assert _join_rows(lout, rout, n) == sorted(zip(l[li].tolist(),
                                                   r[ri].tolist()))
    assert ops.residency_stats()["codecs"]["cross_recodes"] == 1


def test_join_pairs_coded_resident_right_side():
    """``join_pairs`` against a resident dict-coded right side encodes
    the probes (absent keys never match) and gives the host's pairs."""
    ops = fresh_ops()
    r = dict_col(300)
    l = np.concatenate([dict_col(100, salt=5), [55, -3]])
    for _ in range(2):  # cold build, then a hit on the coded buffer
        li, ri = ops.join_pairs(l, r, rkeys_key=("pk", 1), rkeys_version=1)
        assert sorted(zip(li.tolist(), ri.tolist())) == sorted(
            zip(*(x.tolist() for x in HOST.join_pairs(l, r))))
    assert ops.residency_stats()["codecs"]["dict"] == 1


@pytest.mark.parametrize("col_fn", [dict_col, for_col])
def test_batch_probe_coded_matches_host(col_fn):
    """Probe counts over a narrow code-domain mirror (what
    ``lookup_batch`` consumes) equal the raw searchsorted spans, absent
    and out-of-range probes included, and ``lo`` equals the raw one
    wherever the run is non-empty (an absent probe's empty run sits at
    the end of the mirror, as in the reference)."""
    ops = fresh_ops()
    col = col_fn(2000)
    sk, _ = ops.sort_perm(col, cache_key=("bp", 1), version=1)
    probes = np.concatenate([col[rng("bp").randint(0, 2000, 50)],
                             [99, 10**10 + 10**6, 8, 2 * 10**12, I64.min,
                              I64.max, 10**10 - 1, 10**10 + 200]])
    snap = ops.transfers.snapshot()
    lo, hi = ops.batch_probe(sk, probes, cache_key=("bp", 1), version=1)
    assert ops.transfers.delta(snap).h2d_calls == 1  # the probes only
    wlo, whi = HOST.batch_probe(np.sort(col), probes)
    np.testing.assert_array_equal(hi - lo, whi - wlo)
    nz = whi > wlo
    assert nz.sum() >= 50 and not nz[-8:].any()
    np.testing.assert_array_equal(lo[nz], wlo[nz])


def test_write_side_dedup_with_coded_pk_column():
    """The reference's duplicate-row regression: ``join_pairs`` dict-codes
    the shared ``("pk", uid)`` column during insert dedup, and
    ``fresh_mask_h`` must decode that entry before its anti-join."""
    rules = [
        Rule("echo", (cond("Data", "?x", "link", "?y"),),
             (AddAction("Data", term("?x"), "link", term("?y")),)),
        Rule("rec", (cond("Data", "?x", "link", "?y"),
                     cond("Data", "?y", "link", "?z")),
             (AddAction("Data", term("?x"), "link", term("?z")),)),
    ]
    batch1 = [Fact("Data", "hub", "link", f"s{i}") for i in range(60)]
    batch2 = [Fact("Data", f"s{i}", "link", f"t{i}") for i in range(60)]
    cfg = dataclasses.replace(EngineConfig.infer1("torch-cpu"),
                              compress=True)
    e = HiperfactEngine(cfg)
    e.add_rules(rules)
    e.insert_facts(batch1)
    e.insert_facts(batch2)
    e.infer()
    r = ref.HiperfactEngine(ref.EngineConfig.infer1("numpy"))
    r.add_rules(_ref_link_rules())
    r.insert_facts([ref.Fact(f.fact_type, f.id, f.attr, f.val)
                    for f in batch1])
    r.insert_facts([ref.Fact(f.fact_type, f.id, f.attr, f.val)
                    for f in batch2])
    r.infer()
    t = e.store.tables["Data"]
    rows = Counter(zip(t.ids[:t.n].tolist(), t.attrs[:t.n].tolist(),
                       t.vals[:t.n].tolist()))
    assert all(c == 1 for c in rows.values()), "duplicate rows written"
    assert e.store.num_facts() == r.store.num_facts()
    assert decoded_fact_checksum(e) == ref_checksum(r)
    assert e.ops.residency_stats()["codecs"]["dict"] > 0


def _ref_link_rules():
    from repro.core.conditions import AddAction as RA
    from repro.core.conditions import cond as rcond
    from repro.core.conditions import term as rterm
    return [
        ref.Rule("echo", (rcond("Data", "?x", "link", "?y"),),
                 (RA("Data", rterm("?x"), "link", rterm("?y")),)),
        ref.Rule("rec", (rcond("Data", "?x", "link", "?y"),
                         rcond("Data", "?y", "link", "?z")),
                 (RA("Data", rterm("?x"), "link", rterm("?z")),)),
    ]


# -- unique_mask, semi_join and the device sketch ------------------------------

@pytest.mark.parametrize("case", ["narrow", "wide", "unsorted", "one",
                                  "extremes"])
def test_unique_mask_narrow_upload(case):
    ops = fresh_ops()
    r = rng("um", case)
    x = {"narrow": np.sort(r.randint(0, 90, 700)) + 10**12,
         "wide": np.sort(r.randint(-2**60, 2**60, 700)),
         "unsorted": r.randint(0, 9, 300),
         "one": np.array([42]),
         "extremes": np.array([I64.min, I64.min, 0, I64.max, I64.max])
         }[case].astype(np.int64)
    snap = ops.transfers.snapshot()
    np.testing.assert_array_equal(ops.unique_mask(x), HOST.unique_mask(x))
    if case == "narrow":  # one int8 upload of the bucket
        assert ops.transfers.delta(snap).h2d_bytes == 1024
    assert ops.unique_mask(np.empty(0, np.int64)).shape == (0,)


def test_semi_join_narrow_upload():
    ops = fresh_ops()
    r = rng("sj")
    keys = r.randint(0, 600, 333).astype(np.int64) + 10**9
    bound = r.randint(0, 300, 77).astype(np.int64) + 10**9
    snap = ops.transfers.snapshot()
    np.testing.assert_array_equal(ops.semi_join(keys, bound),
                                  HOST.semi_join(keys, bound))
    assert ops.transfers.delta(snap).h2d_bytes == 2 * 333 + 2 * 77
    keys[:3] = [I64.max, I64.min, 10**9]
    np.testing.assert_array_equal(ops.semi_join(keys, bound),
                                  HOST.semi_join(keys, bound))


@pytest.mark.parametrize("col_fn", COLS + [
    lambda n=600: rng("sk").randint(-2**62, 2**62, n).astype(np.int64)],
    ids=["dict", "for", "rle", "raw"])
def test_sketch_over_resident_column(col_fn):
    """The device sketch over the index build's resident (coded or raw)
    column equals the host sketch, and is cached per version."""
    ops = fresh_ops()
    col = col_fn(600)
    ops.sort_perm(col, cache_key=(9, 1, ""), version=3)
    snap = ops.transfers.snapshot()
    got = ops.sketch(col, cache_key=(9, 1), version=3)
    assert ops.transfers.delta(snap).h2d_calls == 0  # the resident column
    want = HOST.sketch(col)
    assert (got["n"], got["distinct"]) == (want["n"], want["distinct"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    np.testing.assert_array_equal(got["dhist"], want["dhist"])
    assert ops.sketch(col, cache_key=(9, 1), version=3) is got
    cold = fresh_ops().sketch(col)  # no resident column: a transient upload
    np.testing.assert_array_equal(cold["dhist"], want["dhist"])


# -- engine grid ---------------------------------------------------------------

def kg_facts(F=Fact):
    facts = [
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
    # enough rows that resident frontiers pass the codecs' size gate
    for i in range(60):
        facts.append(F("Data", f"n{i}", "type", "A"))
        facts.append(F("Data", f"n{i}", "knows", f"n{(i + 1) % 60}"))
    for i in range(20):
        facts.append(F("Data", f"q{i}", "partOf", f"q{i + 1}"))
    return facts


@pytest.mark.parametrize("sort_mode", ["sortkeys", "sketch"])
@pytest.mark.parametrize("unique", ["SU", "HU"])
@pytest.mark.parametrize("join", ["MJ", "HJ"])
def test_engine_grid_compressed_equals_reference(join, unique, sort_mode):
    cfg = EngineConfig(index_backend="AI", join=join, rnl="AR",
                       layout="CC", unique=unique, sort_mode=sort_mode,
                       backend="torch-cpu", compress=True)
    e = HiperfactEngine(cfg)
    e.add_rules(rdfs_plus_rules())
    e.insert_facts(kg_facts())
    s = e.infer()
    r = ref.HiperfactEngine(ref.EngineConfig(
        **{**dataclasses.asdict(cfg), "backend": "numpy"}))
    r.add_rules(ref_rules())
    r.insert_facts([ref.Fact(f.fact_type, f.id, f.attr, f.val)
                    for f in kg_facts()])
    rs = r.infer()
    assert s.facts_inferred == rs.facts_inferred
    assert e.store.num_facts() == r.store.num_facts()
    assert decoded_fact_checksum(e) == ref_checksum(r)
    st = e.ops.residency_stats()
    assert st["columns_coded"] > 0
    assert st["resident_bytes_coded"] < st["resident_bytes_raw"]
    if sort_mode == "sketch":
        assert s.sketch_misses > 0  # the planner read device sketches
