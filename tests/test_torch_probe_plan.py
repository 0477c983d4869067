"""The probe kernel's staged search, held against searchsorted (CPU).

``csrc/probe_sorted.cu`` searches a shared-memory table of every
``2^s``-th right key, finishes the lower bound in one window of ``2^s``
keys in device memory, carries the key found there out of the search and
gallops from it to the upper bound.  ``mergejoin.probe_plan`` mirrors
the choice of ``s`` and ``mergejoin.probe_staged`` the three stages.
Here the plan is checked at the table-size boundaries up to ``2^31 - 1``
and against the kernel's constant, and the staged model, at small table
sizes so that every stage runs, must equal ``torch.searchsorted`` and the
Pallas kernel (interpret mode) on the forms the engine gives the probe:
join pads, ``batch_probe``'s ``INT64_MAX`` tail, one run filling the
array, keys outside the right side.  The kernel itself is held against
the plain version on a card (``test_torch_cuda.py``).
"""

import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mergejoin.mergejoin import probe_sorted as pallas_probe
from repro_torch.kernels.mergejoin import mergejoin
from repro_torch.kernels.mergejoin.mergejoin import (PROBE_TABLE_LOG2,
                                                     probe_plan, probe_staged)
from test_torch_cuda import probe_case as case

CU = (Path(mergejoin.__file__).resolve().parents[1] / "csrc"
      / "probe_sorted.cu")
I64 = np.iinfo(np.int64)
BLOCK = 256


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def c_plan(m: int, table_log2: int) -> tuple[int, int]:
    """The plan as the kernel's host code computes it (a loop on s)."""
    s = 0
    while m > 0 and ((m - 1) >> s) + 1 > 1 << table_log2:
        s += 1
    return s, (((m - 1) >> s) + 1 if m > 0 else 0)


FORMS = ["dense", "random", "one_run", "join_pads", "batch_probe", "outside"]


def sizes_around(table_log2: int) -> list:
    """m from 1 up, and on each side of the table size and its double."""
    t = 1 << table_log2
    return sorted({1, 2, 3, 5, t - 1, t, t + 1, 2 * t - 1, 2 * t, 2 * t + 1,
                   8 * t + 3} - {0})


def test_constants_match_the_cuda_source():
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", CU.read_text(), re.M)}
    assert consts["PROBE_TABLE_LOG2"] == PROBE_TABLE_LOG2
    assert "PROBE_THREADS" in consts


@pytest.mark.parametrize("m", sorted({
    0, 1, 2, 3, (1 << PROBE_TABLE_LOG2) - 1, 1 << PROBE_TABLE_LOG2,
    (1 << PROBE_TABLE_LOG2) + 1, (2 << PROBE_TABLE_LOG2) - 1,
    2 << PROBE_TABLE_LOG2, (2 << PROBE_TABLE_LOG2) + 1, (1 << 18) + 7,
    1 << 21, (1 << 21) + 1, (1 << 30) + 1, (1 << 31) - 2, (1 << 31) - 1}))
def test_plan_at_boundaries(m):
    """The least s whose table holds every 2^s-th key in 2^14 entries."""
    s, table = probe_plan(m)
    assert (s, table) == c_plan(m, PROBE_TABLE_LOG2)
    assert table <= 1 << PROBE_TABLE_LOG2
    assert table << s >= m and (table - 1) << s < max(m, 1)
    if s:  # one step less would not fit
        assert ((m - 1) >> (s - 1)) + 1 > 1 << PROBE_TABLE_LOG2
    if m <= 1 << PROBE_TABLE_LOG2:
        assert (s, table) == (0, m)  # the whole array in shared memory
    if m == 1 << 21:
        assert (s, table) == (7, 1 << 14)  # windows of 128 keys


@pytest.mark.parametrize("table_log2", [0, 2, 3, 5])
@pytest.mark.parametrize("form", FORMS)
def test_staged_equals_searchsorted(form, table_log2):
    for m in sizes_around(table_log2):
        for n in (1, 7, 64):
            left, right = case(form, n, m, (table_log2,))
            lo, hi, loads = probe_staged(T(left), T(right), table_log2)
            assert lo.dtype == hi.dtype == torch.int32
            assert torch.equal(lo.long(), torch.searchsorted(T(right),
                                                             T(left))), m
            assert torch.equal(hi.long(), torch.searchsorted(
                T(right), T(left), right=True)), m
            s, _ = probe_plan(m, table_log2)
            if s == 0:  # the table is the array: no device-memory load
                assert int(loads.max()) == 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,table_log2", [(1, 2), (37, 3), (200, 4),
                                          (1000, 5), (33, 5)])
def test_staged_equals_pallas(form, m, table_log2):
    left, right = case(form, 300, m)
    lo, hi, _ = probe_staged(T(left), T(right), table_log2)
    wlo, whi = pallas_probe(jnp.asarray(left), jnp.asarray(right),
                            block=BLOCK, interpret=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))


@pytest.mark.parametrize("m", [(1 << PROBE_TABLE_LOG2) - 1,
                               1 << PROBE_TABLE_LOG2,
                               (1 << PROBE_TABLE_LOG2) + 1,
                               (1 << PROBE_TABLE_LOG2) * 4 + 3])
def test_staged_at_the_shipped_table(m):
    """The kernel's own table size: m just below, at and above it."""
    left, right = case("random", 4000, m)
    left[:5] = [I64.min, I64.max, right[0], right[-1], right[m // 2]]
    lo, hi, loads = probe_staged(T(left), T(right))
    assert torch.equal(lo.long(), torch.searchsorted(T(right), T(left)))
    assert torch.equal(hi.long(), torch.searchsorted(T(right), T(left),
                                                     right=True))
    s, _ = probe_plan(m)
    assert (int(loads.max()) == 0) == (s == 0)


def test_gallop_costs_log_run_length():
    """Distinct right keys: the window's s steps and at most one gallop
    load; one run filling the array: O(log m) gallop loads, not O(m)."""
    m, tl = 4096, 6
    s, _ = probe_plan(m, tl)
    right = np.arange(m, dtype=np.int64) * 3
    left = rng("gallop").randint(-5, 3 * m + 5, 2000).astype(np.int64)
    _, _, loads = probe_staged(T(left), T(right), tl)
    assert int(loads.max()) <= s + 1
    run = np.full(m, 9, dtype=np.int64)
    lo, hi, loads = probe_staged(T(np.array([9, 8, 10])), T(run), tl)
    assert lo.tolist() == [0, 0, m] and hi.tolist() == [m, 0, m]
    assert int(loads.max()) <= 2 * (m.bit_length() + 1) + s


def test_staged_empty_right_side():
    lo, hi, loads = probe_staged(T(np.arange(5, dtype=np.int64)),
                                 T(np.empty(0, np.int64)), 3)
    assert lo.tolist() == [0] * 5 and hi.tolist() == [0] * 5
    assert int(loads.sum()) == 0
