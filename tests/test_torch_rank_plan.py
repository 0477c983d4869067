"""The rank kernel's plan and staged search, held against searchsorted (CPU).

``csrc/merge_ranks.cu`` searches the probe's shared-memory splitter tree
(``csrc/splitter_tree.cuh``) for one bound: the tree of every ``2^s``-th
key of the sorted run, at most ``2^RANK_TABLE_LOG2`` slots (fewer for few
keys), then ``s`` halving steps in one window in device memory.
``mergejoin.merge_ranks_plan`` mirrors the plan and
``mergejoin.merge_ranks_staged`` the search.  Here the plan is checked at
the tree-size boundaries and against the kernel's constants, and the
staged model must equal ``torch.searchsorted`` and the Pallas
``merge_ranks`` (interpret mode) on both sides, for keys in any order with
duplicates and on the forms ``merge_runs`` gives the kernel: both runs
with ``INT64_MAX`` pad tails.  The kernel itself is held against the plain
version on a card (``test_torch_cuda.py``).
"""

import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sortmerge.sortmerge import merge_ranks as pallas_ranks
from repro_torch.kernels.mergejoin import mergejoin
from repro_torch.kernels.mergejoin.mergejoin import (RANK_SMALL_N_LOG2,
                                                     RANK_SMALL_TABLE_LOG2,
                                                     RANK_TABLE_LOG2,
                                                     merge_ranks_plan,
                                                     merge_ranks_staged)
from repro_torch.kernels.sortmerge.sortmerge import (merge_ranks,
                                                     merge_ranks_plain)
from test_torch_cuda import rank_case

CU = (Path(mergejoin.__file__).resolve().parents[1] / "csrc"
      / "merge_ranks.cu")
I64 = np.iinfo(np.int64)
TREE = 1 << RANK_TABLE_LOG2
SIDES = pytest.mark.parametrize("side_right", [False, True],
                                ids=["left", "right"])


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def c_plan(n: int, m: int) -> tuple[int, int]:
    """The plan as the kernel's host code computes it (a loop on s)."""
    lg = (RANK_SMALL_TABLE_LOG2 if n <= 1 << RANK_SMALL_N_LOG2
          else RANK_TABLE_LOG2)
    s = 0
    while m > 0 and ((m - 1) >> s) + 1 > 1 << lg:
        s += 1
    return s, (((m - 1) >> s) + 1 if m > 0 else 0)


FORMS = ["dups", "pads", "extremes"]  # rank_case's forms


def test_constants_match_the_cuda_source():
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", CU.read_text(), re.M)}
    assert consts["RANK_TABLE_LOG2"] == RANK_TABLE_LOG2
    assert consts["RANK_SMALL_N_LOG2"] == RANK_SMALL_N_LOG2
    assert consts["RANK_SMALL_TABLE_LOG2"] == RANK_SMALL_TABLE_LOG2
    assert "RANK_THREADS" in consts
    assert '#include "splitter_tree.cuh"' in CU.read_text()


@pytest.mark.parametrize("m", sorted({0, 1, 2, 5, 31, TREE - 1, TREE,
                                      TREE + 1, 2 * TREE + 1, 1 << 21}))
@pytest.mark.parametrize("n", [1, 1 << RANK_SMALL_N_LOG2,
                               (1 << RANK_SMALL_N_LOG2) + 1, 1 << 21])
def test_plan_at_boundaries(n, m):
    """The least s whose tree holds every 2^s-th key in the slots the
    kernel takes for n keys."""
    s, table = merge_ranks_plan(n, m)
    assert (s, table) == c_plan(n, m)
    assert table << s >= m and (table - 1) << s < max(m, 1)
    lg = (RANK_SMALL_TABLE_LOG2 if n <= 1 << RANK_SMALL_N_LOG2
          else RANK_TABLE_LOG2)
    assert table <= 1 << lg
    if m <= 1 << lg:
        assert (s, table) == (0, m)  # the whole run in shared memory


def check_staged(x, other, side_right, table_log2=None):
    ranks, loads = merge_ranks_staged(T(x), T(other), side_right, table_log2)
    assert ranks.dtype == torch.int32
    want = torch.searchsorted(T(other), T(x), right=side_right)
    assert torch.equal(ranks.long(), want)
    s, _ = merge_ranks_plan(len(x), len(other), table_log2)
    assert int(loads.max()) <= s  # one load a window step
    if s == 0:  # the tree is the run: no device-memory load
        assert int(loads.sum()) == 0
    return ranks


@SIDES
@pytest.mark.parametrize("table_log2", [0, 2, 3, 5])
@pytest.mark.parametrize("form", FORMS)
def test_staged_equals_searchsorted(form, table_log2, side_right):
    """Small trees, so that the window runs: m on each side of the tree
    size and its double."""
    t = 1 << table_log2
    for m in sorted({1, 2, 3, 5, t - 1, t, t + 1, 2 * t + 1, 8 * t + 3}
                    - {0}):
        for n in (1, 7, 64):
            check_staged(*rank_case(form, n, m, (table_log2,)), side_right,
                         table_log2)


@SIDES
@pytest.mark.parametrize("m", [1, 5, 31, TREE - 1, TREE, TREE + 1])
@pytest.mark.parametrize("form", FORMS)
def test_staged_at_the_shipped_tree(form, m, side_right):
    """The kernel's own tree sizes: m below 32, and just below, at and
    above 2^RANK_TABLE_LOG2; n on both sides of the small-n tree."""
    for n in (3000, (1 << RANK_SMALL_N_LOG2) + 1):
        check_staged(*rank_case(form, n, m, ("shipped",)), side_right)


@SIDES
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m,table_log2", [(1, 2), (37, 3), (200, 4),
                                          (1000, 5), (33, 5)])
def test_staged_equals_pallas(form, m, table_log2, side_right):
    x, other = rank_case(form, 300, m, ("pallas",))
    ranks, _ = merge_ranks_staged(T(x), T(other), side_right, table_log2)
    want = pallas_ranks(jnp.asarray(x), jnp.asarray(other),
                        side_right=side_right, block=256, interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want))


@SIDES
def test_wrapper_on_cpu_is_the_plain_version(side_right):
    x, other = rank_case("dups", 500, 300)
    got = merge_ranks(T(x), T(other), side_right=side_right)
    assert torch.equal(got, merge_ranks_plain(T(x), T(other), side_right))


def test_staged_empty_run():
    ranks, loads = merge_ranks_staged(T(np.arange(5, dtype=np.int64)),
                                      T(np.empty(0, np.int64)), True)
    assert ranks.tolist() == [0] * 5 and int(loads.sum()) == 0
