"""Sorted equi-join probe: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/mergejoin/mergejoin.py`` ``probe_sorted``
(paper fork-join instance 2): for every left key, the ``[lo, hi)`` run of
equal keys in a sorted right array, as int32 bounds.  The kernel
(``csrc/probe_sorted.cu``) searches a table of every ``2^s``-th right key
in shared memory, finishes the lower bound in one window of ``2^s`` keys
in device memory and gallops from it to the upper bound.  ``probe_plan``
gives ``s`` and the table's size (the wrapper allocates the table's
scratch by it); ``probe_staged`` mirrors the staging for the CPU tests.
The rank kernel of ``sortmerge.merge_ranks`` searches the same tree
(``csrc/splitter_tree.cuh``) for one bound; ``merge_ranks_plan`` and
``merge_ranks_staged`` mirror it.
The plain version is the Pallas kernel's branch-free search —
``log2(m) + 1`` masked halving steps over all left keys at once.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.sortmerge.sortmerge import merge_ranks_plain

# the splitter table's most entries, log2 (PROBE_TABLE_LOG2 of
# csrc/probe_sorted.cu)
PROBE_TABLE_LOG2 = 14


def probe_plan(m: int, table_log2: int | None = None) -> tuple[int, int]:
    """(s, table entries) of the kernel for ``m`` right keys: the least
    ``s`` with ``ceil(m / 2^s) <= 2^table_log2`` (by default the kernel's
    ``PROBE_TABLE_LOG2``), and that ceiling."""
    if table_log2 is None:
        table_log2 = PROBE_TABLE_LOG2
    s = max(max(m - 1, 0).bit_length() - table_log2, 0)
    return s, (((m - 1) >> s) + 1 if m else 0)


# the rank kernel's tree (the RANK_* constants of csrc/merge_ranks.cu):
# its most slots, log2, and the smaller tree it takes for few keys
RANK_TABLE_LOG2 = 14
RANK_SMALL_N_LOG2 = 13
RANK_SMALL_TABLE_LOG2 = 8


def merge_ranks_plan(n: int, m: int, table_log2: int | None = None
                     ) -> tuple[int, int]:
    """(s, table entries) of the rank kernel for ``n`` keys against ``m``
    sorted keys: ``probe_plan`` at the tree size the kernel takes for
    ``n`` (``RANK_SMALL_TABLE_LOG2`` slots at most when ``n <=
    2^RANK_SMALL_N_LOG2``, where each block loads its tree itself, else
    ``RANK_TABLE_LOG2``, gathered once into scratch when ``s > 0``), or
    at ``table_log2`` when given."""
    if table_log2 is None:
        table_log2 = (RANK_SMALL_TABLE_LOG2 if n <= 1 << RANK_SMALL_N_LOG2
                      else RANK_TABLE_LOG2)
    return probe_plan(m, table_log2)


def _before(v, key, side_right: bool):
    return (v <= key) if side_right else (v < key)


def _at(src, i):
    return src[i.clamp(0, src.shape[0] - 1)]


def _tree_window(key, r, s: int, table: int, side_right: bool, loads):
    """Stages 1-2 of the kernels' search (csrc/splitter_tree.cuh), for
    ``table > 0``: the count of splitters ``r[j << s]`` before each key
    (``< key``, or ``<= key`` for side right), then ``s`` halving steps in
    its window.  The tree is modelled in sorted order; the kernel's holds
    the same splitters, and its descent gives the same count and carried
    key.  Returns the count of ``r``'s keys before each key and the right
    key the search carries out (the first one not before the key, where it
    read one); adds each key's device-memory loads to ``loads``."""
    n, m = key.shape[0], r.shape[0]
    tab = r[::1 << s]
    c = torch.zeros(n, dtype=torch.int64)
    step = 1 << (table.bit_length() - 1)
    while step:
        i = c + step - 1
        c += torch.where((i < table) & _before(_at(tab, i), key, side_right),
                         step, 0)
        step >>= 1
    pos = torch.where(c > 0, (c - 1) << s, -1)
    end = torch.where(c > 0, torch.clamp(c << s, max=m), 0)
    ub = torch.where(c < table, _at(tab, c), 0)
    for st in range(s - 1, -1, -1):
        p = pos + (1 << st)
        inw = p < end
        v = _at(r, p)
        go = _before(v, key, side_right)
        loads += inw.long()
        pos = torch.where(inw & go, p, pos)
        ub = torch.where(inw & ~go, v, ub)
    return pos + 1, ub


def probe_staged(l_keys: torch.Tensor, r_sorted: torch.Tensor,
                 table_log2: int | None = None):
    """Test-only model of the kernel's staged search (never on the main
    path): the count of splitters below each key, the halving steps in its
    window with the key at the lower bound carried out, and the gallop to
    the upper bound.  Returns ``(lo, hi, loads)``: int32 bounds and, per
    key, the right keys read from device memory after the table load (0
    throughout when the table holds every key)."""
    n, m = l_keys.shape[0], r_sorted.shape[0]
    s, table = probe_plan(m, table_log2)
    key = l_keys.to(torch.int64)
    r = r_sorted.to(torch.int64)
    loads = torch.zeros(n, dtype=torch.int64)
    if table == 0:
        zero = torch.zeros(n, dtype=torch.int32)
        return zero, zero.clone(), loads
    # 1-2. the lower bound, with the right key there carried out
    lo, ub = _tree_window(key, r, s, table, False, loads)
    # 3. the gallop from the lower bound, then halving over the last gap
    run = (lo < m) & (ub == key)
    live, gal = run.clone(), torch.ones(n, dtype=torch.bool)
    span = torch.ones(n, dtype=torch.int64)
    pos = lo.clone()
    while bool(live.any()):
        p = pos + span
        ok = live & (p < m) & (_at(r, p) <= key)
        if s:
            loads += (live & (p < m)).long()
        pos = torch.where(ok, p, pos)
        span = torch.where(live, torch.where(gal & ok, span << 1, span >> 1),
                           span)
        gal &= ok | ~live
        live &= span != 0
    hi = torch.where(run, pos + 1, lo)
    return lo.to(torch.int32), hi.to(torch.int32), loads


def merge_ranks_staged(x: torch.Tensor, other_sorted: torch.Tensor,
                       side_right: bool = False,
                       table_log2: int | None = None):
    """Test-only model of the rank kernel's search (``csrc/merge_ranks.cu``,
    never on the main path): ``merge_ranks_plan``'s tree, its descent and
    the ``s`` halving steps in the window, one side's bound only.  Returns
    ``(ranks, loads)``: int32 ranks and, per key, the keys of
    ``other_sorted`` read from device memory after the tree load (0
    throughout when the tree holds every key)."""
    n, m = x.shape[0], other_sorted.shape[0]
    s, table = merge_ranks_plan(n, m, table_log2)
    loads = torch.zeros(n, dtype=torch.int64)
    if table == 0:
        return torch.zeros(n, dtype=torch.int32), loads
    ranks, _ = _tree_window(x.to(torch.int64), other_sorted.to(torch.int64),
                            s, table, side_right, loads)
    return ranks.to(torch.int32), loads


def probe_sorted_plain(l_keys: torch.Tensor, r_sorted: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): the two masked-halving
    searches of the merge-rank plain version, left side and right side."""
    return (merge_ranks_plain(l_keys, r_sorted, side_right=False),
            merge_ranks_plain(l_keys, r_sorted, side_right=True))


def probe_sorted(l_keys: torch.Tensor, r_sorted: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 run bounds in ``r_sorted`` for every left key."""
    if l_keys.device.type == "cpu" and r_sorted.device.type == "cpu":
        return probe_sorted_plain(l_keys, r_sorted)
    if l_keys.device.type != "cuda" or r_sorted.device != l_keys.device:
        raise ValueError("probe_sorted: both sides must share one CUDA "
                         f"device, got {l_keys.device} and {r_sorted.device}")
    for name, t in (("left", l_keys), ("right", r_sorted)):
        if t.dtype != torch.int64:
            raise TypeError(f"probe_sorted: {name} dtype {t.dtype}, "
                            "expected int64")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"probe_sorted: {name} must be a contiguous "
                             "1-D tensor")
    n, m = l_keys.shape[0], r_sorted.shape[0]
    if m >= 1 << 31:
        raise ValueError("probe_sorted: int32 bounds need m < 2**31")
    lo = torch.empty(n, dtype=torch.int32, device=l_keys.device)
    hi = torch.empty(n, dtype=torch.int32, device=l_keys.device)
    if n == 0:
        return lo, hi
    # scratch for the table's tree (2^ceil(log2 table) slots) when the
    # table is not the whole right array
    s, table = probe_plan(m)
    tree = torch.empty(1 << max(table - 1, 0).bit_length() if s else 0,
                       dtype=torch.int64, device=l_keys.device)
    lib = _build.library("probe_sorted")
    _build.check(lib.probe_sorted_i64(
        l_keys.data_ptr(), n, r_sorted.data_ptr(), m, lo.data_ptr(),
        hi.data_ptr(), tree.data_ptr(), tree.shape[0],
        torch.cuda.current_stream(l_keys.device).cuda_stream),
        "probe_sorted")
    kernels.LAUNCHES["probe_sorted"] += 1
    kernels.count_search_size("probe_sorted", n, m)
    return lo, hi
