"""Fork-join bitonic sort: CUDA kernel wrappers and plain versions.

Port of the reference ``kernels/sortmerge/sortmerge.py`` ``bitonic_sort``
and ``bitonic_sort_kv`` (paper §2.3, Fig. 8).  The network is the same:
the array is padded to a power of two with the dtype's maximum, element
``i`` exchanges with ``i ^ j`` for every ``(k, j)`` pass, ascending iff
``i & k == 0``, and a pair swaps only on a strict order violation.  So the
CUDA kernel (``csrc/bitonic_sort.cu``), the plain versions below and the
Pallas kernel give bit-identical output, the key-value payload and the
order of tied keys included.

``merge_ranks`` is the port of the reference's two-run merge rank kernel
(``csrc/merge_ranks.cu``): the rank of every element of ``x`` in a
second sorted run, the core of the incremental index-mirror merge.

A wrapper given a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version — vectorised XOR-partner compare-exchanges over
the whole array, one pass per ``(k, j)``, and for the ranks the Pallas
kernel's branch-free search, ``log2(m) + 1`` masked halving steps.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build


def _pad_pow2(x: torch.Tensor, fill) -> torch.Tensor:
    n = x.shape[0]
    n_pad = 1 << max(n - 1, 0).bit_length()
    out = torch.full((n_pad,), fill, dtype=x.dtype, device=x.device)
    out[:n] = x
    return out


def _passes(n_pad: int):
    k = 2
    while k <= n_pad:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def bitonic_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the network (any device)."""
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    xp = _pad_pow2(x, torch.iinfo(x.dtype).max)
    idx = torch.arange(xp.shape[0], device=x.device)
    for k, j in _passes(xp.shape[0]):
        px = xp[idx ^ j]
        # the lower lane of an ascending pair (and the upper lane of a
        # descending one) keeps the minimum
        take_min = ((idx & j) == 0) == ((idx & k) == 0)
        xp = torch.where(take_min, torch.minimum(xp, px),
                         torch.maximum(xp, px))
    return xp[:n]


def bitonic_sort_kv_plain(keys: torch.Tensor, vals: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the key-value network (any device)."""
    n = keys.shape[0]
    if n <= 1:
        return keys.clone(), vals.clone()
    kp = _pad_pow2(keys, torch.iinfo(keys.dtype).max)
    vp = _pad_pow2(vals, 0)
    idx = torch.arange(kp.shape[0], device=keys.device)
    for k, j in _passes(kp.shape[0]):
        part = idx ^ j
        pk, pv = kp[part], vp[part]
        is_lo = (idx & j) == 0
        a = torch.where(is_lo, kp, pk)  # lower lane's key
        b = torch.where(is_lo, pk, kp)  # upper lane's key
        # both lanes of a pair see the same (a, b), so they agree on the swap
        swap = torch.where((idx & k) == 0, a > b, a < b)
        kp = torch.where(swap, pk, kp)
        vp = torch.where(swap, pv, vp)
    return kp[:n], vp[:n]


def merge_ranks_plain(x: torch.Tensor, other_sorted: torch.Tensor,
                      side_right: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the rank search (any device): int32
    ``searchsorted(other_sorted, x, side)``."""
    n, m = x.shape[0], other_sorted.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=x.device)
    if m == 0:
        return lo.to(torch.int32)
    hi = torch.full((n,), m, dtype=torch.int64, device=x.device)
    for _ in range(max(1, (m - 1).bit_length()) + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        v = other_sorted[mid.clamp(0, m - 1)]
        go = (v <= x) if side_right else (v < x)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo.to(torch.int32)


def _check_cuda(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous 1-D tensor")


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort a 1-D int32/int64 tensor ascending."""
    if x.device.type == "cpu":
        return bitonic_sort_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bitonic_sort: unsupported device {x.device}")
    _check_cuda("bitonic_sort", x, (torch.int64, torch.int32))
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    xp = _pad_pow2(x, torch.iinfo(x.dtype).max)
    lib = _build.library("bitonic_sort")
    fn = (lib.bitonic_sort_i64 if x.dtype == torch.int64
          else lib.bitonic_sort_i32)
    _build.check(fn(xp.data_ptr(), xp.shape[0],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "bitonic_sort")
    kernels.LAUNCHES["bitonic_sort"] += 1
    return xp[:n]


def bitonic_sort_kv(keys: torch.Tensor, vals: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-value sort: int64 keys carrying an int32 payload (unstable)."""
    if keys.device.type == "cpu" and vals.device.type == "cpu":
        return bitonic_sort_kv_plain(keys, vals)
    if keys.device.type != "cuda" or vals.device != keys.device:
        raise ValueError("bitonic_sort_kv: keys and vals must share one "
                         f"CUDA device, got {keys.device} and {vals.device}")
    _check_cuda("bitonic_sort_kv", keys, (torch.int64,))
    _check_cuda("bitonic_sort_kv", vals, (torch.int32,))
    n = keys.shape[0]
    if vals.shape[0] != n:
        raise ValueError("bitonic_sort_kv: keys and vals differ in length")
    if n <= 1:
        return keys.clone(), vals.clone()
    kp = _pad_pow2(keys, torch.iinfo(torch.int64).max)
    vp = _pad_pow2(vals, 0)
    lib = _build.library("bitonic_sort")
    _build.check(lib.bitonic_sort_kv_i64(
        kp.data_ptr(), vp.data_ptr(), kp.shape[0],
        torch.cuda.current_stream(keys.device).cuda_stream),
        "bitonic_sort_kv")
    kernels.LAUNCHES["bitonic_sort_kv"] += 1
    return kp[:n], vp[:n]


def merge_ranks(x: torch.Tensor, other_sorted: torch.Tensor,
                side_right: bool = False) -> torch.Tensor:
    """Rank of every ``x`` element inside the sorted run ``other_sorted``
    (``searchsorted`` semantics: ``side_right=False`` counts strictly
    smaller elements, ``True`` counts <=), as int32.  Pad tails are the
    caller's business, as in the reference: they must sort above every
    real key, and the caller bounds the ranks by the run's real length."""
    if x.device.type == "cpu" and other_sorted.device.type == "cpu":
        return merge_ranks_plain(x, other_sorted, side_right)
    if x.device.type != "cuda" or other_sorted.device != x.device:
        raise ValueError("merge_ranks: both runs must share one CUDA "
                         f"device, got {x.device} and {other_sorted.device}")
    _check_cuda("merge_ranks", x, (torch.int64,))
    _check_cuda("merge_ranks", other_sorted, (torch.int64,))
    n, m = x.shape[0], other_sorted.shape[0]
    if m >= 1 << 31:
        raise ValueError("merge_ranks: int32 ranks need m < 2**31")
    ranks = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return ranks
    lib = _build.library("merge_ranks")
    _build.check(lib.merge_ranks_i64(
        x.data_ptr(), n, other_sorted.data_ptr(), m, int(side_right),
        ranks.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream),
        "merge_ranks")
    kernels.LAUNCHES["merge_ranks"] += 1
    return ranks
