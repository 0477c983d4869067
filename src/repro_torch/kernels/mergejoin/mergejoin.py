"""Sorted equi-join probe: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/mergejoin/mergejoin.py`` ``probe_sorted``
(paper fork-join instance 2): for every left key, the ``[lo, hi)`` run of
equal keys in a sorted right array, as int32 bounds.  The kernel
(``csrc/probe_sorted.cu``) runs one thread per left key over the right
array in device memory; the plain version is the Pallas kernel's
branch-free search — ``log2(m) + 1`` masked halving steps over all left
keys at once.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.sortmerge.sortmerge import merge_ranks_plain


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
    lib = _build.library("probe_sorted")
    _build.check(lib.probe_sorted_i64(
        l_keys.data_ptr(), n, r_sorted.data_ptr(), m, lo.data_ptr(),
        hi.data_ptr(), torch.cuda.current_stream(l_keys.device).cuda_stream),
        "probe_sorted")
    kernels.LAUNCHES["probe_sorted"] += 1
    return lo, hi
