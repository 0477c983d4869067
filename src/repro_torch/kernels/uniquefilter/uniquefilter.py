"""SU unique filter: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/uniquefilter/uniquefilter.py``
``unique_mask_sorted`` (paper §2.4 deduplication): on a *sorted* array an
element is first of its run iff it differs from its predecessor.  The
kernel (``csrc/unique_mask.cu``) gives each thread eight consecutive
keys and takes the key before them from the neighbouring lane, so the
Pallas kernel's block padding and previous-tile input have no
counterpart; the contract that only lanes ``< n`` count is kept.  A
contiguous input that starts 8 bytes past a 16-byte boundary (``x[1:]``)
is taken as it is.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build


def unique_mask_sorted_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): lane 0, and every lane whose
    value differs from the lane before it."""
    mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    mask[1:] = x[1:] != x[:-1]
    return mask


def unique_mask_sorted(x: torch.Tensor) -> torch.Tensor:
    """Boolean first-of-run mask for a sorted 1-D int64 tensor."""
    if x.device.type == "cpu":
        return unique_mask_sorted_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unique_mask_sorted: unsupported device {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"unique_mask_sorted: dtype {x.dtype}, expected "
                        "int64 (widen narrow codes first)")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("unique_mask_sorted: expects a contiguous 1-D "
                         "tensor")
    n = x.shape[0]
    mask = torch.empty(n, dtype=torch.bool, device=x.device)
    if n == 0:
        return mask
    lib = _build.library("unique_mask")
    _build.check(lib.unique_mask_i64(
        x.data_ptr(), n, mask.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream),
        "unique_mask_sorted")
    kernels.LAUNCHES["unique_mask_sorted"] += 1
    kernels.count_search_size("unique_mask_sorted", n)
    return mask
