"""Unique filter: sort + first-of-run mask + compaction (the SU pipeline;
port of the reference ``kernels/uniquefilter/ops.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.sortmerge.ops import device_sort
from repro_torch.kernels.uniquefilter.uniquefilter import unique_mask_sorted


def unique_sorted_bounded(x: torch.Tensor):
    """Sort + dedup; returns (distinct values ascending, padded with the
    dtype's maximum to ``x``'s length, and the distinct count as a 0-d
    tensor).

    Narrow integer inputs (code-domain buffers of compressed columns)
    widen to int64 on entry, so the mask kernel and the pad sentinel see
    one dtype.  The compaction re-sort is stock torch, as the reference
    leaves it to XLA."""
    if not x.dtype.is_floating_point:
        x = x.to(torch.int64)
    s = device_sort(x)
    mask = unique_mask_sorted(s)
    big = (float("inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).max)
    vals = torch.sort(torch.where(mask, s, big)).values
    return vals, mask.sum()
