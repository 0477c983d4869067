"""Stock-torch oracles for the bitonic sort kernels (tests only; the
port's path never calls them)."""

import torch


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x).values


def sort_kv_ref(keys: torch.Tensor, vals: torch.Tensor):
    order = torch.argsort(keys, stable=True)
    return keys[order], vals[order]


def merge_ranks_ref(x: torch.Tensor, other_sorted: torch.Tensor,
                    side_right: bool = False) -> torch.Tensor:
    return torch.searchsorted(other_sorted, x,
                              right=side_right).to(torch.int32)
