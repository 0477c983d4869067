"""Stock-torch oracles for the probe kernel and the bounded join (tests
only; the port's path never calls them)."""

import numpy as np
import torch


def probe_ref(l_keys: torch.Tensor, r_sorted: torch.Tensor):
    return (torch.searchsorted(r_sorted, l_keys).to(torch.int32),
            torch.searchsorted(r_sorted, l_keys, right=True).to(torch.int32))


def join_pairs_ref(l_keys: np.ndarray, r_keys: np.ndarray):
    """Nested-loop oracle: all (li, ri) index pairs with equal keys."""
    l_keys, r_keys = np.asarray(l_keys), np.asarray(r_keys)
    li, ri = np.nonzero(l_keys[:, None] == r_keys[None, :])
    return list(zip(li.tolist(), ri.tolist()))
