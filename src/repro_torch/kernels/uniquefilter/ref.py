"""Stock-torch oracle for the unique-mask kernel (tests only; the port's
path never calls it).  It marks run starts from
``torch.unique_consecutive``'s run lengths, independent of the plain
version's neighbour compare."""

import torch


def unique_mask_ref(x_sorted: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(x_sorted.shape[0], dtype=torch.bool,
                       device=x_sorted.device)
    if x_sorted.shape[0]:
        _, counts = torch.unique_consecutive(x_sorted, return_counts=True)
        mask[torch.cumsum(counts, 0) - counts] = True
    return mask
