"""Stock-torch oracle for the SSD intra-chunk kernel (tests only): the
reference ``ref.py``'s einsums with the decay matrix materialized."""

import torch


def ssd_intra_ref(cum, u, B, C):
    """Mirror of ``models/mamba2.py``'s chunk math (intra + chunk states)."""
    b, nc, Q, nh = cum.shape
    gram = torch.einsum("bcqn,bckn->bcqk", C.float(), B.float())
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,Q,K,nh]
    ar = torch.arange(Q, device=cum.device)
    mask = ar[:, None] >= ar[None, :]
    M = torch.where(mask[None, None, :, :, None], torch.exp(decay), 0.0) \
        * gram[..., None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, u.float())
    w = torch.exp(cum[:, :, -1, None, :] - cum)               # [b,nc,Q,nh]
    st = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w, u.float(), B.float())
    return y, st
