"""SSD sequence pass: the intra-chunk kernel + the inter-chunk recurrence
(port of the reference ``kernels/ssd/ops.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ssd import ssd_intra


def ssd_chunked(cum, u, B, C, h0=None):
    """Full SSD sequence pass from chunked views.

    cum [b,nc,Q,nh] (within-chunk cumulative log decay); u [b,nc,Q,nh,hp]
    (dt-weighted inputs); B/C [b,nc,Q,N], all float32.
    -> (y [b,nc,Q,nh,hp], h_last [b,nh,hp,N]).

    The intra-chunk term goes through ``ssd_intra`` (the kernel on a CUDA
    tensor); the recurrence over chunk states is a loop over chunks, the
    reference's ``lax.scan``.
    """
    b, nc, Q, nh = cum.shape
    hp, N = u.shape[-1], B.shape[-1]
    y_intra, states = ssd_intra(cum.contiguous(), u.contiguous(),
                                B.contiguous(), C.contiguous())
    a_tot = torch.exp(cum[:, :, -1, :])                      # [b,nc,nh]
    h = (torch.zeros((b, nh, hp, N), dtype=torch.float32, device=cum.device)
         if h0 is None else h0)
    h_in = torch.empty_like(states)                          # state BEFORE chunk
    for c in range(nc):
        h_in[:, c] = h
        h = a_tot[:, c, :, None, None] * h + states[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C, h_in) \
        * torch.exp(cum)[..., None]
    return y_intra + y_inter, h
