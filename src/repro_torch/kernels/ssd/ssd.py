"""Mamba-2 SSD intra-chunk term: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/ssd/ssd.py`` ``ssd_intra``
(``_ssd_intra_kernel``).  Per (batch, chunk, head)::

    y[i]  = sum_{j<=i} exp(cum[i] - cum[j]) (C[i] . B[j]) u[j]
    state = sum_j exp(cum[Q-1] - cum[j]) u[j] (x) B[j]

The kernel (``csrc/ssd_intra.cu``) tiles the rows of a chunk, because
the Pallas kernel's whole-chunk ``[Q, Q]`` gram does not fit a Hopper
block's shared memory at Q = 256; the state is a second small product.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build


def ssd_intra_plain(cum, u, B, C):
    """Plain PyTorch version (any device): the Pallas kernel's products
    for all heads at once, the gram once per (batch, chunk)."""
    Q = cum.shape[2]
    gram = torch.einsum("bcqn,bckn->bcqk", C, B)             # [b,nc,Q,Q]
    ar = torch.arange(Q, device=cum.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [b,nc,Q,K,nh]
    M = torch.where(mask, gram[..., None] * torch.exp(decay), 0.0)
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, u)
    wu = u * torch.exp(cum[:, :, -1:, :] - cum)[..., None]   # [b,nc,Q,nh,hp]
    st = torch.einsum("bcqhp,bcqn->bchpn", wu, B)
    return y, st


def ssd_intra(cum: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cum [b,nc,Q,nh]; u [b,nc,Q,nh,hp]; B/C [b,nc,Q,N], float32.

    -> (y_intra [b,nc,Q,nh,hp], states [b,nc,nh,hp,N]), float32.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if cum.device.type == "cpu":
        return ssd_intra_plain(cum, u, B, C)
    if cum.device.type != "cuda":
        raise ValueError(f"ssd_intra: unsupported device {cum.device}")
    b, nc, Q, nh = cum.shape
    hp, N = u.shape[-1], B.shape[-1]
    ts = (cum, u, B, C)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_intra: expects float32 inputs")
    if (u.shape != (b, nc, Q, nh, hp) or B.shape != (b, nc, Q, N)
            or C.shape != B.shape or any(t.device != cum.device for t in ts)):
        raise ValueError("ssd_intra: cum [b,nc,Q,nh], u [b,nc,Q,nh,hp] and "
                         "B, C [b,nc,Q,N] on one device expected")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_intra: expects contiguous tensors")
    if hp > 128 or N > 128:
        raise ValueError(f"ssd_intra: head dim {hp} and state {N} must be "
                         "<= 128")
    y = torch.empty_like(u)
    st = torch.empty((b, nc, nh, hp, N), dtype=torch.float32,
                     device=cum.device)
    if y.numel() == 0:
        return y, st.zero_()
    lib = _build.library("ssd_intra")
    _build.check(lib.ssd_intra_f32(
        cum.data_ptr(), u.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), st.data_ptr(), b, nc, Q, nh, hp, N,
        torch.cuda.current_stream(cum.device).cuda_stream), "ssd_intra")
    kernels.LAUNCHES["ssd_intra"] += 1
    return y, st
