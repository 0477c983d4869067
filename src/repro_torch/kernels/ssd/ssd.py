"""Mamba-2 SSD intra-chunk term: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/ssd/ssd.py`` ``ssd_intra``
(``_ssd_intra_kernel``).  Per (batch, chunk, head)::

    y[i]  = sum_{j<=i} exp(cum[i] - cum[j]) (C[i] . B[j]) u[j]
    state = sum_j exp(cum[Q-1] - cum[j]) u[j] (x) B[j]

The kernel (``csrc/ssd_intra.cu``) forms the gram ``C . B^T`` once per
(batch, chunk) in a first pass, into scratch the wrapper allocates
(``gram_scratch``), then runs one block per (batch, chunk, head) over row
and column tiles, both products on Hopper's tensor cores (``wgmma``) in
split TF32 (three TF32 products a pair, float32 precision).
``ssd_intra_staged`` mirrors that order of work and rounding on the CPU
for the tests.
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


# the kernel's tiles (the constants of csrc/ssd_intra.cu): the gram pass's
# square tile, and the head kernel's row and column tiles
SSD_GRAM_TILE = 64
SSD_ROW_TILE = 128
SSD_COL_TILE = 32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to 10
    mantissa bits, to nearest, ties away from zero (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | (bits & -0x80000000)).view(torch.float32)


def _split_mm(a, b, one_pass: bool):
    """a @ b as the kernel's tensor cores form it: a = hi + lo and b = hi
    + lo in TF32, then lo.hi + hi.lo + hi.hi in float32 (or hi.hi
    alone, one-pass TF32)."""
    ah, bh = tf32(a), tf32(b)
    if one_pass:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_intra_staged(cum, u, B, C, one_pass: bool = False):
    """Test-only model of the kernel's order of work and rounding (never on
    the main path): the gram once per (batch, chunk) over ``QP = Q``
    rounded up to ``SSD_ROW_TILE``, zero-padded; then per row tile of
    ``SSD_ROW_TILE`` rows the column tiles of ``SSD_COL_TILE`` rows up to
    its diagonal, ``M``'s tile formed from the gram tile and the decay,
    ``y`` accumulated tile by tile; the state, as ``st^T = (w o B)^T u``,
    from the column tiles at or past each row tile's first row.  Every
    product in split TF32 (``_split_mm``: the left operand is the one the
    kernel holds in registers).  CPU float32 tensors in, ``(y, states)``
    out."""
    b, nc, Q, nh = cum.shape
    hp, N = u.shape[-1], B.shape[-1]
    QP = -(-Q // SSD_ROW_TILE) * SSD_ROW_TILE
    pad = QP - Q
    # [b*nc, QP, ...] views, zero rows past Q
    Bp = torch.nn.functional.pad(B.reshape(b * nc, Q, N), (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(C.reshape(b * nc, Q, N), (0, 0, 0, pad))
    gram = _split_mm(Cp, Bp.transpose(1, 2), one_pass)       # [bc, QP, QP]
    cs = torch.nn.functional.pad(
        cum.reshape(b * nc, Q, nh).transpose(1, 2), (0, pad))  # [bc, nh, QP]
    up = torch.nn.functional.pad(
        u.reshape(b * nc, Q, nh, hp).permute(0, 2, 1, 3),
        (0, 0, 0, pad))                                        # [bc,nh,QP,hp]
    w = torch.where(torch.arange(QP) < Q,
                    torch.exp(cs[..., Q - 1:Q] - cs), 0.0)    # [bc, nh, QP]
    wB = Bp[:, None] * w[..., None]                           # [bc,nh,QP,N]
    y = torch.zeros_like(up)
    stT = torch.zeros((b * nc, nh, N, hp), dtype=torch.float32)
    rows = torch.arange(QP)
    for i0 in range(0, Q, SSD_ROW_TILE):
        ri = rows[i0:i0 + SSD_ROW_TILE]
        for j0 in range(0, min(Q, i0 + SSD_ROW_TILE), SSD_COL_TILE):
            rj = rows[j0:j0 + SSD_COL_TILE]
            decay = cs[..., ri, None] - cs[..., None, rj]      # [bc,nh,TR,TJ]
            g = gram[:, None, i0:i0 + SSD_ROW_TILE, j0:j0 + SSD_COL_TILE]
            M = torch.where(rj[None, :] <= ri[:, None], torch.exp(decay) * g,
                            0.0)
            y[..., i0:i0 + SSD_ROW_TILE, :] += _split_mm(
                M, up[..., j0:j0 + SSD_COL_TILE, :], one_pass)
            if j0 >= i0:
                stT += _split_mm(wB[..., j0:j0 + SSD_COL_TILE, :].transpose(
                    2, 3), up[..., j0:j0 + SSD_COL_TILE, :], one_pass)
    y = y[..., :Q, :].permute(0, 2, 1, 3).reshape(b, nc, Q, nh, hp)
    st = stT.transpose(2, 3).reshape(b, nc, nh, hp, N)
    return y.contiguous(), st.contiguous()


def gram_scratch(b: int, nc: int, Q: int, device) -> torch.Tensor:
    """The kernel's gram scratch: ``b * nc`` squares of ``QP = Q`` rounded
    up to ``SSD_ROW_TILE``, float32."""
    qp = -(-Q // SSD_ROW_TILE) * SSD_ROW_TILE
    return torch.empty(b * nc * qp * qp, dtype=torch.float32, device=device)


def ssd_intra(cum: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cum [b,nc,Q,nh]; u [b,nc,Q,nh,hp]; B/C [b,nc,Q,N], float32.

    -> (y_intra [b,nc,Q,nh,hp], states [b,nc,nh,hp,N]), float32.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises — also when it requires grad, since the kernel has no
    backward."""
    fake = kernels.is_fake(cum)
    if cum.device.type == "cpu" and not fake:
        return ssd_intra_plain(cum, u, B, C)
    if cum.device.type != "cuda" and not fake:
        raise ValueError(f"ssd_intra: unsupported device {cum.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (cum, u, B, C)):
        raise RuntimeError(
            "ssd_intra: the kernel has no backward and would drop the "
            "gradient; train through the training route "
            "(apply_ssd(..., train=True), the reference's chunk scan, as "
            "loss_fn does)")
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
    gram = gram_scratch(b, nc, Q, cum.device)

    def work():
        return ssd_intra_work(b, nc, Q, nh, hp, N)
    if fake:
        kernels.launched(("ssd_intra",), cum.device, work, real=False)
        return y, st
    lib = _build.library("ssd_intra")
    _build.check(lib.ssd_intra_f32(
        cum.data_ptr(), u.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), st.data_ptr(), b, nc, Q, nh, hp, N, gram.data_ptr(),
        gram.shape[0], torch.cuda.current_stream(cum.device).cuda_stream),
        "ssd_intra")
    kernels.launched(("ssd_intra",), cum.device, work)
    return y, st


def ssd_intra_work(b: int, nc: int, Q: int, nh: int, hp: int,
                   N: int) -> tuple[int, int]:
    """(operations, bytes) of one launch, as its bound counts them: the
    gram ``C B^T``'s lower triangle once per (b, chunk), and per head the
    decay (an exp of a difference, times the gram), ``M u`` over the
    triangle, the state weights and the state product ``u^T B``, 2 per
    multiply-add; cum, u, B, C read once, y and the states written once
    (float32)."""
    tri = Q * (Q + 1) // 2
    ops = b * nc * (tri * N * 2 + nh * (tri * 2 + tri * hp * 2 + Q * hp
                                        + Q * hp * N * 2))
    nbytes = 4 * (b * nc * Q * nh + 2 * b * nc * Q * nh * hp
                  + 2 * b * nc * Q * N + b * nc * nh * hp * N)
    return ops, nbytes
