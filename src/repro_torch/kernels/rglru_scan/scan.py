"""RG-LRU linear scan: CUDA kernel wrapper and plain version.

``h_t = a_t h_{t-1} + b_t`` along axis 1 of float32 [B, S, D] tensors,
from ``h_{-1} = h0`` (or 0).  Not a Pallas kernel: the reference runs this
step as ``jax.lax.associative_scan`` in XLA (``models/rglru.py``'s
``_linear_scan``).  The kernel (``csrc/linear_scan.cu``) gives each block
32 channels and walks the sequence in tiles of ``SCAN_WARPS`` segments of
``SCAN_SEG`` rows: each thread scans its segment from 0, the segments'
(decay, state) pairs are composed across the tile in shared memory onto
the carry, and each thread reruns its segment from the state entering it.
It reads a and b once and writes h once.  ``linear_scan_staged`` mirrors
that order of work on the CPU for the tests.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

# the kernel's shape (the constants of csrc/linear_scan.cu): channels a
# block, segments a tile, rows a segment
SCAN_CH = 32
SCAN_WARPS = 8
SCAN_SEG = 16


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version (any device), Hillis-Steele: after the pass
    at offset ``off`` each position holds the composition of the (up to)
    2*off steps ending at it, so ceil(log2 S) passes of elementwise
    products finish the scan (12 at S = 4096) — no loop over positions.
    Each pass rewrites only the positions from ``off`` on, in place in
    one copy of ``a`` and ``b``; its right-hand side is formed before the
    write."""
    a, b = a.clone(), b.clone()
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    S = a.shape[1]
    off = 1
    while off < S:
        b[:, off:] = torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])
        if 2 * off < S:  # the last pass needs no composed decay
            a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return b


def linear_scan_staged(a: torch.Tensor, b: torch.Tensor,
                       h0: torch.Tensor | None = None) -> torch.Tensor:
    """Test-only model of the kernel's order of work (never on the main
    path): channels padded to whole groups of ``SCAN_CH`` and rows to
    whole tiles of ``SCAN_WARPS * SCAN_SEG``, both with the identity step
    (a = 1, b = 0); per tile (1) each segment scanned from 0 to its
    composed decay and end state, (2) the segments' pairs composed in
    order onto the carry into the tile (the state entering each segment,
    and the carry out), (3) each segment rerun from its entering state.
    CPU float32 tensors in, h out."""
    B, S, D = a.shape
    tile = SCAN_WARPS * SCAN_SEG
    nt = -(-S // tile)
    dp = -(-D // SCAN_CH) * SCAN_CH
    pad = (0, dp - D, 0, nt * tile - S)
    ap = torch.nn.functional.pad(a, pad, value=1.0)
    bp = torch.nn.functional.pad(b, pad, value=0.0)
    ap = ap.reshape(B, nt, SCAN_WARPS, SCAN_SEG, dp)
    bp = bp.reshape(B, nt, SCAN_WARPS, SCAN_SEG, dp)
    carry = torch.zeros((B, dp), dtype=a.dtype)
    if h0 is not None:
        carry[:, :D] = h0
    out = torch.empty_like(ap)
    for k in range(nt):
        ta, tb = ap[:, k], bp[:, k]                  # [B, warps, seg, dp]
        A = torch.ones_like(ta[:, :, 0])
        H = torch.zeros_like(tb[:, :, 0])
        for i in range(SCAN_SEG):
            H = ta[:, :, i] * H + tb[:, :, i]
            A = A * ta[:, :, i]
        mine = torch.empty_like(H)
        for j in range(SCAN_WARPS):
            mine[:, j] = carry
            carry = A[:, j] * carry + H[:, j]
        hv = mine
        for i in range(SCAN_SEG):
            hv = ta[:, :, i] * hv + tb[:, :, i]
            out[:, k, :, i] = hv
    return out.reshape(B, nt * tile, dp)[:, :S, :D].contiguous()


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b [B, S, D], h0 [B, D] or None, float32 -> h [B, S, D].

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises — also when an input requires grad, since the kernel
    has no backward."""
    fake = kernels.is_fake(a)
    if a.device.type == "cpu" and not fake:
        return linear_scan_plain(a, b, h0)
    if a.device.type != "cuda" and not fake:
        raise ValueError(f"linear_scan: unsupported device {a.device}")
    ts = (a, b) if h0 is None else (a, b, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "linear_scan: the kernel has no backward and would drop the "
            "gradient; train through the training route "
            "(apply_rglru(..., train=True), the out-of-place scan, as "
            "loss_fn does)")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("linear_scan: expects float32 inputs")
    if a.dim() != 3:
        raise ValueError(f"linear_scan: a [B, S, D] expected, got "
                         f"{tuple(a.shape)}")
    B, S, D = a.shape
    if (b.shape != a.shape or (h0 is not None and h0.shape != (B, D))
            or any(t.device != a.device for t in ts)):
        raise ValueError("linear_scan: a, b [B, S, D] and h0 [B, D] on one "
                         "device expected")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("linear_scan: expects contiguous tensors")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h

    def work():
        return linear_scan_work(B, S, D, h0 is not None)
    if fake:
        kernels.launched(("linear_scan",), a.device, work, real=False)
        return h
    lib = _build.library("linear_scan")
    _build.check(lib.linear_scan_f32(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), B, S, D,
        torch.cuda.current_stream(a.device).cuda_stream), "linear_scan")
    kernels.launched(("linear_scan",), a.device, work)
    return h


def linear_scan_work(B: int, S: int, D: int,
                     h0: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one launch, as its bound counts them: a
    multiply and an add an element; a and b read once, h written once,
    h0 read once where given (float32)."""
    return 2 * B * S * D, 4 * (3 * B * S * D + (B * D if h0 else 0))
