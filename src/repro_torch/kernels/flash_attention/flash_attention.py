"""GQA flash attention: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/flash_attention/flash_attention.py``
``flash_attention`` (``_flash_kernel``), by two CUDA kernels that compute
one function.  ``_route`` picks one from the dtype and the head dim:

* ``"wgmma"`` (``csrc/flash_attention_tc.cu``): bfloat16 and float16 at
  head dim 64 or 128, on the tensor cores — TMA-fed 16-bit tiles, both
  products on ``wgmma``, one q-head and 128 positions per block;
* ``"simt"`` (``csrc/flash_attention.cu``): float32, and the other head
  dims, as float32 FMAs on the CUDA cores — one block per (batch,
  kv-head, q-tile) with every query head of the group in the block.

Both walk the kv tiles in a loop with an online softmax; see the
sources' headers.  A CUDA call launches its route's kernel or raises:
neither route stands in for the other.

Two differences from the Pallas kernel, both toward ``chunked_attention``
(``models/layers.py``), the function the reference model computes: the
lengths need not divide any block (ragged tails are masked, keys at or
past ``Skv`` never count), and query row ``i`` sits at absolute position
``i + offset`` with ``offset = Skv - Sq`` by default (the Pallas kernel
has no offset: ``offset=0`` is its semantics).  Masked scores are
``-inf`` with ``chunked_attention``'s ``isfinite`` guards, not the
Pallas kernel's finite ``-1e30``; the outputs agree on every row that
sees a key.
"""

from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

BK = 64  # keys per tile of the plain version

# route -> (library, {dtype: C entry point})
_ENTRY = {
    "simt": ("flash_attention", {torch.float32: "flash_attention_f32",
                                 torch.bfloat16: "flash_attention_bf16",
                                 torch.float16: "flash_attention_f16"}),
    "wgmma": ("flash_attention_tc", {torch.bfloat16: "flash_attention_tc_bf16",
                                     torch.float16: "flash_attention_tc_f16"}),
}
WGMMA_HEAD_DIMS = (64, 128)


def _route(dtype: torch.dtype, hd: int, Hq: int, Hkv: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for 16-bit inputs at a
    head dim the tensor-core kernel covers, ``"simt"`` otherwise.
    Raises for what neither kernel takes."""
    if dtype not in _ENTRY["simt"][1]:
        raise TypeError(f"flash_attention: dtype {dtype}; expects one of "
                        "float32, bfloat16, float16")
    if hd > 128 or hd % 4 or Hq % Hkv or Hq // Hkv > 64:
        raise ValueError(f"flash_attention: head_dim {hd} (<= 128, a "
                         f"multiple of 4) and {Hq}/{Hkv} heads (a group of "
                         "<= 64) expected")
    if dtype in _ENTRY["wgmma"][1] and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          offset: int | None = None) -> torch.Tensor:
    """Plain PyTorch version (any device): the kernel's tile loop over
    ``BK`` keys with an online softmax in float32, every query at once."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if offset is None:
        offset = Skv - Sq
    dev = q.device
    q5 = q.reshape(B, Sq, Hkv, G, hd).float()
    qi = (torch.arange(Sq, device=dev) + offset)[:, None]
    m = torch.full((B, Hkv, G, Sq), -math.inf, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=dev)
    for k0 in range(0, Skv, BK):
        kc = k[:, k0:k0 + BK].float()
        vc = v[:, k0:k0 + BK].float()
        ki = torch.arange(k0, k0 + kc.shape[1], device=dev)[None, :]
        ok = torch.ones((Sq, kc.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok &= qi >= ki
        if window > 0:
            ok &= qi - ki < window
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5, kc) / math.sqrt(hd)
        s = torch.where(ok, s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]   # [B,Hkv,G,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    offset: int | None = None) -> torch.Tensor:
    """q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.

    ``offset`` (default ``Skv - Sq``) is the absolute position of query
    row 0.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel ``_route`` names or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     offset=offset)
    return launch_route(_route(q.dtype, q.shape[-1], q.shape[2],
                               k.shape[2]), q, k, v, causal=causal,
                        window=window, offset=offset)


def launch_route(route: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True, window: int = 0,
                 offset: int | None = None) -> torch.Tensor:
    """Launch one route's kernel on CUDA tensors, or raise.
    ``flash_attention`` passes the route ``_route`` names; a caller that
    times the CUDA-core kernel on 16-bit inputs names ``"simt"``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib_name, entries = _ENTRY[route]
    if q.dtype not in entries or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention ({route}): dtypes {q.dtype}/"
                        f"{k.dtype}/{v.dtype}; expects one of "
                        f"{', '.join(map(str, entries))} for all three")
    if (k.device != q.device or v.device != q.device
            or k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape):
        raise ValueError("flash_attention: q [B,Sq,Hq,hd] and k, v "
                         "[B,Skv,Hkv,hd] on one device expected")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: expects contiguous tensors")
    _route(q.dtype, hd, Hq, Hkv)  # raises for what neither kernel takes
    if route == "wgmma":
        if hd not in WGMMA_HEAD_DIMS or Skv < 1:
            raise ValueError(f"flash_attention (wgmma): head_dim {hd} (one "
                             f"of {WGMMA_HEAD_DIMS}) and Skv {Skv} (>= 1) "
                             "expected")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention (wgmma): TMA needs q, k and v "
                             "16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library(lib_name)
    _build.check(getattr(lib, entries[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
        Skv - Sq if offset is None else int(offset),
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    if route == "wgmma":
        kernels.LAUNCHES["flash_attention_wgmma"] += 1
    return out
