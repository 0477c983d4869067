"""GQA flash attention: CUDA kernel wrapper and plain version.

Port of the reference ``kernels/flash_attention/flash_attention.py``
``flash_attention`` (``_flash_kernel``), by two CUDA kernels that compute
one function.  ``_route`` picks one from the dtype and the head dim:

* ``"wgmma"`` (``csrc/flash_attention_tc.cu``): bfloat16 and float16 at
  head dim 64, 96, 128 or 256, on the tensor cores — TMA-fed 16-bit
  tiles, both products on ``wgmma``, one q-head and 128 positions per
  block (at 96, phi-3-vision-4.2b's, hd 128's tiles with the columns past
  96 zero-filled by TMA; at 256, recurrentgemma-9b's local attention,
  64-key tiles and a producer warpgroup that hands its registers to the
  consumers; at 64, whisper-tiny's, a kernel of its own with 192
  positions per block, three consumer warpgroups that take turns at the
  tensor cores, and each one's P V in flight through its next softmax);
* ``"simt"`` (``csrc/flash_attention.cu``): float32 at every head dim,
  and 16-bit inputs at the other head dims up to 256, as float32 FMAs on
  the CUDA cores — one block per (batch, kv-head, q-tile) with every
  query head of the group in the block; two instantiations, for head
  dims up to 128 and up to 256.

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

import functools
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
WGMMA_HEAD_DIMS = (64, 96, 128, 256)


def _route(dtype: torch.dtype, hd: int, Hq: int, Hkv: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for 16-bit inputs at a
    head dim the tensor-core kernel covers (``WGMMA_HEAD_DIMS``: 64, 96,
    128 and 256), ``"simt"`` for float32 at any head dim up to 256 and
    for 16-bit inputs at the others (32, 132, 192, ...).  Raises for what
    neither kernel takes."""
    if dtype not in _ENTRY["simt"][1]:
        raise TypeError(f"flash_attention: dtype {dtype}; expects one of "
                        "float32, bfloat16, float16")
    if hd > 256 or hd % 4 or Hq % Hkv or Hq // Hkv > 64:
        raise ValueError(f"flash_attention: head_dim {hd} (<= 256, a "
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
    the kernel ``_route`` names or raises — also when it requires grad,
    since the kernel has no backward."""
    if q.device.type == "cpu" and not kernels.is_fake(q):
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
    fake = kernels.is_fake(q)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward and would drop "
            "the gradient; train through the training route "
            "(attention(..., train=True), which runs chunked_attention, "
            "as loss_fn does)")
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
        if not fake and any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention (wgmma): TMA needs q, k and v "
                             "16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    off = Skv - Sq if offset is None else int(offset)
    names = ("flash_attention", "flash_attention_wgmma") \
        if route == "wgmma" else ("flash_attention",)

    def work():
        return attention_work(route, B, Sq, Skv, Hq, Hkv, hd, causal,
                              window, off, q.element_size())
    if fake:
        kernels.launched(names, q.device, work, real=False)
        return out
    lib = _build.library(lib_name)
    _build.check(getattr(lib, entries[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
        off, torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention")
    kernels.launched(names, q.device, work)
    return out


# tiles of the two kernels (csrc/flash_attention_tc.cu, flash_attention.cu)
WGMMA_WG_ROWS = 64                    # query rows a warpgroup
SIMT_ROWS, SIMT_BK = 64, 32           # rows a block (G heads x 64/G), keys


def wgmma_tiles(hd: int) -> tuple[int, int]:
    """(query rows a block, keys a kv tile) of the ``wgmma`` kernel at
    head dim ``hd``: 192 and 128 at hd 64 (three warpgroups), 128 and 64
    at hd 256, 128 and 128 at 96 and 128.  Must match ``Layout64`` and
    ``Layout<HD>`` in ``csrc/flash_attention_tc.cu``."""
    if hd == 64:
        return 192, 128
    return 128, 64 if hd > 128 else 128


@functools.lru_cache(maxsize=4096)
def visited_pairs(route: str, Sq: int, Skv: int, G: int, hd: int,
                  causal: bool, window: int, offset: int) -> int:
    """(query row, key) pairs one kv head's group of ``G`` query heads
    computes on ``route``: whole tiles, as the kernel visits them.  The
    ``wgmma`` kernel loads the kv tiles of a block's band (``wgmma_tiles``)
    and each 64-row warpgroup with rows below ``Sq`` computes them: every
    one at hd 64, and elsewhere all but the tiles none of its rows sees;
    the ``simt`` kernel walks 32-key tiles over the band of a block of
    ``64 / G`` positions times the ``G`` heads."""
    def band(p_first, p_last):
        hi = min(Skv, p_last + 1) if causal else Skv
        lo = max(0, p_first - (window - 1)) if window > 0 else 0
        return lo, hi
    total = 0
    if route == "wgmma":
        bm, bn = wgmma_tiles(hd)
        for q0 in range(0, Sq, bm):
            lo, hi = band(q0 + offset, min(q0 + bm, Sq) - 1 + offset)
            if hi <= lo:
                continue
            t0, t1 = lo // bn, (hi - 1) // bn
            for w0 in range(q0, min(q0 + bm, Sq), WGMMA_WG_ROWS):
                if hd == 64:
                    total += (t1 - t0 + 1) * WGMMA_WG_ROWS * bn
                    continue
                wlo, whi = band(w0 + offset,
                                min(w0 + WGMMA_WG_ROWS, Sq) - 1 + offset)
                if whi <= wlo:
                    continue
                a, b = max(t0, wlo // bn), min(t1, (whi - 1) // bn)
                total += max(0, b - a + 1) * WGMMA_WG_ROWS * bn
        return total * G
    bq = SIMT_ROWS // G
    for q0 in range(0, Sq, bq):
        lo, hi = band(q0 + offset, min(q0 + bq, Sq) - 1 + offset)
        if hi > lo:
            total += -(-(hi - (lo // SIMT_BK) * SIMT_BK) // SIMT_BK) \
                * SIMT_ROWS * SIMT_BK
    return total


def attention_work(route: str, B: int, Sq: int, Skv: int, Hq: int,
                   Hkv: int, hd: int, causal: bool, window: int,
                   offset: int, itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one launch: the two products (QK^T, PV) over
    the visited tiles, 2 per multiply-add; q, k and v read once and the
    output written once."""
    pairs = visited_pairs(route, Sq, Skv, Hq // Hkv, hd, causal, window,
                          offset)
    return (4 * hd * pairs * B * Hkv,
            itemsize * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd))
