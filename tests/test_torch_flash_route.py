"""The attention wrapper's choice of kernel, and what the tensor-core
route's rounding costs (CPU).

``flash_attention`` launches one of two CUDA kernels for a CUDA tensor:
``"wgmma"`` (``csrc/flash_attention_tc.cu``, bfloat16/float16 at head dim
64 or 128) or ``"simt"`` (``csrc/flash_attention.cu``, everything else
it takes).  ``_route`` is that choice as a pure function; it is checked
here over dtype x head dim x group.  A CPU tensor runs the plain version
and launches nothing.

The tensor-core route rounds each tile's probabilities P to the inputs'
16-bit type before P V, as any tensor-core flash attention does.  The
last test writes that rounding into a tile loop of its own (no knob on
the port) and holds it against ``flash_attention_plain`` at yi-6b's head
dim and prompt length with a reduced head count, within the tolerances
the card's tests use (``tests/test_torch_cuda.py::FLASH_TOL``): any
design that rounds P this way can meet them.  The plain version is held
against the reference Pallas kernel by ``test_torch_lm_kernels.py``; the
kernels are held against the plain version on a card.
"""

import math
import zlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.flash_attention import (
    WGMMA_HEAD_DIMS, _route, flash_attention, flash_attention_plain,
    launch_route)

HALF = (torch.bfloat16, torch.float16)
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}


def inputs(salt, dtype, B, Sq, Skv, Hq, Hkv, hd):
    r = np.random.RandomState(zlib.crc32(repr(salt).encode()))
    return [torch.from_numpy(r.randn(B, S, H, hd).astype(np.float32))
            .to(dtype) for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_route_by_dtype_head_dim_and_group(dtype, hd, G):
    want = "wgmma" if dtype in HALF and hd in WGMMA_HEAD_DIMS else "simt"
    assert _route(dtype, hd, 4 * G, 4) == want


@pytest.mark.parametrize("hd", [132, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_route_rejects_head_dims_past_128(dtype, hd):
    with pytest.raises(ValueError):
        _route(dtype, hd, 8, 2)


def test_route_rejects_other_dtypes_and_groups():
    with pytest.raises(TypeError):
        _route(torch.float64, 64, 8, 2)
    with pytest.raises(ValueError):  # heads not a multiple of kv heads
        _route(torch.bfloat16, 64, 6, 4)
    with pytest.raises(ValueError):  # a group of more than 64
        _route(torch.bfloat16, 64, 65, 1)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_cpu_tensors_run_the_plain_version(dtype, hd):
    q, k, v = inputs(("cpu", hd), dtype, 2, 70, 90, 8, 2, hd)
    before = dict(kernels.LAUNCHES)
    got = flash_attention(q, k, v, causal=True, window=40)
    assert kernels.LAUNCHES == before  # a CPU tensor launches nothing
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True,
                                                  window=40))


@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_launch_route_never_runs_a_cpu_tensor(route):
    """Naming a route is for CUDA tensors only: no silent plain run."""
    q, k, v = inputs(("route",), torch.bfloat16, 1, 8, 8, 2, 1, 64)
    with pytest.raises(ValueError):
        launch_route(route, q, k, v)


def p_rounded(q, k, v, *, causal, window, bn=128):
    """The tensor-core route's arithmetic in PyTorch: 128-key tiles, a
    float32 online softmax, P rounded to q's dtype before P V."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, hd).float()
    qi = (torch.arange(Sq) + Skv - Sq)[:, None]
    m = torch.full((B, Hkv, G, Sq), -math.inf)
    l = torch.zeros((B, Hkv, G, Sq))
    acc = torch.zeros((B, Hkv, G, Sq, hd))
    for k0 in range(0, Skv, bn):
        kc, vc = k[:, k0:k0 + bn].float(), v[:, k0:k0 + bn].float()
        ki = torch.arange(k0, k0 + kc.shape[1])[None, :]
        ok = torch.ones((Sq, kc.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qi >= ki
        if window > 0:
            ok &= qi - ki < window
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5, kc) / math.sqrt(hd)
        s = torch.where(ok, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype).float(), vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_p_rounding_stays_within_the_card_tolerance(dtype, causal, window):
    """yi-6b's head dim and S = 2048 (as its prefill), one kv head of
    four query heads: P rounded to 16 bits stays within FLASH_TOL."""
    q, k, v = inputs(("pround", causal, window), dtype, 1, 2048, 2048, 4, 1,
                     128)
    got = p_rounded(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err
