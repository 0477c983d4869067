"""The attention wrapper's choice of kernel, and what the tensor-core
route's rounding costs (CPU).

``flash_attention`` launches one of two CUDA kernels for a CUDA tensor:
``"wgmma"`` (``csrc/flash_attention_tc.cu``, bfloat16/float16 at head dim
64, 96, 128 or 256) or ``"simt"`` (``csrc/flash_attention.cu``,
everything else it takes: float32 at head dims up to 256 and 16-bit
inputs at the other head dims up to 256, multiples of 4).  ``_route`` is
that choice as a pure function; it is checked here over dtype x head dim
x group.  A CPU tensor runs the plain version and launches nothing.

The tensor-core route rounds each tile's probabilities P to the inputs'
16-bit type before P V, as any tensor-core flash attention does.  The
last tests write that rounding into a tile loop of their own (no knob on
the port) and hold it against ``flash_attention_plain`` at yi-6b's head
dim and prompt length, at phi-3-vision-4.2b's head dim 96, at
whisper-tiny's head dim 64 and heads, and at recurrentgemma-9b's head
dim and window with its 64-key tiles, with reduced head counts, within
the tolerances
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
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_route_by_dtype_head_dim_and_group(dtype, hd, G):
    want = "wgmma" if dtype in HALF and hd in WGMMA_HEAD_DIMS else "simt"
    assert _route(dtype, hd, 4 * G, 4) == want


@pytest.mark.parametrize("hd", [132, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_route_takes_head_dims_past_128(dtype, hd):
    """Past 128 the CUDA-core kernel's second instantiation takes every
    head dim up to 256; the tensor-core kernel takes 256 in 16 bits
    (recurrentgemma-9b's 16/1 heads), with groups up to 16 over one kv
    head.  132 and 192 stay on ``"simt"`` in every dtype."""
    want = "wgmma" if dtype in HALF and hd == 256 else "simt"
    assert _route(dtype, hd, 8, 2) == want
    assert _route(dtype, hd, 16, 1) == want


@pytest.mark.parametrize("hd", [258, 260, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF], ids=str)
def test_route_rejects_head_dims_past_256(dtype, hd):
    """Past 256, or not a multiple of 4 (258), neither kernel takes it."""
    with pytest.raises(ValueError, match="<= 256"):
        _route(dtype, hd, 8, 2)


@pytest.mark.parametrize("hd", [130, 254])
def test_route_rejects_head_dims_not_a_multiple_of_4(hd):
    with pytest.raises(ValueError, match="multiple of 4"):
        _route(torch.float32, hd, 8, 2)


def test_route_rejects_other_dtypes_and_groups():
    with pytest.raises(TypeError):
        _route(torch.float64, 64, 8, 2)
    with pytest.raises(ValueError):  # heads not a multiple of kv heads
        _route(torch.bfloat16, 64, 6, 4)
    with pytest.raises(ValueError):  # a group of more than 64
        _route(torch.bfloat16, 64, 65, 1)


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
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
    """The tensor-core route's arithmetic in PyTorch: ``bn``-key tiles
    (128 at hd 64, 96 and 128, 64 at hd 256), a float32 online softmax, P
    rounded to q's dtype before P V."""
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


# (salt, Hq, Hkv, hd): yi-6b's head dim with one kv head of four query
# heads, phi-3-vision-4.2b's head dim 96 in its head layout (a group of
# 1) with two heads, and whisper-tiny's head dim 64 with its 6/6 heads
P_ROUND_HEADS = {"": ("pround", 4, 1, 128), "-hd96": ("pround96", 2, 2, 96),
                 "-hd64": ("pround64", 6, 6, 64)}


@pytest.mark.parametrize("causal,window,heads", [
    pytest.param(c, w, h, id=f"{c}-{w}{h}") for h in P_ROUND_HEADS
    for c, w in [(True, 0), (True, 300), (False, 0)]])
@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_p_rounding_stays_within_the_card_tolerance(dtype, causal, window,
                                                    heads):
    """S = 2048 (as yi's and phi-3-vision's prefill, past whisper's 1500
    frames) on the tensor-core route's 128-key tiles (its tile at hd 64,
    96 and 128), at each row of P_ROUND_HEADS: P rounded to 16 bits stays
    within FLASH_TOL."""
    salt, Hq, Hkv, hd = P_ROUND_HEADS[heads]
    q, k, v = inputs((salt, causal, window), dtype, 1, 2048, 2048, Hq, Hkv,
                     hd)
    got = p_rounded(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 2048),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_p_rounding_at_head_dim_256(dtype, causal, window):
    """recurrentgemma-9b's head dim and window on the tensor-core route's
    64-key tiles, past the window (2560 positions), two query heads over
    one kv head: P rounded to 16 bits stays within FLASH_TOL."""
    q, k, v = inputs(("pround256", causal, window), dtype, 1, 2560, 2560,
                     2, 1, 256)
    got = p_rounded(q, k, v, causal=causal, window=window, bn=64)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err
