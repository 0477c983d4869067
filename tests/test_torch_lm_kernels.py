"""The port's LM kernels' plain versions vs the reference Pallas kernels
(CPU, interpret mode).

``flash_attention_plain`` is held against the reference
``flash_attention(..., interpret=True)`` over the reference's own sweep
(``tests/test_kernels.py``: causal, windowed, non-causal; float32 at
1e-5 and bfloat16 at 2e-2 absolute), and ``fused_attention`` against
``chunked_attention`` where the Pallas kernel cannot go: lengths that no
block divides and ``Sq != Skv``.  ``ssd_intra_plain`` is held against
``ssd_intra(..., interpret=True)`` and ``ssd_chunked`` against the
reference's ``ssd_chunked(force_pallas=True, interpret=True)``, at 1e-4
(the reference's SSD tolerance: sums over Q and N reassociated).  Inputs
come from numpy.  The CUDA kernels are held against these plain versions
on a card (``test_torch_cuda.py``).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.ssd.ops import ssd_chunked as ref_ssd_chunked
from repro.kernels.ssd.ssd import ssd_intra as ref_ssd_intra
from repro.models.layers import chunked_attention as ref_chunked
from repro_torch import kernels
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import fused_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_intra_ref
from repro_torch.kernels.ssd.ssd import ssd_intra, ssd_intra_plain

BF16 = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
        "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def rs(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def both(a, jdt, tdt):
    """One numpy array as a jax array and a torch tensor of one dtype
    (bf16 rounding happens once, in jax, and carries over exactly)."""
    j = jnp.asarray(a, jdt)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt)


def qkv(salt, B, Sq, Skv, Hq, Hkv, hd, dtype="float32"):
    _, jdt, tdt, tol = BF16[dtype]
    r = rs(*salt)
    out = [both(r.randn(B, S, H, hd), jdt, tdt)
           for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]
    return [j for j, _ in out], [t for _, t in out], tol


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=0)


# -- flash attention -----------------------------------------------------------


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (1, 128, 2, 2, 32), (2, 128, 4, 2, 32), (1, 256, 8, 1, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(B, S, Hq, Hkv, hd, dtype):
    (jq, jk, jv), (q, k, v), tol = qkv(("sweep", B, S, Hq, dtype),
                                       B, S, S, Hq, Hkv, hd, dtype)
    want = ref_flash(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    before = dict(kernels.LAUNCHES)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype
    assert kernels.LAUNCHES == before  # a CPU tensor launches nothing
    close(got, want, tol)
    close(attention_ref(q, k, v, causal=True),
          ref_attention(jq, jk, jv, causal=True), tol)


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_windowed(window):
    (jq, jk, jv), (q, k, v), tol = qkv(("win", window), 1, 256, 256, 2, 2,
                                       32)
    want = ref_flash(jq, jk, jv, causal=True, window=window, bq=64, bk=64,
                     interpret=True)
    close(flash_attention_plain(q, k, v, causal=True, window=window), want,
          tol)


def test_flash_attention_noncausal():
    (jq, jk, jv), (q, k, v), tol = qkv(("nc",), 2, 128, 128, 2, 2, 32)
    want = ref_flash(jq, jk, jv, causal=False, bq=64, bk=64, interpret=True)
    close(flash_attention_plain(q, k, v, causal=False), want, tol)


def test_flash_attention_offset_zero_is_the_pallas_semantics():
    """With Sq < Skv the Pallas kernel places query i at position i (no
    offset); ``offset=0`` reproduces that, the default places the
    queries at the end of the kv range like ``chunked_attention``."""
    (jq, jk, jv), (q, k, v), tol = qkv(("off0",), 1, 64, 128, 4, 2, 16)
    want = ref_flash(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    close(flash_attention_plain(q, k, v, causal=True, offset=0), want, tol)
    close(flash_attention_plain(q, k, v, causal=True),
          ref_chunked(jq, jk, jv, causal=True, q_chunk=32, kv_chunk=32),
          tol)


@pytest.mark.parametrize("Sq,Skv", [(33, 33), (77, 77), (1, 50), (20, 91)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 13),
                                           (False, 0), (False, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_is_chunked_attention(Sq, Skv, causal, window,
                                              dtype):
    """Any lengths, any offset: what the reference model's chunked branch
    computes."""
    (jq, jk, jv), (q, k, v), tol = qkv(("fused", Sq, Skv, causal, window,
                                        dtype), 2, Sq, Skv, 6, 2, 16, dtype)
    impl = "triangular" if causal else "masked"
    want = ref_chunked(jq, jk, jv, causal=causal, window=window, q_chunk=16,
                       kv_chunk=16, impl=impl)
    close(fused_attention(q, k, v, causal=causal, window=window), want, tol)


# -- ssd -------------------------------------------------------------------------


def ssd_inputs(salt, b, nc, Q, nh, hp, N, decay=0.1):
    r = rs(*salt)
    dlog = -np.abs(r.randn(b, nc, Q, nh)) * decay
    arrs = [np.cumsum(dlog, axis=2), r.randn(b, nc, Q, nh, hp),
            r.randn(b, nc, Q, N), r.randn(b, nc, Q, N)]
    arrs = [a.astype(np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("b,nc,Q,nh,hp,N", [
    (1, 2, 32, 2, 16, 8), (2, 3, 64, 4, 32, 16), (1, 1, 70, 3, 12, 20),
])
def test_ssd_intra_sweep(b, nc, Q, nh, hp, N):
    J, T = ssd_inputs(("intra", b, Q), b, nc, Q, nh, hp, N)
    yr, sr = ref_ssd_intra(*J, interpret=True)
    before = dict(kernels.LAUNCHES)
    y, st = ssd_intra(*T)
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-4)
    yo, so = ssd_intra_ref(*T)
    np.testing.assert_allclose(yo.numpy(), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(so.numpy(), np.asarray(sr), atol=1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    b, nc, Q, nh, hp, N = 1, 4, 16, 2, 8, 4
    J, T = ssd_inputs(("chunked", with_h0), b, nc, Q, nh, hp, N, 0.2)
    h0 = rs("h0").randn(b, nh, hp, N).astype(np.float32) if with_h0 \
        else None
    yr, hr = ref_ssd_chunked(*J, None if h0 is None else jnp.asarray(h0),
                             force_pallas=True, interpret=True)
    y, h = ssd_chunked(*T, None if h0 is None else torch.tensor(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-4)


def test_ssd_plain_is_the_oracle_at_chunk_256():
    """mamba2's chunk length: the plain version against the materialized
    oracle (the Pallas kernel in interpret mode is too slow here)."""
    _, T = ssd_inputs(("q256",), 1, 2, 256, 3, 8, 16, 0.02)
    y, st = ssd_intra_plain(*T)
    yo, so = ssd_intra_ref(*T)
    scale = float(yo.abs().max())
    assert float((y - yo).abs().max()) <= 1e-4 * max(1.0, scale)
    assert float((st - so).abs().max()) <= 1e-4 * max(1.0, float(
        so.abs().max()))


def test_wrappers_never_take_the_plain_path_for_cuda():
    """A CUDA tensor must reach the kernel or raise: the wrappers catch
    nothing and fall back to nothing."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for name in ("flash_attention/flash_attention.py", "ssd/ssd.py"):
        src = (root / "kernels" / name).read_text()
        assert "try:" not in src and "except" not in src
