"""The SSD kernel's staged arithmetic, held against the plain version (CPU).

``csrc/ssd_intra.cu`` forms the gram ``C . B^T`` once per (batch, chunk),
then walks row tiles and column tiles per head, every product in split
TF32 on the tensor cores (``a = hi + lo``, three TF32 products a pair).
``ssd.ssd_intra_staged`` mirrors that order of work and the rounding;
here it is checked against the plain version and the Pallas kernel
(interpret mode) over ragged shapes, the TF32 rounding against
``cvt.rna.tf32.f32``'s rule, and the tile constants against the source.
One-pass TF32 is shown to miss the kernel's 1e-4 gate at mamba2-1.3b's
width, which is why the kernel takes three products.  The kernel itself
is held against the plain version on a card (``test_torch_cuda.py``).
"""

import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ssd import ssd_intra as pallas_ssd_intra
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ssd import (SSD_COL_TILE, SSD_GRAM_TILE,
                                         SSD_ROW_TILE, ssd_intra_plain,
                                         ssd_intra_staged, tf32)

CU = Path(ssd.__file__).resolve().parents[1] / "csrc" / "ssd_intra.cu"
# the smoke's and test_torch_cuda.py's gate: 1e-4 of max|y| and of
# max|state|.  Three TF32 products carry ~2^-21 of each product and the
# float32 sums are reassociated, so the staged model stays far inside it
# (TOL, a tenth of the gate, is what the tests below hold it to)
GATE = 1e-4
TOL = 1e-5


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def inputs(salt, b, nc, Q, nh, hp, N, decay=0.05):
    r = rng(*salt)
    dlog = -np.abs(r.randn(b, nc, Q, nh)) * decay
    arrs = [np.cumsum(dlog, axis=2), r.randn(b, nc, Q, nh, hp),
            r.randn(b, nc, Q, N), r.randn(b, nc, Q, N)]
    return [a.astype(np.float32) for a in arrs]


def rel_err(got, want) -> float:
    """Largest |got - want| over max(1, max|want|)."""
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def test_constants_match_the_cuda_source():
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", CU.read_text(), re.M)}
    assert consts["GT"] == SSD_GRAM_TILE
    assert consts["TR"] == SSD_ROW_TILE
    assert consts["TJ"] == SSD_COL_TILE
    assert consts["HP_MAX"] == consts["N_MAX"] == 128


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0), (1 + 2 ** -10, 1 + 2 ** -10),
    (1 + 2 ** -11, 1 + 2 ** -10),           # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),         # just below the tie
    (1 + 2 ** -12, 1.0), (3 * 2 ** -11 + 1, 1 + 2 ** -9),
    (0.0, 0.0), (-3.0, -3.0),
])
def test_tf32_rounds_nearest_ties_away(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == np.float32(want)


def test_tf32_split_is_exact_to_2_pow_minus_22():
    x = torch.tensor(rng("split").randn(10000).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2 ** -21


# ragged shapes: Q not a multiple of the row or column tile, hp and N from
# 8 to 128 and not multiples of 8, nh odd
SHAPES = [(1, 2, 32, 2, 16, 8), (2, 3, 64, 4, 32, 16), (1, 1, 70, 3, 12, 20),
          (1, 1, 100, 3, 8, 128), (1, 2, 129, 1, 128, 64),
          (2, 1, 97, 5, 33, 7), (1, 1, 256, 2, 64, 128)]


@pytest.mark.parametrize("b,nc,Q,nh,hp,N", SHAPES)
def test_staged_equals_plain(b, nc, Q, nh, hp, N):
    T = [torch.tensor(a) for a in inputs(("plain", Q, hp, N), b, nc, Q, nh,
                                         hp, N)]
    y, st = ssd_intra_staged(*T)
    yp, sp = ssd_intra_plain(*T)
    assert y.shape == yp.shape and st.shape == sp.shape
    assert rel_err(y, yp) <= TOL and rel_err(st, sp) <= TOL


@pytest.mark.parametrize("b,nc,Q,nh,hp,N", [
    (1, 2, 32, 2, 16, 8), (1, 1, 70, 3, 12, 20), (1, 1, 100, 3, 8, 24)])
def test_staged_equals_pallas(b, nc, Q, nh, hp, N):
    arrs = inputs(("pallas", Q, hp, N), b, nc, Q, nh, hp, N)
    y, st = ssd_intra_staged(*[torch.tensor(a) for a in arrs])
    yr, sr = pallas_ssd_intra(*[jnp.asarray(a) for a in arrs],
                              interpret=True)
    yr, sr = torch.tensor(np.asarray(yr)), torch.tensor(np.asarray(sr))
    assert rel_err(y, yr) <= TOL and rel_err(st, sr) <= TOL


def test_decay_over_hundreds_stays_finite():
    """cum falling by hundreds over a chunk, as in real Mamba-2: the decay
    is formed as exp(cum_i - cum_j), never as a product that overflows."""
    arrs = inputs(("steep",), 1, 1, 128, 2, 16, 16, decay=4.0)
    assert arrs[0].min() < -300
    T = [torch.tensor(a) for a in arrs]
    y, st = ssd_intra_staged(*T)
    yp, sp = ssd_intra_plain(*T)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert rel_err(y, yp) <= TOL and rel_err(st, sp) <= TOL


def test_one_pass_tf32_misses_the_gate_at_mamba2_width():
    """mamba2-1.3b's widths (Q = 256, hp = 64, N = 128): one TF32 product a
    pair misses the 1e-4 gate, three stay inside it."""
    T = [torch.tensor(a) for a in inputs(("mamba2",), 1, 1, 256, 2, 64,
                                         128)]
    yp, sp = ssd_intra_plain(*T)
    y1, s1 = ssd_intra_staged(*T, one_pass=True)
    y3, s3 = ssd_intra_staged(*T)
    assert max(rel_err(y1, yp), rel_err(s1, sp)) > GATE
    assert max(rel_err(y3, yp), rel_err(s3, sp)) <= TOL
