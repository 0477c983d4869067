"""The RG-LRU linear scan's kernel model and wrapper, held against the
reference (CPU).

``csrc/linear_scan.cu`` walks each group of 32 channels through tiles of
``SCAN_WARPS`` segments of ``SCAN_SEG`` rows: every segment scanned from
0, the segments' (decay, state) pairs composed across the tile onto the
carry, every segment rerun from the state entering it.
``scan.linear_scan_staged`` mirrors that order of work; here it and the
plain version (``linear_scan_plain``, the Hillis-Steele passes the CPU
runs) are held against the reference's ``jax.lax.associative_scan``
(``repro.models.rglru._linear_scan``) and against the recurrence stepped
in float64, at lengths around the tile and at the LM phase's 4096, with
and without ``h0``, over a width that is no whole number of channel
groups, within ``TOL`` (1e-5 of max(1, max|h|), as
``test_torch_rglru.py``: both sides sum the same terms in another order
in float32; the staged model and the plain passes read ~4e-7 at S = 4096
with decays near 1).  The wrapper's dispatch: a CPU tensor runs the plain
version bit for bit, a ``meta`` tensor outside a fake mode raises, and a
fake tensor meets the launch's checks.  The kernel itself is held against
the plain version on a card (``test_torch_cuda.py``).
"""

import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import rglru as RR
from repro_torch import kernels
from repro_torch.kernels.rglru_scan import scan
from repro_torch.kernels.rglru_scan.scan import (SCAN_CH, SCAN_SEG,
                                                 SCAN_WARPS, linear_scan,
                                                 linear_scan_plain,
                                                 linear_scan_staged)
from test_torch_cuda import scan_reference as recurrence

CU = Path(scan.__file__).resolve().parents[1] / "csrc" / "linear_scan.cu"
TOL = 1e-5
TILE = SCAN_WARPS * SCAN_SEG
D = 40  # a group of 32 channels and a ragged 8


def rs(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def inputs(S, with_h0, lo=0.9, width=D):
    """Decays from U(lo, 1) (the card's 0.9: the state carries across the
    prompt), inputs and h0 from N(0, 1)."""
    r = rs("lscan", S, with_h0, lo, width)
    a = r.uniform(lo, 1.0, (2, S, width)).astype(np.float32)
    b = r.randn(2, S, width).astype(np.float32)
    h0 = r.randn(2, width).astype(np.float32) if with_h0 else None
    return a, b, h0


def close(got, want):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    bound = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def T(x):
    return None if x is None else torch.tensor(x)


def test_constants_match_the_cuda_source():
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", CU.read_text(), re.M)}
    assert consts["LS_CH"] == SCAN_CH
    assert consts["LS_WARPS"] == SCAN_WARPS
    assert consts["LS_SEG"] == SCAN_SEG


@pytest.mark.parametrize("S", [1, 2, 7, TILE - 1, TILE, TILE + 1, 100,
                               2 * TILE + 1, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("form", ["staged", "plain"])
def test_scan_matches_reference(form, S, with_h0):
    a, b, h0 = inputs(S, with_h0)
    fn = linear_scan_staged if form == "staged" else linear_scan_plain
    got = fn(T(a), T(b), T(h0))
    assert got.dtype == torch.float32 and got.is_contiguous()
    close(got, RR._linear_scan(jnp.asarray(a), jnp.asarray(b),
                               None if h0 is None else jnp.asarray(h0)))
    close(got, recurrence(a, b, h0))


@pytest.mark.parametrize("width", [1, 31, 32, 33, 96])
def test_staged_channel_groups(width):
    """Widths below, at and past one group of 32 channels (the padded
    channels are masked, not computed into the result)."""
    a, b, h0 = inputs(TILE + 5, True, lo=0.5, width=width)
    close(linear_scan_staged(T(a), T(b), T(h0)), recurrence(a, b, h0))


@pytest.mark.parametrize("with_h0", [False, True])
def test_cpu_tensor_runs_the_plain_version(with_h0):
    a, b, h0 = inputs(300, with_h0)
    before = dict(kernels.LAUNCHES)
    got = linear_scan(T(a), T(b), T(h0))
    assert torch.equal(got, linear_scan_plain(T(a), T(b), T(h0)))
    assert kernels.LAUNCHES == before  # a CPU tensor launches nothing


def test_meta_tensor_outside_a_fake_mode_raises():
    x = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        linear_scan(x, x)


@pytest.mark.parametrize("case", ["float64", "shape", "h0_shape",
                                  "strided", "grad", "rank"])
def test_fake_path_checks_the_inputs(case):
    """A fake tensor takes the launch's checks: what the kernel does not
    take raises there, as on a card."""
    err = {"float64": TypeError, "grad": RuntimeError}.get(case, ValueError)
    with FakeTensorMode():
        a = torch.empty(2, 8, 4)
        b = torch.empty(2, 8, 4)
        h0 = torch.empty(2, 4)
        if case == "float64":
            a = a.double()
        elif case == "shape":
            b = torch.empty(2, 9, 4)
        elif case == "h0_shape":
            h0 = torch.empty(4, 2)
        elif case == "strided":
            a = torch.empty(2, 4, 8).transpose(1, 2)
        elif case == "grad":
            a.requires_grad_()
        else:
            a = torch.empty(16, 4)
        with pytest.raises(err):
            linear_scan(a, b, h0)
        if case == "grad":  # no gradient is tracked: the kernel may run
            with torch.no_grad():
                assert linear_scan(a, b, h0).shape == (2, 8, 4)
