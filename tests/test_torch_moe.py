"""The port's MoE layer (``repro_torch.models.moe``) vs the reference's
single-device path (CPU).

Inputs are made with numpy from a seed; the reference's params come from
``repro.models.init_params`` and are carried across as CPU tensors, so
both packages compute from the same weights.  ``apply_moe`` is held to
the reference's ``apply_moe`` with no mesh (its ``_moe_gspmd``) on the
moonshot and dbrx smoke configurations: y at 1e-5 in float32 and at
``3e-2 * max(1, scale)`` in bfloat16, the aux loss at 1e-6; at capacity
factors 4.0 (no pair can drop), 1.0 and 0.5 (pairs drop), with the
number of dropped pairs counted again in numpy from the same router
product.  This file imports nothing of ``repro.core`` or
``repro.kernels`` (they turn on jax's x64 mode).
"""

import dataclasses
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as RMOE
from repro.models.params import LeafSpec as RefLeafSpec
from repro.models.params import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.models import moe as TMOE
from repro_torch.models.params import is_leaf_spec, tree_leaves

ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]


def rs(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def ref_fields(s):
    """A spec leaf's fields as the reference defines them."""
    return tuple(getattr(s, f.name) for f in dataclasses.fields(RefLeafSpec))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_moe_spec_matches_reference(arch, smoke):
    cfg = get_config(arch, smoke)
    ref = jax.tree.leaves(RMOE.moe_spec(ref_config(arch, smoke)),
                          is_leaf=lambda x: isinstance(x, RefLeafSpec))
    got = tree_leaves(TMOE.moe_spec(cfg), is_leaf_spec)
    assert [ref_fields(s) for s in got] == [ref_fields(s) for s in ref]
    # the experts are read through a cast to the compute type, the
    # router in float32
    spec = TMOE.moe_spec(cfg)
    assert not spec["router"]["w"].cast
    assert all(spec[k].cast for k in ("gate", "up", "down"))


def test_capacity_matches_reference():
    for T, k, E, cf in itertools.product(
            (1, 2, 7, 74, 4096, 4098), (1, 2, 4, 6), (4, 16, 64),
            (0.5, 1.0, 1.25, 4.0, 64 / 6)):
        cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", True),
                                  top_k=k, n_experts=E, capacity_factor=cf)
        ref = dataclasses.replace(ref_config("moonshot-v1-16b-a3b", True),
                                  top_k=k, n_experts=E, capacity_factor=cf)
        assert TMOE.capacity(cfg, T) == RMOE.capacity(ref, T), (T, k, E, cf)


def numpy_dropped(x, w_router, cfg) -> int:
    """Pairs past their expert's capacity, from the router product in
    numpy: expert e keeps its first C pairs of the stable sort, so it
    drops max(0, n_e - C)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).astype(np.float32) @ w_router
    top_e = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    n_e = np.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(n_e - TMOE.capacity(cfg, T), 0).sum())


def moe_case(arch, dtype, cf, S=64):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              capacity_factor=cf)
    rp = ref_init(RMOE.moe_spec(cfg), jax.random.PRNGKey(
        zlib.crc32(arch.encode()) % 1000))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), rp)
    # T = 128 tokens: at 1.0 the capacity is the mean load (64 pairs)
    x = rs("moe", arch, cf).randn(2, S, cfg.d_model).astype(np.float32)
    return cfg, rp, tp, x


@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype, cf):
    """y and aux on the same weights; at 1.0 and 0.5 pairs drop, and the
    count the port keeps on the device equals numpy's."""
    cfg, rp, tp, x = moe_case(arch, dtype, cf)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    want_y, want_aux = RMOE.apply_moe(rp, jnp.asarray(x).astype(jdt), cfg)
    TMOE.reset_dropped()
    y, aux = TMOE.apply_moe(tp, torch.tensor(x).to(tdt), cfg)
    dropped = TMOE.dropped_pairs()
    want_y = np.asarray(want_y, np.float32)
    assert y.dtype == tdt and y.shape == x.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    tol = 1e-5 if dtype == "float32" else 3e-2 * max(
        1.0, float(np.abs(want_y).max()))
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=tol, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=0)
    # the router product in numpy from the same (rounded) input
    xin = torch.tensor(x).to(tdt).float().numpy()
    assert dropped == numpy_dropped(xin, np.asarray(rp["router"]["w"]),
                                    cfg)
    assert (dropped > 0) == (cf < 4.0), dropped


def test_dropped_pairs_accumulate_and_reset():
    cfg, _, tp, x = moe_case("moonshot-v1-16b-a3b", "float32", 0.5)
    TMOE.reset_dropped()
    TMOE.apply_moe(tp, torch.tensor(x), cfg)
    once = TMOE.dropped_pairs()
    TMOE.apply_moe(tp, torch.tensor(x), cfg)
    assert once > 0 and TMOE.dropped_pairs() == 2 * once
    TMOE.reset_dropped()
    assert TMOE.dropped_pairs() == 0


@pytest.mark.parametrize("model", [2, 4])
def test_apply_moe_expert_parallel_equals_global_form(model):
    """The expert-parallel form (once a stub naming A11.5) over a mesh of
    ``model`` expert shards (``[cpu] * 8``) equals the global form where
    no pair can drop (capacity factor 4.0): y within 1e-5, aux within
    1e-6."""
    from repro_torch.distributed.sharding import activation_hints
    from repro_torch.launch.mesh import make_host_mesh
    cfg, _, tp, x = moe_case("dbrx-132b", "float32", 4.0)
    mesh = make_host_mesh((8 // model, model), devices=["cpu"] * 8)
    hints = activation_hints(cfg, mesh, x.shape[0], "train")
    assert TMOE.uses_ep(cfg, hints)
    y0, a0 = TMOE.apply_moe(tp, torch.tensor(x), cfg)
    TMOE.reset_dropped()
    y1, a1 = TMOE.apply_moe(tp, torch.tensor(x), cfg, hints)
    assert TMOE.dropped_pairs() == 0
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=0)
    assert abs(float(a1) - float(a0)) < 1e-6
