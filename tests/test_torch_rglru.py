"""The port's RG-LRU recurrent block vs the reference's (CPU).

Inputs are made with numpy from a seed; the reference's block params
come from ``repro.models.init_params`` and are carried across as CPU
tensors, with the conv taps and bias (zeros at init, which would make
the block's conv output 0) drawn from the seed for both.  Every function
of ``models/rglru.py`` is held to the reference's in float32 within
1e-5 of the output's scale: the conv, the gates, the linear scan (the
port's Hillis-Steele passes against ``jax.lax.associative_scan``, with
and without ``h0``, also at S = 4096, the LM phase's prompt length),
``apply_rglru`` (plain, continued from ``conv0`` and ``h0``, with its
returned state) and ``rglru_decode_step``.  This file imports nothing of
``repro.core`` or ``repro.kernels`` (they turn on jax's x64 mode).
"""

import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as ref_init
from repro.models import rglru as RR
from repro.models.params import LeafSpec as RefLeafSpec
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models import rglru as TR
from repro_torch.models.params import is_leaf_spec, tree_leaves

TOL = 1e-5


def rs(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(a)


def randn(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    """Within ``tol`` of the reference output's scale."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= bound, (err, bound)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def setup(salt, S):
    """(cfg, reference params, the same as tensors, x [2,S,d]) of the
    recurrentgemma smoke config's RG-LRU block, with seeded conv taps."""
    cfg = f32(get_config("recurrentgemma-9b", smoke=True))
    rp = ref_init(RR.rglru_spec(cfg), jax.random.PRNGKey(0))
    r = rs("rglru", salt)
    for k in ("conv_w", "conv_b"):
        rp[k] = J(randn(r, *np.asarray(rp[k]).shape, scale=0.5))
    tp = jax.tree.map(lambda a: T(np.asarray(a)), rp)
    return cfg, rp, tp, randn(r, 2, S, cfg.d_model)


def test_rglru_spec_is_the_references():
    cfg = get_config("recurrentgemma-9b")
    ref = jax.tree.leaves(RR.rglru_spec(cfg),
                          is_leaf=lambda x: isinstance(x, RefLeafSpec))
    got = tree_leaves(TR.rglru_spec(cfg), is_leaf_spec)
    # every field the reference defines (the port's ``cast`` marks its
    # 16-bit store: the gates' ``w_a``/``w_i`` run in float32, unmarked)
    fields = [f.name for f in dataclasses.fields(RefLeafSpec)]
    assert [tuple(getattr(s, f) for f in fields) for s in got] == \
        [tuple(getattr(s, f) for f in fields) for s in ref]
    spec = TR.rglru_spec(cfg)
    assert not spec["w_a"]["w"].cast and not spec["w_i"]["w"].cast
    assert spec["in_x"]["w"].cast and spec["out"]["w"].cast


def test_rglru_a_init_is_in_the_references_range():
    """``lam`` stores log(u / (1 - u)) with u = sigmoid(lam) uniform in
    [0.9, 0.999], as the reference draws it; seeded and spread."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    spec = {"lam": TR.rglru_spec(cfg)["lam"]}
    lam = init_params(spec, 5, device="cpu")["lam"]
    assert lam.dtype == torch.float32 and tuple(lam.shape) == (cfg.d_model,)
    a = torch.sigmoid(lam)
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    assert float(a.max() - a.min()) > 0.05
    assert torch.equal(lam, init_params(spec, 5, device="cpu")["lam"])
    ref = np.asarray(ref_init({"lam": RR.rglru_spec(cfg)["lam"]},
                              jax.random.PRNGKey(0))["lam"])
    lo, hi = math.log(0.9 / 0.1), math.log(0.999 / 0.001)
    for x in (lam.numpy(), ref):
        assert lo - 1e-4 <= x.min() and x.max() <= hi + 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_depthwise_conv(S, dtype):
    """Float32 taps on a bfloat16 input promote to float32 in both."""
    r = rs("conv", S, dtype)
    jdt = jnp.dtype(dtype)
    u = J(randn(r, 2, S, 8)).astype(jdt)
    w, b = randn(r, 4, 8), randn(r, 8)
    got = TR._causal_depthwise_conv(
        T(np.asarray(u.astype(jnp.float32))).to(getattr(torch, dtype)),
        T(w), T(b))
    want = RR._causal_depthwise_conv(u, J(w), J(b))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    close(got, want)


def test_gates():
    cfg, rp, tp, _ = setup("gates", 1)
    u = randn(rs("gates-u"), 2, 9, cfg.d_model, scale=2.0)
    for g, w in zip(TR._gates(tp, T(u)), RR._gates(rp, J(u))):
        close(g, w)


def test_softplus_equals_jaxs_over_the_init_range():
    """torch returns x above its threshold of 20, jax logaddexp(x, 0):
    over the init's [2.2, 6.9] (and on to 30) they agree in float32."""
    x = np.linspace(-5.0, 30.0, 701).astype(np.float32)
    close(torch.nn.functional.softplus(T(x)), jax.nn.softplus(J(x)), 1e-7)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan(S, with_h0):
    r = rs("scan", S, with_h0)
    a = r.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = randn(r, 2, S, 16)
    h0 = randn(r, 2, 16) if with_h0 else None
    got = TR._linear_scan(T(a), T(b), None if h0 is None else T(h0))
    want = RR._linear_scan(J(a), J(b), None if h0 is None else J(h0))
    close(got, want)


def test_linear_scan_at_the_lm_phase_length():
    """S = 4096 (the LM phase's prompt) with decays near 1, so the state
    carries across the whole prompt: the port's 12 passes against the
    reference's associative scan and against the recurrence itself,
    stepped in float64."""
    r = rs("scan-long")
    a = r.uniform(0.99, 1.0, (1, 4096, 8)).astype(np.float32)
    b = randn(r, 1, 4096, 8, scale=0.1)
    h0 = randn(r, 1, 8)
    got = TR._linear_scan(T(a), T(b), T(h0))
    close(got, RR._linear_scan(J(a), J(b), J(h0)))
    h = h0.astype(np.float64)
    want = np.empty(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    close(got, want.astype(np.float32))


@pytest.mark.parametrize("S", [1, 5, 40])
@pytest.mark.parametrize("return_state", [False, True])
def test_apply_rglru(S, return_state):
    cfg, rp, tp, x = setup(("seq", S), S)
    got = TR.apply_rglru(tp, T(x), cfg, return_state=return_state)
    want = RR.apply_rglru(rp, J(x), cfg, return_state=return_state)
    if not return_state:
        close(got, want)
        return
    close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        close(g, w)


def test_apply_rglru_continued_from_state():
    """A prefill continued from the first part's (h, conv) state equals
    the reference continued the same way."""
    cfg, rp, tp, x = setup("cont", 30)
    _, (h_ref, conv_ref) = RR.apply_rglru(rp, J(x[:, :18]), cfg,
                                          return_state=True)
    got = TR.apply_rglru(tp, T(x[:, 18:]), cfg, h0=T(h_ref),
                         conv0=T(conv_ref), return_state=True)
    want = RR.apply_rglru(rp, J(x[:, 18:]), cfg, h0=h_ref, conv0=conv_ref,
                          return_state=True)
    close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        close(g, w)


def test_rglru_decode_step():
    cfg, rp, tp, x = setup("step", 1)
    r = rs("step-state")
    W = cfg.rglru_conv_width
    h, conv = randn(r, 2, cfg.d_model), randn(r, 2, W - 1, cfg.d_model)
    got = TR.rglru_decode_step(tp, T(x), cfg, (T(h), T(conv)))
    want = RR.rglru_decode_step(rp, J(x), cfg, (J(h), J(conv)))
    close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        close(g, w)


def test_decode_steps_continue_the_sequence_form():
    """Steps from the sequence form's returned state give the sequence
    form's outputs over the longer input (the port against itself)."""
    cfg, _, tp, x = setup("steps", 12)
    y_all = TR.apply_rglru(tp, T(x), cfg)
    _, state = TR.apply_rglru(tp, T(x[:, :9]), cfg, return_state=True)
    for t in range(9, 12):
        y, state = TR.rglru_decode_step(tp, T(x[:, t:t + 1]), cfg, state)
        close(y[:, 0], y_all[:, t].numpy())
