"""The port's LM serving path vs the reference models (CPU).

Inputs are made with numpy from a seed; the reference's params come from
``repro.models.init_params`` and are carried across with
``params_from_reference``, so both packages compute from the same
weights.  Each layer the serving path runs is held to the reference's at
1e-5 in float32; every ``dense`` and ``ssm`` smoke config's ``hidden``,
``prefill_fn`` and ``decode_fn`` to 1e-4 of the output's scale in
float32, and to the reference's own decode-vs-forward bound
(``3e-2 * max(1, scale)``, ``tests/test_models.py``) in bfloat16.  On
the CPU the attention kernel's and the SSD kernel's plain versions run:
the smoke configs' 40-token prompts take ``attention()``'s chunked
branch and pad ``apply_ssd`` to whole chunks.  This file imports nothing
of ``repro.core`` or ``repro.kernels`` (they turn on jax's x64 mode).
"""

import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as ref_config
from repro.models import build_model as ref_build, init_params as ref_init
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro.models.params import LeafSpec as RefLeafSpec
from repro_torch.configs import get_config
from repro_torch.models import (BlockKind, build_model, init_params,
                                model_cache_spec, param_count)
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import is_leaf_spec, tree_leaves

SERVED = ["yi-6b", "qwen2-7b", "starcoder2-15b", "mistral-large-123b",
          "mamba2-1.3b"]
OTHER = [a for a in ARCH_NAMES if a not in SERVED]
TOL = 1e-5


def rs(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(a)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got)
                               else got,
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def ref_params(spec_fn, *args, seed=0):
    """(reference params, the same as CPU tensors) of a spec function."""
    p = ref_init(spec_fn(*args), jax.random.PRNGKey(seed))
    return p, jax.tree.map(lambda a: T(np.asarray(a)), p)


def randn(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


# -- configs and specs -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_are_the_references(arch):
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke))
                == dataclasses.asdict(ref_config(arch, smoke)))


@pytest.mark.parametrize("arch", SERVED)
def test_model_spec_matches_reference(arch):
    cfg = get_config(arch)
    ref = jax.tree.leaves(ref_build(ref_config(arch)).spec(),
                          is_leaf=lambda x: isinstance(x, RefLeafSpec))
    got = tree_leaves(build_model(cfg, device="cpu").spec(), is_leaf_spec)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in ref]
    assert param_count(build_model(cfg, device="cpu").spec()) == sum(
        math.prod(s.shape) for s in ref)


def test_cache_spec_matches_reference():
    from repro.models import model_cache_spec as ref_cache_spec
    for arch in SERVED:
        ref = jax.tree.leaves(ref_cache_spec(ref_config(arch), 2, 64),
                              is_leaf=lambda x: isinstance(x, RefLeafSpec))
        got = tree_leaves(model_cache_spec(get_config(arch), 2, 64),
                          is_leaf_spec)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in ref]


def test_init_params_is_seeded_and_follows_the_spec():
    cfg = get_config("mamba2-1.3b", smoke=True)
    spec = build_model(cfg, device="cpu").spec()
    a = init_params(spec, 3, device="cpu")
    b = init_params(spec, 3, device="cpu")
    c = init_params(spec, 4, device="cpu")
    la, lb, lc = (tree_leaves(x) for x in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"], c["embed"])
    for s, x in zip(tree_leaves(spec, is_leaf_spec), la):
        assert tuple(x.shape) == s.shape and x.dtype == torch.float32
    ssm = a["blocks"]["b0"]["ssm"]
    a_neg = torch.exp(ssm["a_log"])           # uniform[1, 16]
    assert 1.0 <= a_neg.min() and a_neg.max() <= 16.0
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6
    assert torch.equal(ssm["d_skip"], torch.ones_like(ssm["d_skip"]))
    assert torch.equal(ssm["conv_w"], torch.zeros_like(ssm["conv_w"]))
    std = float(a["embed"].std())
    assert 0.015 < std < 0.025                # normal, scale 0.02


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-6b", smoke=True)
    spec = build_model(cfg, device="cpu").spec()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(spec, 0)                  # the default device is CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference({}, cfg)


@pytest.mark.parametrize("kind", [BlockKind.MOE, BlockKind.RECURRENT,
                                  BlockKind.LOCAL_ATTN])
def test_unported_block_kinds_raise(kind):
    cfg = get_config("yi-6b", smoke=True)
    with pytest.raises(NotImplementedError, match="A11"):
        TT.block_spec(cfg, kind)
    with pytest.raises(NotImplementedError, match="A11"):
        TT.block_cache_spec(cfg, kind, 1, 8)


@pytest.mark.parametrize("arch", OTHER)
def test_unported_families_raise(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="A11"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        model_cache_spec(cfg, 1, 8)


def test_params_from_reference_checks_leaves():
    cfg = get_config("yi-6b", smoke=True)
    rp = jax.tree.map(np.asarray, ref_init(ref_build(cfg).spec(),
                                           jax.random.PRNGKey(0)))
    params_from_reference(rp, cfg, "cpu")
    bad = dict(rp, embed=rp["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, cfg, "cpu")
    bad = dict(rp, embed=rp["embed"].astype(np.float64))
    with pytest.raises(ValueError, match="dtype"):
        params_from_reference(bad, cfg, "cpu")
    bad = {k: v for k, v in rp.items() if k != "head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, "cpu")


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    r = rs("norm", kind)
    x = randn(r, 2, 5, 32)
    p = {"scale": randn(r, 32), "bias": randn(r, 32)}
    if kind == "rmsnorm":
        p.pop("bias")
    close(TL.apply_norm({k: T(v) for k, v in p.items()}, T(x), kind),
          RL.apply_norm({k: J(v) for k, v in p.items()}, J(x), kind))


def test_rope():
    r = rs("rope")
    x = randn(r, 2, 12, 3, 16)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    close(TL.rope(T(x), T(pos), 5e6), RL.rope(J(x), J(pos), 5e6))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-7b", "starcoder2-15b"])
def test_project_qkv(arch):
    cfg = f32(get_config(arch, smoke=True))
    rp, tp = ref_params(RL.attention_spec, cfg)
    r = rs("qkv", arch)
    x = randn(r, 2, 9, cfg.d_model)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    got = TL.project_qkv(tp, T(x), cfg, T(pos))
    want = RL.project_qkv(rp, J(x), cfg, J(pos), RL.NO_HINTS)
    for g, w in zip(got, want):
        close(g, w)


QKV = [(2, 24, 24, 4, 2, 16), (1, 20, 37, 4, 1, 8), (2, 50, 50, 2, 2, 16)]


def qkv(r, B, Sq, Skv, Hq, Hkv, hd):
    return (randn(r, B, Sq, Hq, hd), randn(r, B, Skv, Hkv, hd),
            randn(r, B, Skv, Hkv, hd))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_full_attention(causal, window):
    q, k, v = qkv(rs("full", causal, window), 2, 24, 24, 4, 2, 16)
    close(TL.full_attention(T(q), T(k), T(v), causal=causal, window=window),
          RL.full_attention(J(q), J(k), J(v), causal=causal, window=window))


@pytest.mark.parametrize("impl", ["triangular", "masked"])
@pytest.mark.parametrize("shape", QKV, ids=["aligned", "offset", "padded"])
@pytest.mark.parametrize("window", [0, 11])
def test_chunked_attention(impl, shape, window):
    """Including Sq != Skv (the queries sit at the end of the kv range)
    and lengths that pad to whole chunks."""
    q, k, v = qkv(rs("chunked", impl, shape, window), *shape)
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=8, impl=impl)
    close(TL.chunked_attention(T(q), T(k), T(v), **kw),
          RL.chunked_attention(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("S", [24, 33], ids=["full", "chunked"])
@pytest.mark.parametrize("pad_q", [0, 2])
def test_attention(S, pad_q):
    """Both branches of the dispatch, and the repeated-KV layout of
    TP-padded heads (``pad_q_heads``)."""
    cfg = dataclasses.replace(f32(get_config("yi-6b", smoke=True)),
                              pad_q_heads=pad_q)
    q, k, v = qkv(rs("attn", S, pad_q), 2, S, S, cfg.q_heads(), 2, 16)
    close(TL.attention(T(q), T(k), T(v), cfg),
          RL.attention(J(q), J(k), J(v), cfg))


def test_decode_attention():
    r = rs("decode")
    q = randn(r, 2, 4, 16)
    kc, vc = randn(r, 2, 30, 2, 16), randn(r, 2, 30, 2, 16)
    valid = np.arange(30)[None, :] <= np.array([[11], [29]])
    close(TL.decode_attention(T(q), T(kc), T(vc), T(valid), torch.float32),
          RL.decode_attention(J(q), J(kc), J(vc), J(valid), jnp.float32))


@pytest.mark.parametrize("arch", ["yi-6b", "starcoder2-15b"],
                         ids=["swiglu", "gelu"])
def test_apply_mlp(arch):
    cfg = f32(get_config(arch, smoke=True))
    rp, tp = ref_params(RL.mlp_spec, cfg)
    x = randn(rs("mlp", arch), 2, 7, cfg.d_model)
    close(TL.apply_mlp(tp, T(x), cfg), RL.apply_mlp(rp, J(x), cfg))


def ssm_setup(salt, S):
    cfg = f32(get_config("mamba2-1.3b", smoke=True))
    rp, tp = ref_params(RM.mamba2_spec, cfg)
    r = rs("ssm", salt)
    # conv taps and bias are zeros at init: give them values
    for k in ("conv_w", "conv_b"):
        val = randn(r, *np.asarray(rp[k]).shape, scale=0.3)
        rp[k], tp[k] = J(val), T(val)
    return cfg, rp, tp, randn(r, 2, S, cfg.d_model)


@pytest.mark.parametrize("S", [64, 45, 13], ids=["chunks", "padded", "short"])
@pytest.mark.parametrize("return_state", [False, True])
def test_apply_ssd(S, return_state):
    cfg, rp, tp, x = ssm_setup(("seq", S), S)
    got = TM.apply_ssd(tp, T(x), cfg, return_state=return_state)
    want = RM.apply_ssd(rp, J(x), cfg, return_state=return_state)
    if not return_state:
        close(got, want)
        return
    close(got[0], want[0])
    for key in ("ssm", "conv"):
        close(got[1][key], want[1][key])


def test_apply_ssd_from_state():
    cfg, rp, tp, x = ssm_setup("state0", 40)
    _, st_ref = RM.apply_ssd(rp, J(x[:, :24]), cfg, return_state=True)
    st = {k: T(np.asarray(v)) for k, v in st_ref.items()}
    got = TM.apply_ssd(tp, T(x[:, 24:]), cfg, state0=st, return_state=True)
    want = RM.apply_ssd(rp, J(x[:, 24:]), cfg, state0=st_ref,
                        return_state=True)
    close(got[0], want[0])
    close(got[1]["ssm"], want[1]["ssm"])


def test_ssd_decode_step():
    cfg, rp, tp, x = ssm_setup("step", 1)
    di, nh, hp, N = TM.dims(cfg)
    r = rs("step-state")
    state = {"ssm": randn(r, 2, nh, hp, N), "conv": randn(r, 2, 3,
                                                          di + 2 * N)}
    got = TM.ssd_decode_step(tp, T(x), cfg,
                             {k: T(v) for k, v in state.items()})
    want = RM.ssd_decode_step(rp, J(x), cfg,
                              {k: J(v) for k, v in state.items()})
    close(got[0], want[0])
    for key in ("ssm", "conv"):
        close(got[1][key], want[1][key])


# -- whole model -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_model_matches_reference(arch, dtype):
    """``hidden`` over S+1 tokens, ``prefill_fn`` over S and one
    ``decode_fn`` step, port against reference, same weights."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ref = ref_build(cfg)
    rp = ref_init(ref.spec(), jax.random.PRNGKey(0))
    if cfg.family == "ssm":
        # the conv taps and bias are zeros at init, which makes every SSM
        # block output 0: give both models the same random taps
        ssm = rp["blocks"]["b0"]["ssm"]
        r = rs("conv", arch)
        for k in ("conv_w", "conv_b"):
            ssm[k] = J(randn(r, *ssm[k].shape, scale=0.5))
    model = build_model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    B, S, max_len = 2, 40, 48
    toks = rs("model", arch).randint(0, cfg.vocab, (B, S + 1)).astype(
        np.int32)

    def bound(want):
        scale = float(np.max(np.abs(np.asarray(want, np.float32))))
        return (1e-4 * scale if dtype == "float32"
                else 3e-2 * max(1.0, scale))

    def check(got, want):
        want = np.asarray(want, np.float32)
        err = float(np.max(np.abs(got.float().numpy() - want)))
        assert err <= bound(want), (arch, dtype, err, bound(want))

    h, _ = model.hidden(tp, T(toks))
    h_ref, _, _ = ref.hidden(rp, J(toks))
    check(h, h_ref)
    logits, cache = model.prefill_fn(tp, T(toks[:, :S]), max_len)
    logits_ref, cache_ref = ref.prefill_fn(rp, J(toks[:, :S]), max_len)
    check(logits, logits_ref)
    for g, w in zip(tree_leaves(cache["layers"]),
                    jax.tree.leaves(cache_ref["layers"])):
        assert tuple(g.shape) == w.shape
        check(g, w)
    step, cache = model.decode_fn(tp, T(toks[:, S]), cache)
    step_ref, cache_ref = ref.decode_fn(rp, J(toks[:, S]), cache_ref)
    check(step, step_ref)
    assert cache["lens"].tolist() == [S + 1] * B
    for g, w in zip(tree_leaves(cache["layers"]),
                    jax.tree.leaves(cache_ref["layers"])):
        check(g, w)
