"""The port's LM serving path vs the reference models (CPU).

Inputs are made with numpy from a seed; the reference's params come from
``repro.models.init_params`` and are carried across with
``params_from_reference``, so both packages compute from the same
weights.  Each layer the serving path runs is held to the reference's at
1e-5 in float32 (the MoE layer in ``tests/test_torch_moe.py``, the
enc-dec model's in ``tests/test_torch_encdec.py``); every smoke
config's ``hidden`` (for the enc-dec family ``encode`` feeding
``_decoder_hidden``; for the VLM, ``hidden`` behind its patches),
``prefill_fn`` and three ``decode_fn`` steps to 1e-4 of the output's
scale in float32, moonshot's also at a capacity factor where the prefill
drops pairs, whisper's also with an encoder past ``attention()``'s
full-attention cut.  In bfloat16 every family but the hybrid is held to
the reference in bfloat16 at its own decode-vs-forward bound (``3e-2 *
max(1, scale)``, ``tests/test_models.py``), the hybrid to the reference
in float32 at ``HYBRID_BF16_TOL`` (see there).  The 16-bit weight store
(``store=cfg.dtype``) computes the float32 store's bits in every
family.  Frames and patches are drawn at the reference test's 0.02
scale.
On the CPU the attention kernel's and the SSD kernel's plain versions
run: the smoke configs' 40-token prompts take ``attention()``'s chunked
branch and pad ``apply_ssd`` to whole chunks.  The hybrid's local
attention keeps a ring cache of ``window`` = 32 slots: a 40-token prompt
leaves a full ring whose live slots every decode step overwrites, a
30-token prompt leaves two empty slots that the third step passes, and
70- and 100-token prompts wrap the ring before the first step.  Run as
a script, the file prints the bf16 reading behind ``HYBRID_BF16_TOL``.
This file imports nothing of ``repro.core`` or ``repro.kernels`` (they
turn on jax's x64 mode).
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
from repro.models import transformer as RT
from repro.models.params import LeafSpec as RefLeafSpec
from repro_torch.configs import get_config
from repro_torch.models import (BlockKind, build_model, init_params,
                                model_cache_spec, param_count)
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import is_leaf_spec, tree_leaves

SERVED = ["yi-6b", "qwen2-7b", "starcoder2-15b", "mistral-large-123b",
          "moonshot-v1-16b-a3b", "dbrx-132b", "mamba2-1.3b",
          "recurrentgemma-9b", "whisper-tiny", "phi-3-vision-4.2b"]
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


def ref_fields(s):
    """A spec leaf's fields as the reference defines them (the port's
    ``LeafSpec`` adds ``cast``, the mark of its 16-bit store)."""
    return tuple(getattr(s, f.name) for f in dataclasses.fields(RefLeafSpec))


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
    assert [ref_fields(s) for s in got] == [ref_fields(s) for s in ref]
    assert param_count(build_model(cfg, device="cpu").spec()) == sum(
        math.prod(s.shape) for s in ref)


def test_cache_spec_matches_reference():
    from repro.models import model_cache_spec as ref_cache_spec
    for arch in SERVED:
        ref = jax.tree.leaves(ref_cache_spec(ref_config(arch), 2, 64),
                              is_leaf=lambda x: isinstance(x, RefLeafSpec))
        got = tree_leaves(model_cache_spec(get_config(arch), 2, 64),
                          is_leaf_spec)
        assert [ref_fields(s) for s in got] == [ref_fields(s) for s in ref]


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


@pytest.mark.parametrize("draw", ["whole", "slices"])
def test_init_params_16bit_store_is_seeded(monkeypatch, draw):
    """``store=cfg.dtype``: each leaf marked ``cast`` is drawn into the
    compute type, every other leaf is float32, and the same seed gives
    the same leaves, whether a 16-bit leaf is drawn in one run or one
    slice of its leading dim at a time (``slices``)."""
    if draw == "slices":
        monkeypatch.setattr(TP, "_DRAW_ELEMS", 1)
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    spec = build_model(cfg, device="cpu").spec()
    a, b, c = (init_params(spec, seed, device="cpu", store=cfg.dtype)
               for seed in (3, 3, 4))
    la, lb = tree_leaves(a), tree_leaves(b)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"], c["embed"])
    for s, x in zip(tree_leaves(spec, is_leaf_spec), la):
        assert tuple(x.shape) == s.shape
        assert x.dtype == (torch.bfloat16 if s.cast else torch.float32)
    assert 0.015 < float(a["embed"].float().std()) < 0.025  # scale 0.02
    gate = a["blocks"]["b0"]["moe"]["gate"].float()   # 1/sqrt(d_model)
    assert abs(float(gate.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    with pytest.raises(ValueError, match="store"):
        init_params(spec, 0, device="cpu", store="bf16")


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


def test_every_config_is_served():
    """Every config's family has a model; a family that no config has
    raises."""
    assert sorted(SERVED) == sorted(ARCH_NAMES)
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              family="audio")
    with pytest.raises(NotImplementedError, match="audio"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="audio"):
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


# -- hybrid blocks ------------------------------------------------------------


def hybrid_block(salt, kind):
    """(cfg, reference block params, the same as tensors) of one
    recurrentgemma smoke block of ``kind``, conv taps seeded."""
    cfg = f32(get_config("recurrentgemma-9b", smoke=True))
    rp, tp = ref_params(RT.block_spec, cfg, kind)
    if kind == BlockKind.RECURRENT:
        r = rs("hybrid-taps", salt)
        for k in ("conv_w", "conv_b"):
            val = randn(r, *np.asarray(rp["rglru"][k]).shape, scale=0.5)
            rp["rglru"][k], tp["rglru"][k] = J(val), T(val)
    return cfg, rp, tp


@pytest.mark.parametrize("S", [5, 31, 32, 45, 70],
                         ids=["short", "W-1", "W", "over", "wrapped"])
def test_local_attn_prefill_cache(S):
    """The ring cache a prompt of S tokens leaves (window W = 32): S < W
    (position p at slot p, the rest empty with pos -1) and S >= W (the
    last W positions at slot p % W)."""
    cfg = f32(get_config("recurrentgemma-9b", smoke=True))
    r = rs("ring", S)
    k, v = (randn(r, 2, S, cfg.n_kv_heads, cfg.head_dim) for _ in "kv")
    got = TT._attn_cache_from_prefill(T(k), T(v), BlockKind.LOCAL_ATTN,
                                      cfg, S + 8)
    want = RT._attn_cache_from_prefill(J(k), J(v), BlockKind.LOCAL_ATTN,
                                       cfg, S + 8)
    assert sorted(got) == sorted(want) == ["k", "pos", "v"]
    for key in got:
        assert got[key].dtype == T(np.asarray(want[key])).dtype
        assert torch.equal(got[key], T(np.asarray(want[key])))


@pytest.mark.parametrize("S", [20, 45], ids=["below-window", "past-window"])
@pytest.mark.parametrize("kind", [BlockKind.RECURRENT, BlockKind.LOCAL_ATTN])
def test_hybrid_apply_block(kind, S):
    """One block's prefill form and the cache entry it collects."""
    cfg, rp, tp = hybrid_block(("block", S), kind)
    x = randn(rs("hybrid-x", kind, S), 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    h, aux, c = TT.apply_block(tp, T(x), kind, cfg, T(pos), True, S + 4)
    h_ref, aux_ref, c_ref = RT.apply_block(rp, J(x), kind, cfg, J(pos),
                                           RL.NO_HINTS, True, S + 4)
    close(h, h_ref)
    close(aux, aux_ref)
    for g, w in zip(tree_leaves(c), jax.tree.leaves(c_ref)):
        close(g, w)


@pytest.mark.parametrize("kind", [BlockKind.RECURRENT, BlockKind.LOCAL_ATTN])
def test_hybrid_apply_block_decode(kind):
    """Three decode steps from a 30-token prefill (the third passes the
    32-slot ring's end); the port writes the ring in place and returns a
    fresh RG-LRU state."""
    cfg, rp, tp = hybrid_block("decode", kind)
    r = rs("hybrid-decode", kind)
    S = 30
    x = randn(r, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    _, _, c = TT.apply_block(tp, T(x), kind, cfg, T(pos), True, S + 4)
    _, _, c_ref = RT.apply_block(rp, J(x), kind, cfg, J(pos), RL.NO_HINTS,
                                 True, S + 4)
    for i in range(3):
        lens = np.full((2,), S + i, np.int32)
        xt = randn(r, 2, 1, cfg.d_model)
        h, c = TT.apply_block_decode(tp, T(xt), kind, cfg, c, T(lens))
        h_ref, c_ref = RT.apply_block_decode(rp, J(xt), kind, cfg, c_ref,
                                             J(lens), RL.NO_HINTS)
        close(h, h_ref)
        for g, w in zip(tree_leaves(c), jax.tree.leaves(c_ref)):
            close(g, w)


# -- whole model -------------------------------------------------------------


def seed_conv_taps(rp, r):
    """The same random conv taps and bias for both models in every SSM
    and RG-LRU block, in the groups and the tail: both are zeros at
    init, which makes every SSM block output 0 and every RG-LRU block's
    conv output its bias alone."""
    blocks = [*rp.get("blocks", {}).values(), *rp.get("tail", [])]
    for blk in blocks:
        for name in ("ssm", "rglru"):
            if name in blk:
                for k in ("conv_w", "conv_b"):
                    blk[name][k] = J(randn(r, *blk[name][k].shape,
                                           scale=0.5))


def leaves(tree, name=""):
    """(key, leaf) pairs of a cache tree, torch or jax, in
    ``jax.tree.leaves``' order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v, name)]
    return [(name, tree)]


def served_outputs(hidden, prefill, decode, toks, S, steps, pre=0):
    """[(name, array)] of ``hidden`` over S + steps tokens, then the
    logits and every cache leaf (groups and tail, ``lens`` included)
    after ``prefill`` over S tokens and after each of ``steps``
    ``decode`` steps, each copied as it is made (the port writes its
    cache in place).  ``pre``: positions in front of the tokens (the
    VLM's patches), which the cache holds too.  Floating leaves come as
    float32."""
    def snap(a):
        a = np.array(a.float() if torch.is_tensor(a) and a.is_floating_point()
                     else a, copy=True)
        return a if a.dtype.kind in "iu" else a.astype(np.float32)

    out = [("hidden", snap(hidden(toks)))]
    logits, cache = prefill(toks[:, :S], pre + S + 8)
    for i in range(S, S + steps + 1):
        out += [("logits", snap(logits))]
        out += [(k, snap(v)) for k, v in leaves(cache)]
        if i < S + steps:
            logits, cache = decode(toks[:, i], cache)
    return out


def model_outputs(model, params, toks, S, steps, extra, A):
    """``served_outputs`` of a model of either package (``A`` makes its
    arrays): ``hidden`` is ``encode`` feeding ``_decoder_hidden`` for the
    enc-dec family (``extra["frames"]``), ``hidden`` behind the patches
    for the VLM (``extra["patches"]``), else ``hidden``; the prefill
    takes ``extra`` as it is."""
    kw = {k: A(v) for k, v in extra.items()}
    if "frames" in kw:
        def hidden(t):
            return model._decoder_hidden(params, A(t),
                                         model.encode(params,
                                                      kw["frames"]))[0]
    else:
        def hidden(t):
            return model.hidden(params, A(t), kw.get("patches"))[0]
    pre = extra["patches"].shape[1] if "patches" in extra else 0
    return served_outputs(
        hidden, lambda t, n: model.prefill_fn(params, A(t), n, **kw),
        lambda t, c: model.decode_fn(params, A(t), c), toks, S, steps, pre)


def port_outputs(model, params, toks, S, steps, extra):
    return model_outputs(model, params, toks, S, steps, extra, T)


def ref_outputs(ref, params, toks, S, steps, extra):
    return model_outputs(ref, params, toks, S, steps, extra, J)


def model_inputs(cfg, r):
    """The enc-dec family's ``frames`` or the VLM's ``patches`` for B = 2,
    at the reference test's 0.02 scale (else nothing)."""
    if cfg.family == "encdec":
        return {"frames": randn(r, 2, cfg.enc_seq, cfg.d_model, scale=0.02)}
    if cfg.family == "vlm":
        return {"patches": randn(r, 2, cfg.n_patches, cfg.d_model,
                                 scale=0.02)}
    return {}


def served_setup(arch, dtype, S, steps, seed=0, **overrides):
    """(smoke cfg in ``dtype`` with ``overrides``, reference params with
    seeded conv taps, the port's model and params on the same weights,
    B = 2 prompts of S + steps tokens, the frames or patches the family
    takes)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **overrides)
    salt = (arch,) if seed == 0 else (arch, seed)
    rp = ref_init(ref_build(cfg).spec(), jax.random.PRNGKey(seed))
    seed_conv_taps(rp, rs("conv", *salt))
    model = build_model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    toks = rs("model", *salt).randint(0, cfg.vocab, (2, S + steps)).astype(
        np.int32)
    return cfg, rp, model, tp, toks, model_inputs(cfg, rs("inputs", *salt))


def max_errs(got, want):
    """Each output's max abs error over max(1, its own scale) (float32:
    over its scale), key by key; integer leaves must be equal."""
    assert [k for k, _ in got] == [k for k, _ in want]
    errs = []
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), name
            continue
        errs.append((name, float(np.max(np.abs(g - w))),
                     float(np.max(np.abs(w)))))
    return errs


# bf16 hybrid: the port against the reference in float32 on the same
# weights, at this fraction of max(1, scale) of every output and cache
# leaf.  Set from the reading of ``bf16_readings`` (run this file as a
# script): over 5 weight seeds x prompts of 30, 40, 70 and 100 tokens x
# 3 decode steps, the reference's own bf16 lies up to 0.056 of that
# scale from its float32, the port's bf16 up to 0.072, the first
# layer's RG-LRU state bit-equal between the two bf16 runs.
HYBRID_BF16_TOL = 8e-2


def model_matches_reference(arch, dtype, S, steps, **overrides):
    """``hidden`` over S + steps tokens, ``prefill_fn`` over S and
    ``steps`` ``decode_fn`` steps, port against reference, same weights;
    the logits and the whole cache (groups and tail) after the prefill
    and each step, every leaf at the bound of its own scale and integer
    leaves (``lens``, ring ``pos``) equal.  float32: 1e-4 of the scale.
    bfloat16: dense and ssm against the reference in bfloat16 at
    3e-2 * max(1, scale); the hybrid against the reference in float32
    at ``HYBRID_BF16_TOL`` * max(1, scale), because its RG-LRU state
    carries the stream's bf16 rounding along the whole prompt, so two
    bf16 computations (the reference's and the port's, which round
    products in different orders) lie as far from each other as each
    lies from float32."""
    cfg, rp, model, tp, toks, extra = served_setup(arch, dtype, S, steps,
                                                   **overrides)
    hybrid_bf16 = dtype == "bfloat16" and cfg.family == "hybrid"
    ref = ref_build(f32(cfg) if hybrid_bf16 else cfg)
    tol = (1e-4 if dtype == "float32"
           else HYBRID_BF16_TOL if hybrid_bf16 else 3e-2)
    got = port_outputs(model, tp, toks, S, steps, extra)
    want = ref_outputs(ref, rp, toks, S, steps, extra)
    for name, err, scale in max_errs(got, want):
        bound = tol * (scale if dtype == "float32" else max(1.0, scale))
        assert err <= bound, (arch, dtype, name, err, bound)


def bf16_readings(arch, S, steps, seed):
    """{output or leaf name: (port bf16, reference bf16)}: the largest
    error of each against the reference in float32 on the same weights,
    over max(1, its scale)."""
    cfg, rp, model, tp, toks, extra = served_setup(arch, "bfloat16", S,
                                                   steps, seed)
    want = ref_outputs(ref_build(f32(cfg)), rp, toks, S, steps, extra)
    port = max_errs(port_outputs(model, tp, toks, S, steps, extra), want)
    own = max_errs(ref_outputs(ref_build(cfg), rp, toks, S, steps, extra),
                   want)
    out = {}
    for (name, e_p, sc), (_, e_r, _) in zip(port, own):
        p, r = out.get(name, (0.0, 0.0))
        out[name] = (max(p, e_p / max(1.0, sc)), max(r, e_r / max(1.0, sc)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_model_matches_reference(arch, dtype):
    """A 40-token prompt and three decode steps (past the hybrid smoke
    config's 32-slot ring; behind the VLM's 8 patches; against
    whisper's 16 encoder frames, which take the full-attention branch)."""
    model_matches_reference(arch, dtype, 40, 3)


@pytest.mark.parametrize("arch", ["yi-6b", "phi-3-vision-4.2b"],
                         ids=["dense", "vlm"])
def test_model_matches_reference_sinusoidal(arch):
    """``pos="sinusoidal"`` on a decoder-only config (no config of these
    families has it, but ``ArchConfig`` takes it): the table after the
    VLM's patches in ``hidden`` and the prefill, its row at ``lens`` in
    each decode step, in float32 against the reference."""
    model_matches_reference(arch, "float32", 40, 3, pos="sinusoidal")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_fused_encoder_matches_reference(dtype):
    """whisper's smoke config with 40 encoder frames, past its 32-key
    ``kv_chunk``: the encoder's self-attention takes ``attention()``'s
    fused, non-causal branch, as whisper-tiny's 1500 frames do."""
    model_matches_reference("whisper-tiny", dtype, 40, 3, enc_seq=40)


def test_moe_with_drops_matches_reference():
    """moonshot's smoke config at capacity factor 1.0 (its own is 4.0,
    where nothing drops) in float32: the prefill's 80 tokens fill 4
    experts of capacity 40 unevenly and drop pairs, ``hidden()`` too,
    and the port still matches the reference's hidden, prefill and
    three decode steps (two tokens a step: capacity 8, no drop)."""
    arch, S = "moonshot-v1-16b-a3b", 40
    _, _, model, tp, toks, _ = served_setup(arch, "float32", S, 3,
                                            capacity_factor=1.0)
    TMOE.reset_dropped()
    model.prefill_fn(tp, T(toks[:, :S]), S + 8)
    assert TMOE.dropped_pairs() > 0
    model_matches_reference(arch, "float32", S, 3, capacity_factor=1.0)


# leaves every path reads in float32: the 16-bit store keeps them so
F32_READ = {"router", "ln", "ln1", "ln2", "lnx", "enc_norm", "final_norm",
            "norm", "w_a", "w_i", "lam", "conv_w", "conv_b", "a_log",
            "dt_bias", "d_skip"}


def leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b",
                                  "mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-tiny", "phi-3-vision-4.2b"],
                         ids=["dense", "moe", "ssm", "hybrid", "encdec",
                              "vlm"])
def test_16bit_store_equals_float32_store(arch):
    """The same reference weights carried across in the float32 store and
    in the 16-bit one (``store=cfg.dtype``), bf16 compute: ``hidden``,
    then the logits and every cache leaf after a prefill and after each
    of three decode steps, equal bit for bit.  The leaves read in
    float32 (``F32_READ``) stay float32 and equal; the rest are bf16."""
    cfg, rp, model, tp, toks, extra = served_setup(arch, "bfloat16", 40, 3)
    t16 = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu",
                                store=cfg.dtype)
    for (path, x16), (_, x32) in zip(leaf_paths(t16), leaf_paths(tp)):
        f32_read = bool(F32_READ & set(path))
        assert x16.dtype == (torch.float32 if f32_read
                             else torch.bfloat16), path
        assert torch.equal(x16, x32.to(x16.dtype)), path
    got = port_outputs(model, t16, toks, 40, 3, extra)
    want = port_outputs(model, tp, toks, 40, 3, extra)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("S", [30, 70, 100],
                         ids=["shorter", "past", "far-past"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prompt_around_the_window(dtype, S):
    """Prompts around the 32-slot window: at 30 tokens the ring cache's
    S < W branch (two empty slots, the full-attention branch of
    ``attention()``) and three decode steps that fill the ring and
    overwrite its first slot; at 70 and 100 tokens a ring that wrapped
    before the first step, and an RG-LRU state over the whole prompt."""
    model_matches_reference("recurrentgemma-9b", dtype, S, 3)


if __name__ == "__main__":
    # the reading behind HYBRID_BF16_TOL: for each weight seed and prompt
    # length, the largest error of the port's bf16 and of the reference's
    # own bf16 against the reference in float32, by output or leaf name
    worst = {"port": 0.0, "reference": 0.0}
    for seed in range(5):
        for S in (30, 40, 70, 100):
            r = bf16_readings("recurrentgemma-9b", S, 3, seed)
            print(f"seed {seed} S {S}: " + ", ".join(
                f"{k} {p:.4f}/{q:.4f}" for k, (p, q) in r.items()),
                flush=True)
            worst["port"] = max(worst["port"], *(p for p, _ in r.values()))
            worst["reference"] = max(worst["reference"],
                                     *(q for _, q in r.values()))
    print("worst (port bf16, reference bf16) against float32:", worst)
