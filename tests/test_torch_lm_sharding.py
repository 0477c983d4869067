"""The LM's sharded forms (``build_model(cfg, activation_hints(...))`` over
``launch.mesh.make_host_mesh((2, 4), devices=["cpu"] * 8)``) vs the
reference's single-device runs and the port's own (CPU).

The reference's multi-device runs of these three paths fail under jax
0.9's sharding rules (ROADMAP C1), so the port is held against its
single-device runs, at the bounds of the reference's own multi-device
tests:

* the FSDP+TP train step (qwen2-7b smoke, B 8 x S 64) against the
  reference's ``build_train_step`` on one device: loss within 2e-3,
  params within atol 3e-3 (``test_distributed.py``); in float32 against
  the port's single-device step: the loss within 1e-5, every gradient
  leaf within 1e-5 of its largest entry (or of 1e-3 of the largest over
  all leaves, where that is more), the params within 1e-5 wherever the
  gradient is not float32 noise (AdamW's first step moves a weight by
  about ``lr * sign(g)``; where the true gradient is 0, as for a key
  bias under the softmax, the sign is the noise's, within ``2 lr``);
* prefill with the KV cache split over ``model`` plus 4 decode steps
  (yi-6b smoke, B 4, S 32, ``max_len`` 64) against the reference's
  single-device decode within ``3e-2 * scale``
  (``test_serve_distributed.py``), and in float32 against the port's
  within 1e-5 of the logits' scale;
* the expert-parallel MoE (moonshot smoke, E 8, top-2, capacity factor
  8: nothing drops) against the reference's ``_moe_gspmd`` with no mesh:
  y within 1e-4, aux within 1e-5, finite gradients
  (``test_perf_features.py``);
* replicated blocks stay one tensor on one physical device and equal
  after 3 steps;
* every smoke config's loss, prefill and decode steps on the mesh
  against its single-device run in float32, within 1e-5 of the scale
  (every mixer in its sharded form: the SSD by head, the RG-LRU by
  channel, local and enc-dec attention by head; the forms themselves
  are held to the reference in ``tests/test_torch_mixer_tp.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.models import moe as RMOE
from repro.models.layers import NO_HINTS as REF_NO_HINTS
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (ShardedTensor,
                                              activation_hints,
                                              batch_shardings, is_sharded,
                                              shardings_for)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (OptimizerConfig, build_train_step,
                               init_train_state, loss_and_grads)
from test_torch_models import SERVED, randn, rs, seed_conv_taps

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


def ref_params(cfg, salt=""):
    rp = jax.tree.map(np.asarray, ref_init(ref_build(cfg).spec(),
                                           jax.random.PRNGKey(0)))
    seed_conv_taps(rp, rs("lm-sharding-conv", cfg.name, salt))
    return rp


def place(params, spec, mesh):
    return tree_map(lambda x, sh: sh.place(x), params,
                    shardings_for(spec, mesh))


def gathered(tree):
    return tree_map(lambda x: x.gather("cpu"), tree, is_leaf=is_sharded)


def scale_of(x):
    return max(1.0, float(x.abs().max()))


def token_batch(cfg, B, S, salt):
    r = rs("lm-sharding-batch", cfg.name, salt)
    St = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {"tokens": r.randint(0, cfg.vocab, (B, St)).astype(np.int32),
           "labels": r.randint(0, cfg.vocab, (B, St)).astype(np.int32)}
    out["labels"][:, ::5] = -1
    if cfg.family == "vlm":
        out["patches"] = randn(r, B, cfg.n_patches, cfg.d_model, scale=0.02)
    if cfg.family == "encdec":
        out["frames"] = randn(r, B, cfg.enc_seq, cfg.d_model, scale=0.02)
    return out


# -- the FSDP+TP train step ---------------------------------------------------


def sharded_step(cfg, rp, batch, mesh):
    B = batch["tokens"].shape[0]
    model = build_model(cfg, activation_hints(cfg, mesh, B, "train"),
                        device="cpu")
    params = place(params_from_reference(rp, cfg, "cpu"), model.spec(), mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb = tree_map(lambda x, sh: sh.place(x), tb, batch_shardings(tb, mesh, B))
    return model, params, tb


def test_sharded_train_step_equals_reference(mesh):
    cfg = get_config("qwen2-7b", smoke=True)
    rp = ref_params(cfg)
    batch = token_batch(cfg, 8, 64, "train")
    st, met = jax.jit(RS.build_train_step(ref_build(cfg), RO.OptimizerConfig(
        **OPT)))(RS.init_train_state(rp), {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    model, params, tb = sharded_step(cfg, rp, batch, mesh)
    s1, m1 = build_train_step(model, OptimizerConfig(**OPT))(
        init_train_state(params), tb)
    assert abs(float(m1["loss"]) - float(met["loss"])) < 2e-3
    for a, b in zip(tree_leaves(gathered(s1["params"])),
                    jax.tree.leaves(st["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-3,
                                   rtol=0)


def test_sharded_train_step_equals_single_device(mesh):
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              dtype="float32")
    rp = ref_params(cfg)
    batch = token_batch(cfg, 8, 64, "train")
    model, params, tb = sharded_step(cfg, rp, batch, mesh)
    single = build_model(cfg, device="cpu")
    p0 = params_from_reference(rp, cfg, "cpu")
    b0 = {k: torch.from_numpy(v) for k, v in batch.items()}
    l0, _, g0 = loss_and_grads(single, p0, b0)
    l1, _, g1 = loss_and_grads(model, params, tb)
    assert abs(float(l1) - float(l0)) < 1e-5
    g0l, g1l = tree_leaves(g0), tree_leaves(gathered(g1))
    top = max(float(g.abs().max()) for g in g0l)
    for a, b in zip(g1l, g0l):
        tol = 1e-5 * max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= tol
    opt = OptimizerConfig(**OPT)
    s0, _ = build_train_step(single, opt)(init_train_state(p0), b0)
    s1, _ = build_train_step(model, opt)(init_train_state(params), tb)
    for a, b, g in zip(tree_leaves(gathered(s1["params"])),
                       tree_leaves(s0["params"]), g0l):
        d = (a - b).abs()
        noise = g.abs() <= 1e-5 * max(float(g.abs().max()), 1e-3 * top)
        assert float(torch.where(noise, 0.0, d).max()) <= 1e-5
        assert float(d.max()) <= 2 * opt.lr + 1e-6


def test_replicated_copies_stay_equal_after_three_steps(mesh):
    """After 3 steps every leaf's per-device blocks (``blocks()``) agree
    bit for bit across the copies of each block, a block held by several
    mesh devices of one physical device is one tensor there, and the
    gathered params equal the blocks laid out afresh."""
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              dtype="float32")
    model, params, tb = sharded_step(cfg, ref_params(cfg),
                                     token_batch(cfg, 8, 32, "copies"), mesh)
    state = init_train_state(params)
    step = build_train_step(model, OptimizerConfig(**OPT))
    for _ in range(3):
        state, met = step(state, tb)
        assert np.isfinite(float(met["loss"]))
    n_repl = 0
    for leaf in tree_leaves(state["params"], is_sharded):
        sh = leaf.sharding
        blocks = leaf.blocks()
        by_index = {}
        for coord, b in zip(np.ndindex(mesh.devices.shape), blocks):
            g = sh.index(coord, leaf.ndim)
            if g in by_index:
                assert b is by_index[g] or torch.equal(b, by_index[g])
                assert b is by_index[g]      # one physical device
                n_repl += 1
            by_index[g] = b
        assert len(by_index) == len(leaf)
        assert torch.equal(sh.place(leaf.gather("cpu")).gather("cpu"),
                           leaf.gather("cpu"))
    assert n_repl > 0


# -- prefill and decode with the cache split over ``model`` -------------------


def decode_run(model, params, toks, S, max_len, steps=4):
    logits, cache = model.prefill_fn(params, toks[:, :S], max_len)
    out = [logits]
    for i in range(steps):
        logits, cache = model.decode_fn(params, toks[:, S + i], cache)
        out.append(logits)
    return out, cache


def sharded_models(cfg, mesh, B):
    return (build_model(cfg, activation_hints(cfg, mesh, B, "prefill"),
                        device="cpu"),
            build_model(cfg, activation_hints(cfg, mesh, B, "decode"),
                        device="cpu"))


class Served:
    """Prefill with one model, decode with the other (the reference
    builds one per step kind)."""

    def __init__(self, pre, dec):
        self.prefill_fn, self.decode_fn = pre.prefill_fn, dec.decode_fn


def test_sharded_decode_equals_reference(mesh):
    cfg = get_config("yi-6b", smoke=True)
    rp = ref_params(cfg)
    B, S, max_len = 4, 32, 64
    toks = rs("decode", cfg.name).randint(0, cfg.vocab, (B, S + 4)).astype(
        np.int32)
    ref = ref_build(cfg)
    _, c = jax.jit(lambda p, t: ref.prefill_fn(p, t, max_len))(
        rp, jnp.asarray(toks[:, :S]))
    want = []
    for i in range(4):
        lg, c = jax.jit(ref.decode_fn)(rp, jnp.asarray(toks[:, S + i]), c)
        want.append(np.asarray(lg, np.float32))
    pre, dec = sharded_models(cfg, mesh, B)
    params = place(params_from_reference(rp, cfg, "cpu"), pre.spec(), mesh)
    got, cache = decode_run(Served(pre, dec), params, torch.from_numpy(toks),
                            S, max_len)
    for g, w in zip(got[1:], want):
        err = float(np.abs(g.float().numpy() - w).max())
        assert err < 3e-2 * (float(np.abs(w).max()) + 1.0), err
    k = cache["layers"]["b0"]["k"]
    assert isinstance(k, ShardedTensor) and len(k) == 8
    assert tuple(k.sharding.spec) == (None, "data", "model")
    assert tuple(k[0].shape) == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                 cfg.head_dim)


def decode_against_single_device(mesh, max_len):
    """Sharded prefill plus 4 decode steps (yi-6b smoke, float32, B 4,
    S 32) against the port's single-device run: the logits within 1e-5
    of their scale, the split cache's first ``max_len`` rows within 1e-5
    of the single-device cache and its rows past them zero."""
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              dtype="float32")
    rp = ref_params(cfg)
    B, S = 4, 32
    toks = torch.from_numpy(rs("decode", cfg.name).randint(
        0, cfg.vocab, (B, S + 4)).astype(np.int32))
    p0 = params_from_reference(rp, cfg, "cpu")
    want, c0 = decode_run(build_model(cfg, device="cpu"), p0, toks, S,
                          max_len)
    pre, dec = sharded_models(cfg, mesh, B)
    got, c1 = decode_run(Served(pre, dec), place(p0, pre.spec(), mesh),
                         toks, S, max_len)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale_of(w)
    k = c1["layers"]["b0"]["k"]
    assert tuple(k.sharding.spec) == (None, "data", "model")
    M = mesh.shape["model"]
    assert k.shape[2] == M * -(-max_len // M)
    got_k = k.gather("cpu")
    torch.testing.assert_close(got_k[:, :, :max_len],
                               c0["layers"]["b0"]["k"], atol=1e-5, rtol=0)
    assert not got_k[:, :, max_len:].any()
    assert torch.equal(c1["lens"].gather("cpu"), c0["lens"])


def test_sharded_decode_equals_single_device(mesh):
    decode_against_single_device(mesh, 64)


def test_sharded_decode_with_uneven_max_len_equals_single_device(mesh):
    """``max_len`` 66 does not split over the 4 model devices: the cache
    is split all the same, padded to 68 rows."""
    decode_against_single_device(mesh, 66)


# -- expert parallelism --------------------------------------------------------


def test_ep_moe_equals_reference(mesh):
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", smoke=True),
                              n_experts=8, top_k=2, capacity_factor=8.0)
    rcfg = dataclasses.replace(ref_config("moonshot-v1-16b-a3b", smoke=True),
                               n_experts=8, top_k=2, capacity_factor=8.0)
    rp = jax.tree.map(np.asarray, ref_init(RMOE.moe_spec(rcfg),
                                           jax.random.PRNGKey(0)))
    x = randn(rs("ep", cfg.name), 4, 32, cfg.d_model, scale=0.5)
    y0, a0 = RMOE._moe_gspmd(jax.tree.map(jnp.asarray, rp), jnp.asarray(x),
                             rcfg, REF_NO_HINTS)
    hints = activation_hints(cfg, mesh, 4, "train")
    assert TMOE.uses_ep(cfg, hints)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    tp = tree_map(lambda t, sh: sh.place(t), tp,
                  shardings_for(TMOE.moe_spec(cfg), mesh))
    TMOE.reset_dropped()
    y1, a1 = TMOE.apply_moe(tp, torch.from_numpy(x), cfg, hints)
    assert TMOE.dropped_pairs() == 0
    assert float(np.abs(y1.numpy() - np.asarray(y0)).max()) < 1e-4
    assert abs(float(a1) - float(a0)) < 1e-5
    req = tree_map(lambda t: t.detach().requires_grad_(), tp)
    TMOE.apply_moe(req, torch.from_numpy(x), cfg, hints)[0].sum().backward()
    grads = [t.grad for t in tree_leaves(req)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_ep_moe_not_taken_for_decode_or_indivisible(mesh):
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", smoke=True),
                              n_experts=6)
    assert not TMOE.uses_ep(cfg, activation_hints(cfg, mesh, 4, "train"))
    cfg8 = dataclasses.replace(cfg, n_experts=8)
    assert not TMOE.uses_ep(cfg8, activation_hints(cfg8, mesh, 4, "decode"))
    assert TMOE.uses_ep(cfg8, activation_hints(cfg8, mesh, 4, "prefill"))


# -- every family, float32, against its single-device run -----------------------


def forms(model, params, batch, max_len):
    """[loss, nll, prefill logits, 2 decode steps' logits]: the prefill
    over all but the last two tokens (behind the VLM's patches), the
    decode steps over those two."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = model.loss_fn(params, tb)
    extra = {k: tb[k] for k in ("patches", "frames") if k in tb}
    St = tb["tokens"].shape[1]
    logits, cache = model.prefill_fn(params, tb["tokens"][:, :St - 2],
                                     max_len, **extra)
    out = [loss, met["nll"], logits]
    for i in range(2):
        logits, cache = model.decode_fn(params, tb["tokens"][:, St - 2 + i],
                                        cache)
        out.append(logits)
    return out


@pytest.mark.parametrize("arch", SERVED)
def test_every_family_on_the_mesh_equals_single_device(arch, mesh):
    """64 positions (the VLM's patches among them): the loss's chunks and
    the smoke configs' attention chunks both 32."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rp = ref_params(cfg, "family")
    B = 4
    batch = token_batch(cfg, B, 64, "family")
    p0 = params_from_reference(rp, cfg, "cpu")
    want = forms(build_model(cfg, device="cpu"), p0, batch, 64)
    model = build_model(cfg, activation_hints(cfg, mesh, B, "train"),
                        device="cpu")
    got = forms(model, place(p0, model.spec(), mesh), batch, 64)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale_of(w), arch
