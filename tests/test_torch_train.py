"""The port's training numerics vs the reference (CPU): ``loss_fn``,
``chunked_ce``, the gradients, AdamW and its schedule, microbatch
accumulation, the out-of-place RG-LRU scan and the training route of
attention and SSD.

Every smoke config runs in float32 on the same weights
(``params_from_reference``, the SSM and RG-LRU conv taps seeded) and the
same numpy batch: B = 2 sequences of 64 positions (the VLM's 8 patches
in front of 56 tokens, whisper's 16 encoder frames), a few labels -1.
At 64 positions attention takes its chunked branch (the smoke configs'
chunks are 32), the SSD scan two chunks, and the hybrid's local
attention runs past its 32-key window.  Tolerances: the loss and its
terms to 2e-6 of their scale; each gradient leaf to 1e-4 of its own
largest entry, or of 1e-3 of the largest over all leaves where that is
more (a leaf whose true gradient is 0, such as a key bias under the
softmax, holds float32 noise alone); one AdamW step's ``m`` and ``v``
the same; its params to a tenth of the step's learning rate.  Adam's
first step moves a weight by ``lr * g / (|g| + eps)`` with ``g`` the
clipped gradient, about ``lr`` in sign, so where ``|g|`` is near ``eps``
= 1e-8 the gradients' float32 noise (1e-6 of their leaf's scale) moves
that fraction by a few percent, while a gradient of the wrong sign
would miss by ``2 lr``.  ``adamw_update`` itself, given the same
gradients, is held to 1e-6.  The training route never reaches a
kernel's wrapper (each replaced by one that raises).  This file imports nothing of
``repro.core`` or ``repro.kernels`` (they turn on jax's x64 mode).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build, init_params as ref_init
from repro.models import layers as RL
from repro.models import rglru as RR
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (OptimizerConfig, adamw_update,
                               build_train_step, cosine_schedule,
                               init_train_state, loss_and_grads)
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from test_torch_models import SERVED, J, T, randn, rs, seed_conv_taps

B, S = 2, 64
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=16)
LOSS_TOL = 2e-6        # of max(1, |value|)
GRAD_TOL = 1e-4        # of the leaf's largest |gradient| (or FLOOR's)
MOMENT_TOL = 1e-4      # of the leaf's largest |m| or |v| (or FLOOR's)
FLOOR = 1e-3           # of the largest entry over all leaves
PARAM_TOL = 0.1        # of the step's learning rate, absolute


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch_for(cfg, salt):
    """numpy batch of B rows over S positions: tokens, labels (every
    seventh -1), the VLM's patches or whisper's frames at 0.02."""
    r = rs("train-batch", cfg.name, salt)
    St = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    toks = r.randint(0, cfg.vocab, (B, St)).astype(np.int32)
    labels = r.randint(0, cfg.vocab, (B, St)).astype(np.int32)
    labels[:, ::7] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        out["patches"] = randn(r, B, cfg.n_patches, cfg.d_model, scale=0.02)
    if cfg.family == "encdec":
        out["frames"] = randn(r, B, cfg.enc_seq, cfg.d_model, scale=0.02)
    return out


def setup(arch, **overrides):
    """(float32 smoke cfg, reference model, its params with seeded conv
    taps (numpy), the port's model, numpy batch)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **overrides)
    rp = ref_init(ref_build(cfg).spec(), jax.random.PRNGKey(0))
    seed_conv_taps(rp, rs("train-conv", arch))
    return (cfg, ref_build(cfg), np_tree(rp), build_model(cfg, device="cpu"),
            batch_for(cfg, overrides.get("pos", "")))


def port_params(cfg, rp):
    return params_from_reference(rp, cfg, "cpu")


@functools.lru_cache(maxsize=None)
def reference(arch, pos=None):
    """The reference's loss, metrics and gradients, and one train step's
    state and metrics, as numpy."""
    kw = {} if pos is None else {"pos": pos}
    cfg, ref, rp, _, batch = setup(arch, **kw)
    jb = {k: J(v) for k, v in batch.items()}
    (loss, met), grads = jax.jit(jax.value_and_grad(
        ref.loss_fn, has_aux=True))(rp, jb)
    step = jax.jit(RS.build_train_step(ref, RO.OptimizerConfig(**OPT)))
    st, smet = step(RS.init_train_state(rp), jb)
    return {"loss": float(loss), "metrics": np_tree(met),
            "grads": np_tree(grads), "state": np_tree(st),
            "step": np_tree(smet)}


@functools.lru_cache(maxsize=None)
def port(arch, pos=None):
    kw = {} if pos is None else {"pos": pos}
    cfg, _, rp, model, batch = setup(arch, **kw)
    tb = {k: T(v) for k, v in batch.items()}
    loss, met, grads = loss_and_grads(model, port_params(cfg, rp), tb)
    step = build_train_step(model, OptimizerConfig(**OPT))
    st, smet = step(init_train_state(port_params(cfg, rp)), tb)
    return {"loss": float(loss), "metrics": met, "grads": grads,
            "state": st, "step": smet}


def near(got, want, tol, what):
    got = float(got.detach() if torch.is_tensor(got) else got)
    assert abs(got - float(want)) <= tol * max(1.0, abs(float(want))), (
        what, got, float(want))


def leaf_close(got, want, tol, what, absolute=False, floor=0.0):
    """Every leaf within ``tol``: absolute, or of the leaf's largest
    |entry|, or of ``floor`` times the largest over all leaves where
    that is more."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    top = max(float(np.max(np.abs(b))) for b in w if b.size)
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().float().numpy()
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = 1.0 if absolute else max(float(np.max(np.abs(b))),
                                         floor * top, 1e-30)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        assert err <= tol * scale, (what, i, err, tol * scale)


# -- the loss and its gradients -----------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_loss_matches_reference(arch):
    got, want = port(arch), reference(arch)
    near(got["loss"], want["loss"], LOSS_TOL, "loss")
    near(got["metrics"]["nll"], want["metrics"]["nll"], LOSS_TOL, "nll")
    near(got["metrics"]["aux"], want["metrics"]["aux"], LOSS_TOL, "aux")
    assert int(got["metrics"]["tokens"]) == int(want["metrics"]["tokens"])
    assert got["metrics"]["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch", SERVED)
def test_grads_match_reference(arch):
    leaf_close(port(arch)["grads"], reference(arch)["grads"], GRAD_TOL,
               "grads", floor=FLOOR)


@pytest.mark.parametrize("arch", SERVED)
def test_adamw_step_matches_reference(arch):
    """One train step from the same weights: lr, grad_norm, the loss and
    the new params, m and v, leaf by leaf; ``step`` advanced to 1."""
    got, want = port(arch), reference(arch)
    for k in ("loss", "lr", "grad_norm"):
        near(got["step"][k], want["step"][k], LOSS_TOL, k)
    gs, ws = got["state"], want["state"]
    assert int(gs["opt"]["step"]) == int(ws["opt"]["step"]) == 1
    leaf_close(gs["opt"]["m"], ws["opt"]["m"], MOMENT_TOL, "m", floor=FLOOR)
    leaf_close(gs["opt"]["v"], ws["opt"]["v"], MOMENT_TOL, "v", floor=FLOOR)
    leaf_close(gs["params"], ws["params"],
               PARAM_TOL * float(want["step"]["lr"]), "params", absolute=True)


@pytest.mark.parametrize("arch", ["yi-6b", "phi-3-vision-4.2b"])
def test_sinusoidal_loss_matches_reference(arch):
    """C3: a dense and a VLM config with ``pos="sinusoidal"``, the table
    added after the patches."""
    got, want = port(arch, "sinusoidal"), reference(arch, "sinusoidal")
    near(got["loss"], want["loss"], LOSS_TOL, "loss")
    leaf_close(got["grads"], want["grads"], GRAD_TOL, "grads", floor=FLOOR)


def test_adamw_update_on_the_same_gradients():
    """The port's ``adamw_update`` and the reference's given the same
    params, gradients and a state at step 5 (past warm-up, moments
    non-zero): params, m and v to 1e-6 of their scale; the clip active
    (``grad_norm`` > ``clip_norm``)."""
    cfg, ref, rp, _, _ = setup("moonshot-v1-16b-a3b")
    r = rs("adamw")
    grads = jax.tree.map(lambda a: randn(r, *a.shape), rp)
    opt = {"m": jax.tree.map(lambda a: randn(r, *a.shape, scale=0.1), rp),
           "v": jax.tree.map(lambda a: np.abs(randn(r, *a.shape,
                                                    scale=0.01)), rp),
           "step": np.int32(5)}
    ocfg = RO.OptimizerConfig(**OPT)
    wp, wopt, wmet = RO.adamw_update(
        jax.tree.map(J, rp), jax.tree.map(J, grads),
        jax.tree.map(J, opt), ocfg)
    tp = port_params(cfg, rp)
    topt = {"m": port_params(cfg, opt["m"]), "v": port_params(cfg, opt["v"]),
            "step": torch.tensor(5, dtype=torch.int32)}
    gp, gopt, gmet = adamw_update(tp, port_params(cfg, grads), topt,
                                  OptimizerConfig(**OPT))
    assert gp is tp and gopt["m"] is topt["m"]       # in place
    assert float(gmet["grad_norm"]) > ocfg.clip_norm
    for k in ("lr", "grad_norm"):
        near(gmet[k], wmet[k], 1e-6, k)
    assert int(gopt["step"]) == 6
    leaf_close(gp, np_tree(wp), 1e-6, "params")
    leaf_close(gopt["m"], np_tree(wopt["m"]), 1e-6, "m")
    leaf_close(gopt["v"], np_tree(wopt["v"]), 1e-6, "v")


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b"])
def test_accum2_matches_reference(arch):
    """``accum=2`` against the reference's ``accum=2`` (loss, lr,
    grad_norm, new params), and against the port's own ``accum=1`` at
    the reference test's 1e-3 on the loss."""
    cfg, ref, rp, model, batch = setup(arch)
    jb = {k: J(v) for k, v in batch.items()}
    tb = {k: T(v) for k, v in batch.items()}
    ws, wm = jax.jit(RS.build_train_step(ref, RO.OptimizerConfig(**OPT),
                                         accum=2))(RS.init_train_state(rp), jb)
    gs, gm = build_train_step(model, OptimizerConfig(**OPT), accum=2)(
        init_train_state(port_params(cfg, rp)), tb)
    assert sorted(gm) == sorted(np_tree(wm)) == ["grad_norm", "loss", "lr"]
    for k in ("loss", "lr", "grad_norm"):
        near(gm[k], wm[k], LOSS_TOL, k)
    leaf_close(gs["params"], np_tree(ws["params"]),
               PARAM_TOL * float(wm["lr"]), "params", absolute=True)
    near(gm["loss"], port(arch)["step"]["loss"], 1e-3, "accum 1 vs 2")


# -- pieces ---------------------------------------------------------------------


@pytest.mark.parametrize("n_vocab", [0, 200], ids=["full", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce(dtype, n_vocab):
    """Ignored labels (-1) in every chunk, ``n_vocab`` below the padded
    vocab: the sum of NLL and the count of labelled tokens, and the
    gradients of h and the head, against the reference's; in bfloat16
    the gradients to 1e-2 of their scale, since the reference's backward
    of its bf16 product rounds the float32 cotangent to bf16 (2^-8) where
    the port's keeps it float32."""
    r = rs("ce", dtype, n_vocab)
    h, w = randn(r, 2, 48, 32), randn(r, 32, 256, scale=0.3)
    labels = r.randint(0, n_vocab or 256, (2, 48)).astype(np.int32)
    labels[:, ::5] = -1
    dt = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def ref_fn(h, w):
        return RT.chunked_ce(h.astype(dt[1]), w, J(labels), 16,
                             n_vocab=n_vocab)

    (tot, cnt), vjp = jax.vjp(ref_fn, J(h), J(w))
    gh_w, gw_w = vjp((jnp.float32(1.0), np.zeros((), jax.dtypes.float0)))
    th = T(h).requires_grad_()
    tw = T(w).requires_grad_()
    got_tot, got_cnt = TT.chunked_ce(th.to(dt[0]), tw, T(labels), 16,
                                     n_vocab)
    got_tot.backward()
    assert got_cnt.dtype == torch.int32 and int(got_cnt) == int(cnt)
    assert got_tot.dtype == torch.float32
    near(got_tot, tot, LOSS_TOL, "sum_nll")
    gtol = 1e-5 if dtype == "float32" else 1e-2
    leaf_close([th.grad], [np.asarray(gh_w)], gtol, "dh")
    leaf_close([tw.grad], [np.asarray(gw_w)], gtol, "dw")


@pytest.mark.parametrize("step", [0, 2, 9, 16, 40],
                         ids=["first", "warmup", "mid", "end", "past"])
def test_cosine_schedule(step):
    for kw in (OPT, {}):
        got = cosine_schedule(OptimizerConfig(**kw))(torch.tensor(step))
        want = RO.cosine_schedule(RO.OptimizerConfig(**kw))(jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == float(want), (kw, step)


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b",
                                  "mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-tiny", "phi-3-vision-4.2b"])
def test_decay_mask(arch):
    """The same leaves skip weight decay: the reference's names, from
    ``tree_flatten_with_path``, against the port's paths."""
    cfg = get_config(arch, smoke=True)
    ref_paths, _ = jax.tree_util.tree_flatten_with_path(
        ref_build(cfg).spec())
    want = [RO._decay_mask(p) for p, _ in ref_paths]
    got = [TO._decay_mask(p) for p in TO.leaf_paths(
        build_model(cfg, device="cpu").spec())]
    assert got == want
    assert not all(got) and any(got)


def test_init_train_state_rejects_16bit_store():
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="16-bit weight store"):
        init_train_state(init_params(model.spec(), 0, device="cpu",
                                     store=cfg.dtype))
    st = init_train_state(init_params(model.spec(), 0, device="cpu"))
    assert all(m.dtype == torch.float32 and not m.any()
               for m in tree_leaves(st["opt"]["m"]))
    # the compressed step's state (once a stub naming A11.5): per-device
    # float32 residuals stacked [n_dev, ...] beside the same AdamW state
    cst = TS.init_compressed_state(st["params"], 2)
    for p, r in zip(tree_leaves(st["params"]),
                    tree_leaves(cst["grad_residual"])):
        assert r.shape == (2, *p.shape) and r.dtype == torch.float32
        assert not r.any()
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2,), ("data",), devices=["cpu"] * 2)
    assert callable(TS.build_dp_compressed_step(model, OptimizerConfig(),
                                                mesh))


def test_split_micro():
    x = torch.arange(24).reshape(6, 4)
    got = TS._split_micro({"a": x, "b": [x[:, 0]]}, 3)
    want = RS._split_micro({"a": J(x.numpy()), "b": [J(x[:, 0].numpy())]}, 3)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- the training route ---------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_loss_fn_launches_no_kernel(arch, monkeypatch):
    """``loss_fn`` never reaches a kernel's wrapper (``fused_attention``,
    ``ssd_chunked``), each replaced by one that raises; serving still
    does (the smoke prompts of 40 tokens take attention's kernel branch
    and whole SSD chunks)."""
    cfg, _, rp, model, batch = setup(arch)
    tp = port_params(cfg, rp)
    calls = []

    def banned(name):
        def fn(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} on the training route")
        return fn
    monkeypatch.setattr(TL, "fused_attention", banned("fused_attention"))
    monkeypatch.setattr(TM, "ssd_chunked", banned("ssd_chunked"))
    tb = {k: T(v) for k, v in batch.items()}
    loss, _, _ = loss_and_grads(model, tp, tb)
    assert torch.isfinite(loss) and not calls
    kw = {k: tb[k] for k in ("patches", "frames") if k in tb}
    pre = cfg.n_patches if "patches" in kw else 0
    toks = tb["tokens"][:, :40]
    with pytest.raises(AssertionError, match="on the training route"):
        model.prefill_fn(tp, toks, pre + 48, **kw)
    assert calls


@pytest.mark.parametrize("window", [0, 20])
def test_chunked_attention_grads_match_reference(window):
    """Gradients of q, k and v through the rematerialized chunked
    attention, against ``jax.grad`` of the reference's, causal: with a
    20-key window over kv chunks of 16 the rows of the second query chunk
    from position 36 on see no key in the first kv chunk they visit; the
    gradients there are finite and equal the reference's."""
    r = rs("attn-grad", window)
    q, k, v = randn(r, 2, 64, 4, 8), randn(r, 2, 64, 2, 8), randn(r, 2, 64,
                                                                  2, 8)
    cot = randn(r, 2, 64, 4, 8)
    kw = dict(causal=True, window=window, q_chunk=32, kv_chunk=16,
              impl="triangular")

    def ref_loss(q, k, v):
        return jnp.sum(RL.chunked_attention(q, k, v, **kw) * J(cot))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(J(q), J(k), J(v))
    tq, tk, tv = (T(x).requires_grad_() for x in (q, k, v))
    (TL.chunked_attention(tq, tk, tv, **kw) * T(cot)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(g).all()
        leaf_close([g], [np.asarray(w)], 1e-5, "dqkv")
    # and the same gradients as materialized attention
    fq, fk, fv = (T(x).requires_grad_() for x in (q, k, v))
    (TL.full_attention(fq, fk, fv, causal=True, window=window)
     * T(cot)).sum().backward()
    for g, f in zip((tq.grad, tk.grad, tv.grad), (fq.grad, fk.grad, fv.grad)):
        leaf_close([g], [f.numpy()], 1e-5, "chunked vs full")


def test_rglru_train_scan_grads_match_associative_scan():
    """The out-of-place Hillis-Steele scan (with an h0) at 100 positions:
    values and gradients of a, b and h0 against ``jax.grad`` through the
    reference's ``associative_scan``; the in-place serving scan computes
    the same values but cannot be differentiated."""
    r = rs("scan-grad")
    a = np.abs(randn(r, 2, 100, 16)) % 1.0
    b, h0, cot = randn(r, 2, 100, 16), randn(r, 2, 16), randn(r, 2, 100, 16)

    def ref_loss(a, b, h0):
        return jnp.sum(RR._linear_scan(a, b, h0) * J(cot))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(J(a), J(b), J(h0))
    ta, tb, th = (T(x).requires_grad_() for x in (a, b, h0))
    h = TR._linear_scan_train(ta, tb, th)
    leaf_close([h], [np.asarray(RR._linear_scan(J(a), J(b), J(h0)))], 1e-5,
               "h")
    assert torch.equal(h, TR._linear_scan(ta, tb, th))
    (h * T(cot)).sum().backward()
    for g, w in zip((ta.grad, tb.grad, th.grad), want):
        leaf_close([g], [np.asarray(w)], 1e-5, "d(a, b, h0)")
    with pytest.raises(RuntimeError, match="inplace"):
        (TR._linear_scan(ta, tb, th) * T(cot)).sum().backward()


def test_ssd_chunk_scan_grads_finite_where_decay_overflows():
    """At mamba2-1.3b's full-width decay rates a chunk's cumulative log
    decay passes -88, so ``exp(cq_q - cq_k)`` above the diagonal is inf:
    the reference's chunk scan (mask after ``exp``) gets NaN gradients
    there, the port's (mask before it) finite ones, equal to the
    gradients of the step-by-step recurrence ``h_t = a_t h_{t-1} + u_t
    B_t``, ``y_t = C_t h_t`` in float64."""
    r = rs("ssd-overflow")
    b, nc, Q, nh, hp, N = 1, 2, 32, 2, 4, 8
    dlog = -np.abs(randn(r, b, nc, Q, nh)) * 6.0      # cum down to ~ -150
    cum = np.cumsum(dlog, axis=2).astype(np.float32)
    u = randn(r, b, nc, Q, nh, hp)
    Bm, Cm = randn(r, b, nc, Q, N), randn(r, b, nc, Q, N)
    cot = randn(r, b, nc, Q, nh, hp)
    assert cum.min() < -100

    tc, tu, tB, tC = (T(x).requires_grad_() for x in (cum, u, Bm, Cm))
    y, _ = TM._chunk_scan(tc, tu, tB, tC, torch.zeros(b, nh, hp, N))
    (y * T(cot)).sum().backward()
    got = [x.grad for x in (tc, tu, tB, tC)]
    assert all(torch.isfinite(g).all() for g in got)

    # float64 recurrence over positions (cum -> per-step log decay)
    xs = [T(x).double().requires_grad_() for x in (cum, u, Bm, Cm)]
    c64, u64, B64, C64 = xs
    ys, h = [], torch.zeros(b, nh, hp, N, dtype=torch.float64)
    for ci in range(nc):
        prev = torch.zeros(b, nh, dtype=torch.float64)
        for t in range(Q):
            a = torch.exp(c64[:, ci, t] - prev)
            prev = c64[:, ci, t]
            h = a[:, :, None, None] * h + torch.einsum(
                "bhp,bn->bhpn", u64[:, ci, t], B64[:, ci, t])
            ys.append(torch.einsum("bn,bhpn->bhp", C64[:, ci, t], h))
    y64 = torch.stack(ys, 1).reshape(b, nc, Q, nh, hp)
    assert torch.allclose(y.detach().double(), y64.detach(),
                          atol=1e-4 * float(y64.detach().abs().max()))
    (y64 * T(cot).double()).sum().backward()
    for g, w in zip(got, xs):
        leaf_close([g], [w.grad.float().numpy()], 1e-4, "d(cum, u, B, C)")

    # the reference's scan, through the same chunk views: NaN
    def ref_loss(cum, u, Bm, Cm):
        h = jnp.zeros((b, nh, hp, N))
        out = []
        for ci in range(nc):
            cq, uq, Bq, Cq = cum[:, ci], u[:, ci], Bm[:, ci], Cm[:, ci]
            gram = jnp.einsum("bqn,bkn->bqk", Cq, Bq)
            decay = cq[:, :, None, :] - cq[:, None, :, :]
            mask = jnp.tril(jnp.ones((Q, Q), bool))
            M = jnp.where(mask[None, :, :, None], jnp.exp(decay), 0.0) \
                * gram[..., None]
            out.append(jnp.einsum("bqkh,bkhp->bqhp", M, uq)
                       + jnp.einsum("bqn,bhpn,bqh->bqhp", Cq, h,
                                    jnp.exp(cq)))
            w_j = jnp.exp(cq[:, -1, None, :] - cq)
            h = jnp.exp(cq[:, -1, :])[:, :, None, None] * h + jnp.einsum(
                "bqh,bqhp,bqn->bhpn", w_j, uq, Bq)
        return jnp.sum(jnp.stack(out, 1) * J(cot))
    ref_g = jax.grad(ref_loss)(J(cum), J(u), J(Bm), J(Cm))
    assert not np.isfinite(np.asarray(ref_g)).all()


def test_ssd_train_route_matches_reference_apply_ssd():
    """``apply_ssd(..., train=True)`` (the chunk scan) against the
    reference's ``apply_ssd`` at 45 positions (two chunks, one padded),
    values and the gradient of x."""
    from repro.models import mamba2 as RM
    from test_torch_models import ssm_setup
    cfg, rp, tp, x = ssm_setup("train", 45)
    cot = randn(rs("ssd-cot"), 2, 45, cfg.d_model)
    want_y = RM.apply_ssd(rp, J(x), cfg)
    want_g = jax.grad(lambda x: jnp.sum(RM.apply_ssd(rp, x, cfg)
                                        * J(cot)))(J(x))
    tx = T(x).requires_grad_()
    y = TM.apply_ssd(tp, tx, cfg, train=True)
    leaf_close([y], [np.asarray(want_y)], 1e-5, "y")
    (y * T(cot)).sum().backward()
    leaf_close([tx.grad], [np.asarray(want_g)], 1e-4, "dx")


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` on the port: mamba2's smoke
    config (bf16 compute, float32 store), 15 steps on one batch of 4 x 64
    at lr 2e-3: the last loss under 0.8 of the first."""
    cfg = get_config("mamba2-1.3b", smoke=True)
    model = build_model(cfg, device="cpu")
    state = init_train_state(init_params(model.spec(), 0, device="cpu"))
    step = build_train_step(model, OptimizerConfig(lr=2e-3, warmup_steps=2,
                                                   total_steps=30))
    r = rs("decreases")
    batch = {k: T(r.randint(0, cfg.vocab, (4, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
