"""Sequence-parallel residuals, the vocab-parallel loss and collectives
whose backward is the transposed collective (CPU).

* every ``distributed.spmd`` collective's gradient equals autograd's
  through plain copies and sums, exactly in float64 (integer-valued
  inputs and weights: every sum is exact, in any order), over four
  positions of one device (each position its own gradient slot) with
  uneven parts where the collective allows them;
* under a ``Recorder`` on four fake devices each backward is announced
  as the transposed collective and records no ``copy`` op;
* every train and prefill block of a sequence-parallel config on a 2x4
  mesh of ``[cpu] * 8`` holds ``split_range(S, M, j)`` rows on model
  index ``j`` (the reference's ``activation_hints(...).specs
  ["residual"]`` splits dim 1 over ``model``; the port splits unevenly
  where the reference pads), S 64 and S 30 (which 4 does not divide);
* ``chunked_ce_tp`` equals the reference's ``chunked_ce`` within 1e-5
  relative in float32 (padded vocab, -1 labels, tied and untied heads,
  vocab 53 over 3 and 4 model devices, with and without the sequence
  split, evenly and not), and its gradients equal the port's single-device
  ``chunked_ce``'s within 1e-5 of their scale; the mesh models' loss
  (yi-6b untied, mamba2-1.3b and whisper-tiny tied, each vocab padded
  past a multiple of 4) equals the reference's ``loss_fn`` through
  ``params_from_reference`` within 1e-5 relative;
* each sequence-parallel family's loss, gradients, prefill logits and 4
  decode steps on the mesh equal the port's single device within 1e-5
  of their scale in float32, at S 64 and at S 30 (uneven shards), and
  so do two configs that keep the whole residual (recurrentgemma-9b's
  own layout, yi-6b with ``seq_parallel`` off).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import sharding as RSH
from repro.models import build_model as ref_build
from repro.models.layers import NO_HINTS as REF_NO_HINTS
from repro.models.transformer import chunked_ce as ref_chunked_ce
from repro_torch.configs import get_config
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import activation_hints
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch.fake import ShapeMode
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TR
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import split_range
from repro_torch.models.params import tree_leaves
from repro_torch.train import loss_and_grads
from test_torch_lm_sharding import (gathered, place, ref_params, scale_of,
                                    token_batch)
from test_torch_models import rs
from test_torch_sharding import FakeMesh

CPU4 = [torch.device("cpu")] * 4
FAKE4 = [torch.device("meta", i) for i in range(4)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


# -- the collectives' backward ------------------------------------------------


def _plain_bounds(sizes):
    ends = np.cumsum(sizes)
    return [(int(e - s), int(e)) for s, e in zip(sizes, ends)]


def plain_psum(xs):
    return [sum(x for x in xs) for _ in xs]


def plain_all_gather(xs, dim):
    return [torch.cat(list(xs), dim) for _ in xs]


def plain_psum_scatter(xs, dim, sizes):
    return [sum(x.narrow(dim, lo, hi - lo) for x in xs)
            for lo, hi in _plain_bounds(sizes)]


def plain_all_to_all(xs, s, c):
    n = len(xs)
    ch = [torch.chunk(x, n, s) for x in xs]
    return [torch.cat([ch[i][j] for i in range(n)], c) for j in range(n)]


def plain_ppermute(xs, perm):
    src = {d: s for s, d in perm}
    return [xs[src[i]] * 1 if i in src else torch.zeros_like(xs[i])
            for i in range(len(xs))]


PERM = [(0, 2), (2, 1), (1, 0)]     # position 3 neither sends nor receives
CASES = {
    # name: (input shapes, spmd call, plain call)
    "psum": ([(3, 5)] * 4, lambda xs, d: spmd.psum(xs, d), plain_psum),
    "all_gather_uneven": (
        [(2, 1, 3), (2, 0, 3), (2, 2, 3), (2, 4, 3)],
        lambda xs, d: spmd.all_gather(xs, 1, d),
        lambda xs: plain_all_gather(xs, 1)),
    "psum_scatter": ([(2, 30, 3)] * 4,
                     lambda xs, d: spmd.psum_scatter(xs, 1, d),
                     lambda xs: plain_psum_scatter(xs, 1, [7, 8, 7, 8])),
    "psum_scatter_sizes": (
        [(5, 9)] * 4, lambda xs, d: spmd.psum_scatter(xs, -1, d,
                                                      [0, 4, 2, 3]),
        lambda xs: plain_psum_scatter(xs, -1, [0, 4, 2, 3])),
    "all_to_all": ([(8, 6)] * 4, lambda xs, d: spmd.all_to_all(xs, 0, 1, d),
                   lambda xs: plain_all_to_all(xs, 0, 1)),
    "ppermute": ([(3, 4)] * 4, lambda xs, d: spmd.ppermute(xs, PERM, d),
                 lambda xs: plain_ppermute(xs, PERM)),
}
TRANSPOSED = {"psum": ("all-reduce", "all-reduce"),
              "all_gather_uneven": ("all-gather", "reduce-scatter"),
              "psum_scatter": ("reduce-scatter", "all-gather"),
              "psum_scatter_sizes": ("reduce-scatter", "all-gather"),
              "all_to_all": ("all-to-all", "all-to-all"),
              "ppermute": ("collective-permute", "collective-permute")}


def _ints(r, shape):
    return torch.from_numpy(r.randint(-4, 5, shape).astype(np.float64))


@pytest.mark.parametrize("name", list(CASES))
def test_collective_gradient_equals_plain_autograd(name):
    shapes, run, plain = CASES[name]
    r = rs("sp-collective", name)
    xs = [_ints(r, s).requires_grad_() for s in shapes]
    xp = [x.detach().clone().requires_grad_() for x in xs]
    got = run(xs, CPU4)
    want = plain(xp)
    ws = [_ints(r, tuple(w.shape)) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # each position its own tensor, even where the device repeats
    assert len({id(g) for g in got}) == len(got)
    gx = torch.autograd.grad(sum((g * w).sum() for g, w in zip(got, ws)),
                             xs)
    gp = torch.autograd.grad(sum((g * w).sum() for g, w in zip(want, ws)),
                             xp, allow_unused=True)
    for a, b, x in zip(gx, gp, xp):
        b = torch.zeros_like(x) if b is None else b   # sends nothing
        assert a.dtype == torch.float64 and torch.equal(a, b), name


@pytest.mark.parametrize("name", list(CASES))
def test_backward_is_announced_as_the_transposed_collective(name):
    shapes, run, _ = CASES[name]
    fwd, bwd = TRANSPOSED[name]
    with ShapeMode() as mode:
        xs = [torch.empty(s, dtype=torch.float32, device=d).requires_grad_()
              for s, d in zip(shapes, FAKE4)]
        rec = TH.Recorder(devices=FAKE4)
        with rec.feeding(mode):
            out = run(xs, FAKE4)
        kinds = {k for _, k, _ in rec.coll}
        assert kinds == {fwd}, kinds
        back = TH.Recorder(devices=FAKE4)
        with back.feeding(mode):
            torch.autograd.grad(out, xs, [torch.ones_like(o) for o in out],
                                allow_unused=True)
    kinds = {k for _, k, _ in back.coll}
    assert kinds == {bwd}, kinds
    assert back.backward_copies == 0
    assert all(k != "copy" for _, k, _ in back.coll)


def test_pmax_is_detached():
    xs = [torch.randn(3, requires_grad=True) for _ in range(4)]
    out = spmd.pmax(xs, CPU4)
    assert not any(o.requires_grad for o in out)
    assert torch.equal(out[0], torch.stack([x.detach() for x in xs]).amax(0))


# -- the residual's layout ----------------------------------------------------


def _spy(monkeypatch, module, name, grab):
    """Wrap ``module.name`` to hand its output to ``grab``."""
    fn = getattr(module, name)

    def run(*a, **k):
        out = fn(*a, **k)
        grab(out)
        return out
    monkeypatch.setattr(module, name, run)


LAYOUT = {   # arch: the function whose output is a block's residual
    "yi-6b": (TR, "_block_sharded"),
    "moonshot-v1-16b-a3b": (TR, "_block_sharded"),
    "mamba2-1.3b": (TR, "_block_sharded"),
    "phi-3-vision-4.2b": (TR, "_block_sharded"),
    "whisper-tiny": (ED, "_mlp_rows"),
}


@pytest.mark.parametrize("S", [64, 30], ids=["even", "uneven"])
@pytest.mark.parametrize("arch", list(LAYOUT))
def test_blocks_hold_their_sequence_shard(arch, S, mesh, monkeypatch):
    """Every block's output, in the loss (train) and the prefill, holds
    ``split_range(S, M, j)`` rows on model index ``j`` (S counts the
    VLM's patches; whisper's encoder blocks hold their shard of the
    encoder's frames)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", logit_chunk=S // 2)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_seq=S + 6)
    B = 4
    M = mesh.shape["model"]
    spec = RSH.activation_hints(cfg, FakeMesh(dict(mesh.shape)), B,
                                "train").specs["residual"]
    assert tuple(spec)[1:] == ("model", None)
    rows = []
    module, name = LAYOUT[arch]
    _spy(monkeypatch, module, name, lambda out: rows.append(
        out[0] if name == "_block_sharded" else out))
    p0 = params_from_reference(ref_params(cfg, "layout"), cfg, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in token_batch(cfg, B, S, "layout").items()}
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    for kind in ("train", "prefill"):
        hints = activation_hints(cfg, mesh, B, kind)
        assert hints.seq_parallel()
        model = build_model(cfg, hints, device="cpu")
        params = place(p0, model.spec(), mesh)
        rows.clear()
        if kind == "train":
            model.loss_fn(params, batch)
        else:
            model.prefill_fn(params, batch["tokens"], S + 8, **extra)
        assert rows, (arch, kind)
        seqs = [S] if cfg.family != "encdec" else [S, cfg.enc_seq]
        for H in rows:
            assert len(H) == 2 and all(len(row) == M for row in H)
            n = sum(h.shape[1] for h in H[0])
            assert n in seqs, (arch, kind, n)
            for row in H:
                assert [h.shape[1] for h in row] == [
                    hi - lo for lo, hi in (split_range(n, M, j)
                                           for j in range(M))]


def test_recurrentgemma_keeps_the_whole_residual(mesh, monkeypatch):
    """recurrentgemma-9b turns sequence parallelism off: its blocks hold
    the whole sequence on every device, as before."""
    cfg = get_config("recurrentgemma-9b")
    assert not activation_hints(cfg, mesh, 4, "prefill").seq_parallel()
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              dtype="float32", seq_parallel=False)
    rows = []
    _spy(monkeypatch, TR, "_block_sharded", lambda out: rows.append(out[0]))
    model = build_model(cfg, activation_hints(cfg, mesh, 4, "prefill"),
                        device="cpu")
    p0 = params_from_reference(ref_params(cfg, "layout"), cfg, "cpu")
    toks = torch.from_numpy(token_batch(cfg, 4, 40, "rg")["tokens"])
    model.prefill_fn(place(p0, model.spec(), mesh), toks, 48)
    assert rows and all(h.shape[1] == 40 for H in rows for row in H
                        for h in row)


# -- the vocab-parallel loss --------------------------------------------------


@pytest.mark.parametrize("split", ["seq", "whole", "uneven"])
@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
@pytest.mark.parametrize("M", [3, 4])
def test_vocab_parallel_ce_equals_reference(M, tied, split):
    """h [2, 24, 16], vocab 53 padded to 64 (3 does not divide it), a
    third of the labels -1, chunks of 8; ``uneven``: 26 positions in
    chunks of 13, split 8/9/9 or 6/7/6/7 (each chunk's rows on two or
    three shards)."""
    sp = split != "whole"
    r = rs("sp-ce", M, tied, split if split == "uneven" else sp)
    B, S, d, V, n_vocab, chunk = 2, 24, 16, 64, 53, 8
    if split == "uneven":
        S, chunk = 26, 13
    h = r.standard_normal((B, S, d)).astype(np.float32)
    w = (r.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = r.randint(0, n_vocab, (B, S)).astype(np.int32)
    labels[:, ::3] = -1
    tot_r, cnt_r = ref_chunked_ce(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(labels), chunk, REF_NO_HINTS,
                                  n_vocab)
    devs = CPU4[:1] * M
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    head = wt.T if tied else wt     # the tied embedding is [V, d]
    H = ([ht[:, lo:hi] for lo, hi in (split_range(S, M, j)
                                      for j in range(M))]
         if sp else [ht] * M)
    lt = torch.from_numpy(labels)
    tot, cnt = TR.chunked_ce_tp(H, head, [lt] * M, chunk, n_vocab, devs,
                                tied, sp)
    assert int(cnt) == int(cnt_r)
    assert abs(float(tot.detach()) - float(tot_r)) <= 1e-5 * abs(
        float(tot_r))
    gh, gw = torch.autograd.grad(tot, [ht, wt])
    h0 = ht.detach().clone().requires_grad_()
    w0 = wt.detach().clone().requires_grad_()
    t0, _ = TR.chunked_ce(h0, w0, lt, chunk, n_vocab)
    gh0, gw0 = torch.autograd.grad(t0, [h0, w0])
    for a, b in ((gh, gh0), (gw, gw0)):
        assert float((a - b).abs().max()) <= 1e-5 * scale_of(b)
    assert not gw[:, n_vocab:].any()


LOSS_ARCHS = {   # arch: overrides (a padded vocab 4 does not divide)
    "yi-6b": {"vocab_pad": 5},                  # untied head
    "mamba2-1.3b": {"vocab_pad": 3},            # tied embedding
    "whisper-tiny": {"vocab_pad": 7},           # tied, enc-dec
}


@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_mesh_loss_equals_reference(arch, mesh):
    """The mesh model's loss (vocab-parallel, the sequence split) with the
    weights carried by ``params_from_reference`` equals the reference's
    single-device ``loss_fn`` within 1e-5 relative in float32; the label
    counts equal."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **LOSS_ARCHS[arch])
    assert cfg.padded_vocab() % mesh.shape["model"]
    rp = ref_params(cfg, "ce")
    batch = token_batch(cfg, 4, 32, "ce")
    want, wmet = ref_build(cfg).loss_fn(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg, activation_hints(cfg, mesh, 4, "train"),
                        device="cpu")
    params = place(params_from_reference(rp, cfg, "cpu"), model.spec(),
                   mesh)
    got, met = model.loss_fn(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert int(met["tokens"]) == int(wmet["tokens"])
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))


# -- each family on the mesh vs the single device -----------------------------


UNEVEN = {"logit_chunk": 10}     # S 30: chunks straddle the shards


def _family(arch, S=64, **overrides):
    return pytest.param(arch, S, overrides, id=arch if S == 64 and not any(
        k in overrides for k in ("seq_parallel", "enc_seq")) else
        f"{arch}-{'whole' if overrides.get('seq_parallel') is False else S}")


FAMILIES = [   # (arch, positions, config overrides)
    _family("yi-6b"),
    _family("qwen2-7b"),
    _family("moonshot-v1-16b-a3b", capacity_factor=8.0),   # nothing drops
    _family("mamba2-1.3b"),
    _family("whisper-tiny"),
    _family("phi-3-vision-4.2b"),
    # S 30 over model 4: shards of 7, 8, 7, 8 rows (the prompt's 26 of 6,
    # 7, 6, 7; whisper's 30 frames too), where the reference pads
    _family("yi-6b", 30, **UNEVEN),
    _family("moonshot-v1-16b-a3b", 30, capacity_factor=8.0, **UNEVEN),
    _family("mamba2-1.3b", 30, **UNEVEN),
    _family("whisper-tiny", 30, enc_seq=30, **UNEVEN),
    _family("phi-3-vision-4.2b", 30, **UNEVEN),
    # the whole residual on every device of a row: recurrentgemma-9b's
    # own layout, and yi's with the split turned off
    _family("recurrentgemma-9b", seq_parallel=False),
    _family("yi-6b", seq_parallel=False),
]


def _serve(model, params, batch, S, steps=4):
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    toks = batch["tokens"]
    St = toks.shape[1] - steps
    logits, cache = model.prefill_fn(params, toks[:, :St], S + 8, **extra)
    out = [logits]
    for i in range(steps):
        logits, cache = model.decode_fn(params, toks[:, St + i], cache)
        out.append(logits)
    return out


@pytest.mark.parametrize("arch, S, overrides", FAMILIES)
def test_family_on_the_mesh_equals_single_device(arch, S, overrides, mesh):
    """B 4, ``S`` positions (the VLM's patches among them; the prompt all
    but the last 4 tokens, which the decode steps take): loss, every
    gradient leaf (within 1e-5 of its own scale or of 1e-3 of the
    largest, where that is more), prefill logits and 4 decode steps."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **overrides)
    B = 4
    p0 = params_from_reference(ref_params(cfg, "sp-family"), cfg, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in token_batch(cfg, B, S, "sp-family").items()}
    single = build_model(cfg, device="cpu")
    l0, m0, g0 = loss_and_grads(single, p0, batch)
    want = _serve(single, p0, batch, S)
    model = build_model(cfg, activation_hints(cfg, mesh, B, "train"),
                        device="cpu")
    assert model.hints.seq_parallel() == cfg.seq_parallel
    params = place(p0, model.spec(), mesh)
    l1, m1, g1 = loss_and_grads(model, params, batch)
    assert abs(float(l1) - float(l0)) <= 1e-5 * scale_of(l0)
    assert int(m1["tokens"]) == int(m0["tokens"])
    g0l, g1l = tree_leaves(g0), tree_leaves(gathered(g1))
    top = max(float(g.abs().max()) for g in g0l)
    for a, b in zip(g1l, g0l):
        tol = 1e-5 * max(float(b.abs().max()), 1e-3 * top)
        assert float((a - b).abs().max()) <= tol, arch
    pre = build_model(cfg, activation_hints(cfg, mesh, B, "prefill"),
                      device="cpu")
    got = _serve(pre, params, batch, S)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale_of(w), arch
