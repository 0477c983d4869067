"""The tensor-parallel mixers (CPU): ``mamba2.ssd_tp``/``ssd_decode_tp``
by head shard and ``rglru.rglru_tp``/``rglru_decode_tp`` by channel
shard, against the reference's ``apply_ssd``/``ssd_decode_step`` and
``apply_rglru``/``rglru_decode_step`` on one device, over model rows of
1, 2 and 4 CPU devices (the weights laid out by ``shardings_for``), from
zero state and from a carried one, in float32 within 1e-5 of the
output's scale; then the whole models on a (2, 4) data x model mesh over
``["cpu"] * 8`` against the reference's single-device models (prefill
and 4 decode steps: every logit row and every cache leaf after the
prefill and the last step, within 1e-5 of its scale): recurrentgemma
(RG-LRU by channel, local attention by head, a 32-slot ring that a
40-token prompt wraps) and whisper at 4 heads (head TP) and at 6 (which
do not split over 4: attention whole on the row's first device).  Then
the layout: the prefill cache's leaves carry ``spec_for``'s specs of
the cache spec (``heads3``/``mlp``/``cache_seq`` over ``model``), no
``ShardedTensor.gather`` reads a leaf split over ``model`` while
serving, and the dry run on a 2x4 mesh of fake devices announces one
``ssd_intra`` and two ``psum``s a device for each SSM layer and one
``linear_scan`` and two reduce-scatters for each RG-LRU layer.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.models import mamba2 as RM
from repro.models import rglru as RR
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (ShardedTensor,
                                              activation_hints, is_sharded,
                                              shardings_for, spec_for)
from repro_torch.launch import dryrun as D
from repro_torch.launch.fake import ShapeMode
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, model_cache_spec
from repro_torch.models import mamba2 as TM
from repro_torch.models import rglru as TR
from repro_torch.models.config import BlockKind, ShapeConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import is_leaf_spec, tree_leaves, tree_map
from test_torch_models import (J, T, leaves, randn, rs, seed_conv_taps,
                               ssm_setup)

TOL = 1e-5
MS = [1, 2, 4]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near(got, want, what=""):
    w = np.asarray(want, np.float32)
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max())
    assert err <= TOL * max(1.0, float(np.abs(w).max())), (what, err)


def row(spec, tp, M):
    """The mixer's params laid out on a 1 x M mesh over ``["cpu"] * M``
    and the row's devices."""
    mesh = make_host_mesh((1, M), devices=["cpu"] * M)
    return (tree_map(lambda x, sh: sh.place(x), tp,
                     shardings_for(spec, mesh)), list(mesh.devices[0]))


# -- the SSD by head shard --------------------------------------------------


def heads(x, M):
    """``x`` [B, nh, ...] split into M head blocks."""
    return list(torch.tensor(np.asarray(x)).chunk(M, 1))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("S", [64, 45], ids=["chunks", "padded"])
def test_ssd_tp(M, S):
    cfg, rp, tp, x = ssm_setup(("tp", S), S)
    p, devs = row(TM.mamba2_spec(cfg), tp, M)
    outs, states = TM.ssd_tp(p, [T(x)] * M, cfg, devs, return_state=True)
    want, st = RM.apply_ssd(rp, J(x), cfg, return_state=True)
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["ssm"] for s in states], 1), st["ssm"], "ssm")
    for s in states:
        near(s["conv"], st["conv"], "conv")


@pytest.mark.parametrize("M", MS)
def test_ssd_tp_from_state(M):
    cfg, rp, tp, x = ssm_setup("tp-state0", 40)
    _, st0 = RM.apply_ssd(rp, J(x[:, :24]), cfg, return_state=True)
    p, devs = row(TM.mamba2_spec(cfg), tp, M)
    state0s = [{"ssm": h, "conv": T(st0["conv"])}
               for h in heads(st0["ssm"], M)]
    outs, states = TM.ssd_tp(p, [T(x[:, 24:])] * M, cfg, devs,
                             state0s=state0s, return_state=True)
    want, st = RM.apply_ssd(rp, J(x[:, 24:]), cfg, state0=st0,
                            return_state=True)
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["ssm"] for s in states], 1), st["ssm"], "ssm")
    near(states[-1]["conv"], st["conv"], "conv")


@pytest.mark.parametrize("M", MS)
def test_ssd_decode_tp(M):
    cfg, rp, tp, x = ssm_setup("tp-step", 1)
    di, nh, hp, N = TM.dims(cfg)
    r = rs("tp-step-state")
    ssm, conv = randn(r, 2, nh, hp, N), randn(r, 2, 3, di + 2 * N)
    p, devs = row(TM.mamba2_spec(cfg), tp, M)
    outs, new = TM.ssd_decode_tp(p, [T(x)] * M, cfg, devs, [
        {"ssm": h, "conv": T(conv)} for h in heads(ssm, M)])
    want, st = RM.ssd_decode_step(rp, J(x), cfg, {"ssm": J(ssm),
                                                  "conv": J(conv)})
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["ssm"] for s in new], 1), st["ssm"], "ssm")
    for s in new:
        near(s["conv"], st["conv"], "conv")


# -- the RG-LRU by channel shard ----------------------------------------------


def rglru_setup(salt, S):
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              dtype="float32")
    rp = ref_init(RR.rglru_spec(cfg), jax.random.PRNGKey(0))
    r = rs("rglru-tp", salt)
    for k in ("conv_w", "conv_b"):
        rp[k] = J(randn(r, *np.asarray(rp[k]).shape, scale=0.5))
    tp = jax.tree.map(lambda a: T(np.asarray(a)), rp)
    return cfg, rp, tp, randn(r, 2, S, cfg.d_model)


def channels(x, M):
    return list(torch.tensor(np.asarray(x)).chunk(M, -1))


@pytest.mark.parametrize("M", MS)
def test_rglru_tp(M):
    cfg, rp, tp, x = rglru_setup("seq", 37)
    p, devs = row(TR.rglru_spec(cfg), tp, M)
    outs, states = TR.rglru_tp(p, [T(x)] * M, cfg, devs, return_state=True)
    want, (h, conv) = RR.apply_rglru(rp, J(x), cfg, return_state=True)
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["h"] for s in states], -1), h, "h")
    near(torch.cat([s["conv"] for s in states], -1), conv, "conv")


@pytest.mark.parametrize("M", MS)
def test_rglru_tp_from_state(M):
    cfg, rp, tp, x = rglru_setup("state0", 30)
    _, (h0, conv0) = RR.apply_rglru(rp, J(x[:, :18]), cfg, return_state=True)
    p, devs = row(TR.rglru_spec(cfg), tp, M)
    state0s = [{"h": a, "conv": b} for a, b in zip(channels(h0, M),
                                                    channels(conv0, M))]
    outs, states = TR.rglru_tp(p, [T(x[:, 18:])] * M, cfg, devs,
                               state0s=state0s, return_state=True)
    want, (h, conv) = RR.apply_rglru(rp, J(x[:, 18:]), cfg, h0=h0,
                                     conv0=conv0, return_state=True)
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["h"] for s in states], -1), h, "h")
    near(torch.cat([s["conv"] for s in states], -1), conv, "conv")


@pytest.mark.parametrize("M", MS)
def test_rglru_decode_tp(M):
    cfg, rp, tp, x = rglru_setup("step", 1)
    r = rs("rglru-tp-state")
    h = randn(r, 2, cfg.d_model)
    conv = randn(r, 2, cfg.rglru_conv_width - 1, cfg.d_model)
    p, devs = row(TR.rglru_spec(cfg), tp, M)
    outs, new = TR.rglru_decode_tp(p, [T(x)] * M, cfg, devs, [
        {"h": a, "conv": b} for a, b in zip(channels(h, M),
                                            channels(conv, M))])
    want, (h1, conv1) = RR.rglru_decode_step(rp, J(x), cfg, (J(h), J(conv)))
    for o in outs:
        near(o, want, "y")
    near(torch.cat([s["h"] for s in new], -1), h1, "h")
    near(torch.cat([s["conv"] for s in new], -1), conv1, "conv")


# -- whole models on a (2, 4) mesh against the reference ------------------------

B, S, STEPS, MAX_LEN = 4, 40, 4, 48
WHISPER6 = dict(n_heads=6, n_kv_heads=6)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


def setup(arch, **overrides):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **overrides)
    rp = ref_init(ref_build(cfg).spec(), jax.random.PRNGKey(0))
    seed_conv_taps(rp, rs("mixer-tp-conv", arch))
    r = rs("mixer-tp", arch, tuple(overrides))
    toks = r.randint(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    extra = ({"frames": randn(r, B, cfg.enc_seq, cfg.d_model, scale=0.02)}
             if cfg.family == "encdec" else {})
    return cfg, rp, toks, extra


def mesh_models(cfg, mesh, rp):
    pre = build_model(cfg, activation_hints(cfg, mesh, B, "prefill"),
                      device="cpu")
    dec = build_model(cfg, activation_hints(cfg, mesh, B, "decode"),
                      device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    params = tree_map(lambda x, sh: sh.place(x), tp,
                      shardings_for(pre.spec(), mesh))
    return pre, dec, params


def gathered(cache):
    return tree_map(lambda x: x.gather("cpu"), cache, is_leaf=is_sharded)


def serve(pre, dec, params, toks, extra, A):
    """Logits after the prefill and each decode step, then the cache's
    (key, leaf) pairs in one order for both packages (``leaves``), after
    the prefill and after the last step, each copied as it is made."""
    kw = {k: A(v) for k, v in extra.items()}
    logits, cache = pre.prefill_fn(params, A(toks[:, :S]), MAX_LEN, **kw)
    out = [np.array(logits, np.float32)]

    def snap(c):
        if A is T:
            c = tree_map(lambda x: x.gather("cpu"), c, is_leaf=is_sharded)
        return [(k, np.array(v, copy=True)) for k, v in leaves(c)]
    caches = snap(cache)
    for i in range(STEPS):
        logits, cache = dec.decode_fn(params, A(toks[:, S + i]), cache)
        out.append(np.array(logits, np.float32))
    return out, caches + snap(cache)


@pytest.mark.parametrize("arch,overrides", [
    ("recurrentgemma-9b", {}), ("whisper-tiny", {}),
    ("whisper-tiny", WHISPER6)], ids=["recurrentgemma", "whisper-head-tp",
                                      "whisper-6-heads"])
def test_mesh_model_equals_reference(arch, overrides, mesh):
    cfg, rp, toks, extra = setup(arch, **overrides)
    ref = ref_build(cfg)
    want, want_c = serve(ref, ref, rp, toks, extra, J)
    pre, dec, params = mesh_models(cfg, mesh, rp)
    got, got_c = serve(pre, dec, params, toks, extra, T)
    for g, w in zip(got, want):
        near(g, w, "logits")
    assert [k for k, _ in got_c] == [k for k, _ in want_c]
    for (k, g), (_, w) in zip(got_c, want_c):
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), k
        else:
            near(g, w, k)


def test_more_model_devices_than_heads():
    """whisper's 6 heads on a 1 x 8 mesh: the split cache's decode gives
    devices without a head an empty range of the output's rows (a zero
    partial); prefill and 2 decode steps equal the port's single device
    within 1e-5 of the scale."""
    cfg, rp, toks, extra = setup("whisper-tiny", **WHISPER6)
    mesh = make_host_mesh((1, 8), devices=["cpu"] * 8)
    pre, dec, params = mesh_models(cfg, mesh, rp)
    single = build_model(cfg, device="cpu")
    p0 = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    fr = {"frames": T(extra["frames"])}
    want, c0 = single.prefill_fn(p0, T(toks[:, :S]), MAX_LEN, **fr)
    got, c1 = pre.prefill_fn(params, T(toks[:, :S]), MAX_LEN, **fr)
    near(got, want.numpy())
    for i in range(2):
        want, c0 = single.decode_fn(p0, T(toks[:, S + i]), c0)
        got, c1 = dec.decode_fn(params, T(toks[:, S + i]), c1)
        near(got, want.numpy())


# -- the layout ---------------------------------------------------------------

LAYOUT_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny"]


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_prefill_cache_carries_the_reference_specs(arch, mesh):
    """Every cache leaf's layout is ``spec_for``'s of the cache spec, and
    the SSM state (``heads3``), the RG-LRU state (``mlp``) and the K/V
    (``cache_seq``) are split over ``model``."""
    cfg, rp, toks, extra = setup(arch)
    pre, _, params = mesh_models(cfg, mesh, rp)
    _, cache = pre.prefill_fn(params, T(toks[:, :S]), MAX_LEN,
                              **{k: T(v) for k, v in extra.items()})
    got = tree_leaves(cache, is_sharded)
    want = tree_leaves(model_cache_spec(cfg, B, MAX_LEN), is_leaf_spec)
    assert len(got) == len(want)
    split = set()
    for g, s in zip(got, want):
        assert tuple(g.shape) == s.shape
        assert tuple(g.sharding.spec) == tuple(spec_for(s.shape, s.axes,
                                                        mesh)), s.axes
        if "model" in g.sharding.spec:
            split.update(a for a in s.axes if a in ("heads3", "mlp",
                                                    "cache_seq"))
    assert split == {"mamba2-1.3b": {"heads3"},
                     "recurrentgemma-9b": {"mlp"},
                     "whisper-tiny": {"cache_seq"}}[arch]


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_serving_gathers_no_model_split_leaf(arch, mesh, monkeypatch):
    """Prefill and two decode steps read every leaf split over ``model``
    a piece at a time: ``ShardedTensor.gather`` (a whole leaf on one
    device) meets only leaves that ``model`` does not split."""
    cfg, rp, toks, extra = setup(arch)
    pre, dec, params = mesh_models(cfg, mesh, rp)
    seen = []
    gather = ShardedTensor.gather

    def spy(self, device):
        seen.append(tuple(self.sharding.spec))
        return gather(self, device)
    monkeypatch.setattr(ShardedTensor, "gather", spy)
    _, cache = pre.prefill_fn(params, T(toks[:, :S]), MAX_LEN,
                              **{k: T(v) for k, v in extra.items()})
    for i in range(2):
        _, cache = dec.decode_fn(params, T(toks[:, S + i]), cache)
    assert seen and not [s for s in seen if "model" in s]


# -- the dry run's records on a 2x4 mesh of fake devices -----------------------


@pytest.mark.parametrize("arch,kind", [("mamba2-1.3b", BlockKind.SSM),
                                       ("recurrentgemma-9b",
                                        BlockKind.RECURRENT)])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dry_run_announces_the_shards(arch, kind, shape):
    """Each of the 8 devices runs one ``ssd_intra`` (SSM prefill) or
    ``linear_scan`` (RG-LRU prefill) a layer on its shard, and each
    layer sums over ``model``: two all-reduces a device an SSM layer (the
    norm's squares, the output rows), and an RG-LRU layer two
    reduce-scatters (the gates) and an all-reduce (the output rows).  In
    the prefill the smoke configs' residual is sequence-parallel, so the
    output rows are reduce-scattered onto the sequence shards instead:
    an SSM layer one all-reduce and one reduce-scatter, an RG-LRU layer
    three reduce-scatters."""
    cfg = get_config(arch, smoke=True)
    n = sum(k == kind for k in cfg.block_kinds())
    mesh = make_host_mesh((2, 4), devices=D.fake_devices(8))
    sh = ShapeConfig(shape, 64, 8, "prefill" if shape == "prefill_32k"
                     else "decode")
    with ShapeMode():
        fn, args, meta = D.build_cell(arch, shape, mesh, cfg=cfg, shape=sh)
        _, det = D.run_cell(fn, args, meta, mesh, "", "")
    rows = det["per_device"]
    assert len(rows) == 8
    kernel = "ssd_intra" if kind == BlockKind.SSM else "linear_scan"
    for r in rows:
        coll = {k: c["count"] for k, c in r["collectives"].items()}
        assert r["kernels"].get(kernel, 0) == (n if sh.kind == "prefill"
                                               else 0), r["kernels"]
        if sh.kind == "prefill":
            assert coll.get("all-reduce", 0) == (
                n if kind == BlockKind.SSM else 0)
            assert coll["reduce-scatter"] >= (
                n if kind == BlockKind.SSM else 3 * n)
        elif kind == BlockKind.SSM:
            assert coll["all-reduce"] >= 2 * n
        else:
            assert coll["reduce-scatter"] == 2 * n
            assert coll["all-reduce"] >= n
