"""The port's enc-dec model (``models/encdec.py``) vs the reference's
(CPU), piece by piece: the sinusoidal table, the param and cache specs,
one encoder layer, the cross-attention K/V and block, and one decoder
layer with the cache it collects and a decode step against it, in
float32 at 1e-5 on whisper-tiny's smoke config.  The whole model
(prefill and three decode steps, f32 and bf16, the 16-bit store) is
held in ``tests/test_torch_models.py``.  Inputs come from a numpy seed;
the reference's params are carried across with
``params_from_reference``, every leaf moved off its init (zero biases,
unit norm scales) so that each takes part.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import encdec as RE
from repro.models import init_params as ref_init
from repro.models import layers as RL
from repro.models.params import LeafSpec as RefLeafSpec
from repro_torch.configs import get_config
from repro_torch.models import (build_model, init_params, model_cache_spec,
                                param_count)
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import is_leaf_spec, tree_leaves
from test_torch_models import J, T, close, f32, leaves, randn, ref_fields, rs

ARCH = "whisper-tiny"


@pytest.mark.parametrize("seq,d", [(16, 64), (48, 64), (449, 384),
                                   (1501, 384)])
def test_sinusoidal_table(seq, d):
    """Same formula in float32.  The two packages' ``exp`` round some
    frequencies to neighbouring floats (XLA's is not correctly rounded:
    19 of whisper's 192 differ from the float64 value rounded, torch's
    2), and a frequency one float32 ulp off (at most 2^-23, since each
    is <= 1) moves the angle at position p by up to p * 2^-23.  So the
    bound is 1e-6 plus that at the last position: 1.9e-6 at 16
    positions, 1.8e-4 at whisper's 1501."""
    got = TL.sinusoidal_table(seq, d, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    close(got, RL.sinusoidal_table(seq, d), tol=1e-6 + seq * 2.0 ** -23)


@pytest.mark.parametrize("positions", [[0], [5, 0, 447], [1500, 3, 3]])
def test_sinusoidal_rows_are_the_tables(positions):
    """The decode step's rows, computed at its positions, are bit-equal
    to the table's rows there."""
    at = torch.tensor(positions, dtype=torch.int32)
    got = TL.sinusoidal_rows(at, 384)
    assert torch.equal(got, TL.sinusoidal_table(1501, 384, "cpu")[at.long()])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_encdec_specs_match_reference(smoke):
    """Shapes, dtypes and axes of every param and cache leaf.  The full
    spec holds 36,484,608 parameters: the analytic count of whisper-tiny
    (``ArchConfig.param_count``, 36,439,296) plus the 45,312 it leaves
    out (the 7 pad rows of the 51,872-row embedding, every bias,
    every layernorm's offset and ``enc_norm``'s scale).  The embedding
    may be held in bf16 by the 16-bit store."""
    cfg, rcfg = get_config(ARCH, smoke), ref_config(ARCH, smoke)

    def fields(tree):
        return [ref_fields(s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, RefLeafSpec))]

    spec = build_model(cfg, device="cpu").spec()
    assert isinstance(build_model(cfg, device="cpu"), TE.EncDecLM)
    assert ([ref_fields(s) for s in tree_leaves(spec, is_leaf_spec)]
            == fields(RE.encdec_spec(rcfg)))
    cache = model_cache_spec(cfg, 2, 64)
    assert ([ref_fields(s) for s in tree_leaves(cache, is_leaf_spec)]
            == fields(RE.encdec_cache_spec(rcfg, 2, 64)))
    assert sorted(cache["layers"]) == ["k", "v", "xk", "xv"]
    if not smoke:
        assert param_count(spec) == 36_484_608
        assert cfg.param_count() == 36_439_296
        assert spec["embed"].shape == (51_872, 384) and spec["embed"].cast


def one_layer(salt, enc_seq=16):
    """(f32 smoke cfg with one encoder and one decoder layer, reference
    params, the port's params on the same weights, frames [2, enc_seq,
    d] at the reference test's 0.02 scale)."""
    cfg = dataclasses.replace(f32(get_config(ARCH, smoke=True)),
                              n_enc_layers=1, n_layers=1, enc_seq=enc_seq)
    r = rs("encdec", salt)
    rp = jax.tree.map(
        lambda a: np.asarray(a) + randn(r, *a.shape, scale=0.05),
        ref_init(RE.encdec_spec(cfg), jax.random.PRNGKey(0)))
    tp = params_from_reference(rp, cfg, "cpu")
    frames = randn(r, 2, enc_seq, cfg.d_model, scale=0.02)
    return cfg, jax.tree.map(J, rp), tp, frames


@pytest.mark.parametrize("enc_seq", [16, 40], ids=["full", "fused"])
def test_encoder_layer(monkeypatch, enc_seq):
    """``encode`` over one layer (sinusoidal positions, layernorm, biased
    q/k/v, non-causal attention, GELU MLP, ``enc_norm``).  At 40 frames,
    past the smoke config's 32-key ``kv_chunk``, attention takes the
    fused branch (the kernel's plain version here), non-causal."""
    cfg, rp, tp, frames = one_layer(("enc", enc_seq), enc_seq)
    calls = []
    fused = TL.fused_attention

    def record(q, k, v, causal=True, window=0):
        calls.append((q.shape[1], k.shape[1], causal))
        return fused(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(TL, "fused_attention", record)
    got = build_model(cfg, device="cpu").encode(tp, T(frames))
    close(got, RE.EncDecLM(cfg).encode(rp, J(frames)))
    assert calls == ([(40, 40, False)] if enc_seq == 40 else [])


def test_cross_attention():
    """``_enc_kv`` (the cross K/V of the encoder output) and ``_xattn``
    (layernorm, q, non-causal attention of 20 text rows over 16 frames,
    output projection, residual)."""
    cfg, rp, tp, frames = one_layer("xattn")
    bp = jax.tree.map(lambda x: x[0], rp["dec_blocks"])
    tb = jax.tree.map(lambda x: x[0], tp["dec_blocks"])
    enc = randn(rs("xattn-enc"), 2, 16, cfg.d_model)
    h = randn(rs("xattn-h"), 2, 20, cfg.d_model)
    xk, xv = TE._enc_kv(tb, T(enc), cfg)
    rk, rv = RE._enc_kv(bp, J(enc), cfg)
    close(xk, rk)
    close(xv, rv)
    close(TE._xattn(tb, T(h), xk, xv, cfg),
          RE._xattn(bp, J(h), rk, rv, cfg, RL.NO_HINTS))


@pytest.mark.parametrize("S", [20, 40], ids=["full", "fused"])
def test_decoder_layer(S):
    """``_decoder_hidden`` over one layer (causal self-attention, cross-
    attention, MLP, final norm) and the cache it collects (``k``/``v``
    padded to ``max_len``, ``xk``/``xv``); then one decode step against
    that cache: its logits and every cache leaf.  At 40 tokens the
    self-attention takes the fused branch."""
    cfg, rp, tp, frames = one_layer(("dec", S))
    toks = rs("dec-toks", S).randint(0, cfg.vocab, (2, S + 1)).astype(
        np.int32)
    port, ref = build_model(cfg, device="cpu"), RE.EncDecLM(cfg)
    enc, renc = port.encode(tp, T(frames)), ref.encode(rp, J(frames))
    h, cache = port._decoder_hidden(tp, T(toks[:, :S]), enc,
                                    collect_cache=True, max_len=S + 4)
    rh, rcache = ref._decoder_hidden(rp, J(toks[:, :S]), renc,
                                     collect_cache=True, max_len=S + 4)
    close(h, rh)
    assert [k for k, _ in leaves(cache)] == ["k", "v", "xk", "xv"]
    for (_, g), (_, w) in zip(leaves(cache), leaves(rcache)):
        close(g, w)
    _, cache = port.prefill_fn(tp, T(toks[:, :S]), S + 4, T(frames))
    _, rcache = ref.prefill_fn(rp, J(toks[:, :S]), S + 4, J(frames))
    logits, cache = port.decode_fn(tp, T(toks[:, S]), cache)
    rlogits, rcache = ref.decode_fn(rp, J(toks[:, S]), rcache)
    close(logits, rlogits)
    for (name, g), (_, w) in zip(leaves(cache), leaves(rcache)):
        if name == "lens":
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w)


def test_loss_fn_raises():
    """``loss_fn`` is ported (held to the reference's in
    ``tests/test_torch_train.py``) and raises where the reference's does:
    on a text length that is not a multiple of ``logit_chunk`` (16 here;
    ``chunked_ce`` asserts it), and on a batch without ``frames``."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    params = init_params(model.spec(), 0, device="cpu")
    frames = torch.zeros(2, cfg.enc_seq, cfg.d_model)
    toks = torch.zeros(2, 40, dtype=torch.int32)
    with pytest.raises(AssertionError):
        model.loss_fn(params, {"frames": frames, "tokens": toks,
                               "labels": toks})
    with pytest.raises(KeyError, match="frames"):
        model.loss_fn(params, {"tokens": toks, "labels": toks})
    loss, met = model.loss_fn(params, {"frames": frames,
                                       "tokens": toks[:, :32],
                                       "labels": toks[:, :32]})
    assert torch.isfinite(loss) and int(met["tokens"]) == 64


def test_params_from_reference_checks_encdec_leaves():
    """The spec comes from the family's model: the enc-dec tree carries
    across, and a leaf of another shape or dtype, or a missing subtree,
    raises."""
    cfg = get_config(ARCH, smoke=True)
    rp = jax.tree.map(np.asarray, ref_init(RE.encdec_spec(cfg),
                                           jax.random.PRNGKey(0)))
    tp = params_from_reference(rp, cfg, "cpu")
    assert sorted(tp) == ["dec_blocks", "embed", "enc_blocks", "enc_norm",
                          "final_norm"]
    bad = dict(rp, embed=rp["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, cfg, "cpu")
    bad = dict(rp, enc_norm={k: v.astype(np.float64)
                             for k, v in rp["enc_norm"].items()})
    with pytest.raises(ValueError, match="dtype"):
        params_from_reference(bad, cfg, "cpu")
    bad = {k: v for k, v in rp.items() if k != "enc_blocks"}
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, "cpu")
