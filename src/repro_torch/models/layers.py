"""Core neural layers: norms, RoPE and sinusoidal positions, GQA
attention, MLPs.

Port of the reference ``models/layers.py``: pure functions over explicit
param dicts (specs built by the matching ``*_spec`` function).  Attention
implementations:

* ``full_attention``    — materialized scores; short sequences only.
* ``chunked_attention`` — the reference's flash-style chunked attention in
  plain torch (``masked`` and ``triangular``), rematerialized per query
  chunk and per kv step as the reference's is, so its backward never
  keeps the score stack.  It is the oracle of the kernel branch and the
  training route.
* ``attention()``'s chunked branch calls ``fused_attention``
  (``kernels/flash_attention/ops.py``), which computes the same function
  through the hand-written kernel on a CUDA tensor — what the
  reference's ``fused_attention`` does through the Pallas kernel on a
  TPU.  The kernel has no backward, so ``attention(..., train=True)``
  (the loss's forward) takes ``chunked_attention``, the reference's own
  route, and the kernel's wrapper raises when handed a tensor that
  requires grad.

``Hints`` carry what the reference's do: the named activations' specs,
the mesh and the step kind.  There they constrain GSPMD's layout; here
``apply`` leaves a value as it is, and the layers read ``specs`` and
``mesh`` to pick their tensor-parallel forms, which run over the mesh's
devices explicitly (``distributed/spmd.py`` collectives, weights read
block by block from ``ShardedTensor``s or sliced from whole tensors):

* ``attention_tp`` — head TP over the devices ``head_devices`` picks
  (the whole row where the query heads split evenly, ``activation_hints``'
  rule; else its first device, whole): model index ``j`` projects and
  attends its own heads from its blocks of ``wq/wk/wv`` (the KV heads
  its query heads read; for a cross-attention from the other sequence),
  and the output projection is row-parallel, then ``psum``
  (``psum_rows``: in float32, rounded once);
* ``mlp_tp`` — column-parallel ``gate/up`` (``in``), row-parallel
  ``down`` (``out``), then ``psum``;
* both under sequence parallelism (``Hints.seq_parallel``: the
  residual's sequence split over ``model``, ``split_range(S, M, j)``
  rows on model index ``j``, where the reference pads to a multiple of
  ``M``): the caller ``all_gather``s the normed shards along the
  sequence before the column-parallel products and passes
  ``psum_scatter_rows`` (the float32 reduce-scatter of the row-parallel
  partials back onto the shards) in place of ``psum_rows``
  (``seq_gather`` gives both);
* ``attention_decode_tp`` — one token against a KV cache split along
  its sequence over ``model``: column-parallel flat projections
  gathered, ``decode_attention_partial`` per cache block,
  ``combine_decode_partials`` over the blocks (the LSE combine),
  row-parallel output;
* ``attention_cached_tp`` — one token by head shard against a cache
  every device reads whole (the local-attention ring, the encoder's
  K/V): its query heads, its KV heads of the cache, row-parallel
  output.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import compute_grid, piece, whole
from repro_torch.kernels.flash_attention.ops import fused_attention
from repro_torch.models.params import normal, ones, zeros

F32 = torch.float32

# ---------------------------------------------------------------------------
# Sharding hints


@dataclasses.dataclass(frozen=True)
class Hints:
    """Activation layout, keyed by logical activation name
    (``distributed.sharding.activation_hints``), with the mesh it refers
    to and the step family (``kind``: train/prefill/decode), which the
    MoE layer reads to pick its expert-parallel form for the sequence
    forms.  The layers read ``specs`` and ``mesh`` to pick their mesh
    forms; the reference's ``apply`` (a layout constraint) has no
    counterpart, as each form places its values itself."""

    specs: dict = dataclasses.field(default_factory=dict)
    mesh: object = None
    kind: str = "train"

    @property
    def sharded(self) -> bool:
        """Whether the model runs its mesh forms (a mesh with devices)."""
        return getattr(self.mesh, "devices", None) is not None

    def dp(self) -> tuple[str, ...] | None:
        """The mesh axes the batch splits over (the residual's dim 0)."""
        entry = self.specs.get("residual", (None,))[0]
        if entry is None:
            return None
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def head_tp(self) -> bool:
        spec = self.specs.get("attn_q", ())
        return len(spec) > 2 and spec[2] == "model"

    def seq_parallel(self) -> bool:
        spec = self.specs.get("residual", ())
        return len(spec) > 1 and spec[1] == "model"

    def grid(self):
        """``[R, M]`` devices: batch block ``r``, model index ``j``
        (``distributed.sharding.compute_grid``)."""
        return compute_grid(self.mesh, self.dp())


NO_HINTS = Hints()


def split_range(n: int, parts: int, j: int) -> tuple[int, int]:
    """Part ``j`` of ``parts`` contiguous ranges over ``n``."""
    return n * j // parts, n * (j + 1) // parts

# ---------------------------------------------------------------------------
# Norms


def rmsnorm_spec(d: int) -> dict:
    return {"scale": ones((d,), (None,))}


def layernorm_spec(d: int) -> dict:
    return {"scale": ones((d,), (None,)), "bias": zeros((d,), (None,))}


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Positional encodings


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S] (int)."""
    hd = x.shape[-1]
    half = hd // 2
    # the base as a device op (``full``): no host tensor copied over
    freqs = torch.pow(torch.full((), theta, dtype=F32, device=x.device),
                      -torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None] * freqs             # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The rows of the sinusoidal table at ``positions`` (an integer
    tensor [N], on its device) -> [N, d] float32, the same bits as
    gathering them from ``sinusoidal_table``."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=positions.device)
                      * (math.log(10_000.0) / max(1, half - 1)))
    ang = positions.to(F32)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_table(seq: int, d: int, device) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positional table [seq, d] (float32,
    on ``device``): sines, then cosines."""
    return sinusoidal_rows(torch.arange(seq, device=device), d)


# ---------------------------------------------------------------------------
# Projections


def dense_spec(d_in: int, d_out: int, axes: tuple, bias: bool = False,
               scale: float | None = None, cast: bool = True) -> dict:
    """``cast``: the leaves are read only by ``dense`` on inputs in the
    compute type (pass False for a layer that runs on float32 inputs)."""
    out = {"w": normal((d_in, d_out), axes, scale=scale, cast=cast)}
    if bias:
        out["b"] = zeros((d_out,), (None,), cast=cast)
    return out


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype: float32 weights are cast per call, as
    the reference casts them (a transient copy of ``w`` on the device);
    for a leaf already held in ``x``'s dtype (``models/params.py``'s
    16-bit store) the cast is a no-op."""
    w = p["w"].to(x.dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Attention — specs


def attention_spec(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.q_heads() * hd, cfg.n_kv_heads * hd
    bias = cfg.qkv_bias or cfg.attn_bias
    return {
        "q": dense_spec(d, qd, ("embed", "heads"), bias),
        "k": dense_spec(d, kvd, ("embed", "kv"), bias),
        "v": dense_spec(d, kvd, ("embed", "kv"), bias or cfg.attn_bias),
        "o": dense_spec(qd, d, ("heads", "embed"), cfg.attn_bias,
                        scale=1.0 / math.sqrt(qd * 2 * cfg.n_layers)),
    }


def project_qkv(p: dict, x: torch.Tensor, cfg, positions):
    """x [B,S,d] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (+RoPE applied when
    ``cfg.pos`` is ``"rope"``; otherwise ``positions`` is not read)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["q"], x).reshape(B, S, cfg.q_heads(), hd)
    k = dense(p["k"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["v"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Attention — cores


def _scores(q5: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q5 [B,qc,Hkv,G,hd] x k [B,kc,Hkv,hd] -> [B,Hkv,G,qc,kc] (f32).
    Products of two bf16 values are exact in float32, so upcasting first
    is the reference's ``preferred_element_type=float32``."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q5.to(F32), k.to(F32))


def _apply_v(probs: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """probs [B,Hkv,G,qc,kc] x v [B,kc,Hkv,hd] -> [B,qc,Hkv,G,hd]."""
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(dtype), v.to(dtype))


def full_attention(q, k, v, *, causal: bool,
                   window: int = 0) -> torch.Tensor:
    """Materialized attention (short sequences only)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, hd)
    s = _scores(q5, k) / math.sqrt(hd)
    Skv = k.shape[1]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        ki = torch.arange(Skv, device=q.device)[None, :]
        m = qi >= ki
        if window > 0:
            m &= qi - ki < window
        s = torch.where(m, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = _apply_v(p, v, q.dtype)
    return o.reshape(B, Sq, Hq, hd)


def _online_step(carry, k_c, v_c, k_start, q5, mask_fn, hd):
    """One kv-chunk online-softmax update.  carry: (m, l, acc)."""
    m, l, acc = carry
    s = _scores(q5, k_c) / math.sqrt(hd)            # [B,Hkv,G,qc,kc]
    s = mask_fn(s, k_start)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # guard fully-masked rows (m == -inf): scale factor 0
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l_new = l * alpha + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, v_c.to(F32))
    return m_new, l_new, acc_new


def _finish(m, l, acc, B, qc, Hkv, G, hd, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B,Hkv,G,qc,hd]
    out = torch.movedim(out, 3, 1)                     # [B,qc,Hkv,G,hd]
    return out.reshape(B, qc, Hkv * G, hd).to(dtype)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (the reference's ``jax.checkpoint``); a forward
    without autograd just runs it."""
    return checkpoint(fn, *args, use_reentrant=False)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      impl: str = "triangular") -> torch.Tensor:
    """Flash-style chunked attention in plain torch (the reference's
    XLA path, loop for loop).

    q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd].  The queries sit at the end of
    the kv range (``offset = Skv - Sq``); both sides pad to chunk
    multiples and padded keys are masked.  Each query chunk and each of
    its kv steps is rematerialized (``remat``), as the reference's
    ``jax.checkpoint``s are: the backward keeps one query chunk's carry
    per kv step, never its scores.
    """
    B, Sq0, Hq, hd = q.shape
    Skv0, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq0)
    kv_chunk = min(kv_chunk, Skv0)
    offset = Skv0 - Sq0
    Sq = -(-Sq0 // q_chunk) * q_chunk
    Skv = -(-Skv0 // kv_chunk) * kv_chunk
    if Sq != Sq0:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq - Sq0))
    if Skv != Skv0:
        k = F.pad(k, (0, 0, 0, 0, 0, Skv - Skv0))
        v = F.pad(v, (0, 0, 0, 0, 0, Skv - Skv0))
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    dev = q.device

    def make_mask_fn(q_start):
        def mask_fn(s, k_start):
            qi = (torch.arange(q_chunk, device=dev) + q_start
                  + offset)[:, None]
            ki = (torch.arange(kv_chunk, device=dev) + k_start)[None, :]
            m = (ki < Skv0).expand(q_chunk, kv_chunk).clone()  # kv padding
            if causal:
                m &= qi >= ki
            if window > 0:
                m &= qi - ki < window
            return torch.where(m, s, -math.inf)
        return mask_fn

    def one_q_chunk(q_start, lo, hi, q, k, v):
        """Attend one query chunk against kv chunks ``lo..hi-1``."""
        q5 = q[:, q_start:q_start + q_chunk].reshape(B, q_chunk, Hkv, G, hd)
        carry = (torch.full((B, Hkv, G, q_chunk), -math.inf, device=dev),
                 torch.zeros((B, Hkv, G, q_chunk), device=dev),
                 torch.zeros((B, Hkv, G, q_chunk, hd), device=dev))
        mask_fn = make_mask_fn(q_start)

        def step(m, l, acc, k_c, v_c, ks):
            return _online_step((m, l, acc), k_c, v_c, ks, q5, mask_fn, hd)
        for j in range(lo, hi):
            ks = j * kv_chunk
            carry = remat(step, *carry, k[:, ks:ks + kv_chunk],
                          v[:, ks:ks + kv_chunk], ks)
        return _finish(*carry, B, q_chunk, Hkv, G, hd, q.dtype)

    outs = []
    for i in range(nq):
        q_start = i * q_chunk
        if impl == "masked" or not causal:
            # every kv chunk; the mask hides the invisible ones
            lo, hi = 0, nk
        else:
            # triangular: the kv chunks visible to this query chunk
            hi = min(nk, (q_start + q_chunk - 1 + offset) // kv_chunk + 1)
            lo = 0
            if window > 0:
                lo = max(0, (q_start + offset - (window - 1)) // kv_chunk)
            lo = min(lo, max(hi - 1, 0))
            hi = max(hi, lo + 1)
        outs.append(remat(one_q_chunk, q_start, lo, hi, q, k, v))
    out = torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)
    return out[:, :Sq0]


def attention(q, k, v, cfg, *, causal: bool = True, window: int = 0,
              train: bool = False) -> torch.Tensor:
    """Dispatch on sequence length: full for short, chunked otherwise —
    the fused (kernel) form when serving, the reference's
    ``chunked_attention`` with the config's chunks when ``train``."""
    if (cfg.pad_q_heads or cfg.repeat_kv) and q.shape[2] != k.shape[2]:
        # the reference's repeated-KV (MHA) layout for TP-padded heads
        G = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    Sq, Skv = q.shape[1], k.shape[1]
    if Skv <= min(1024, cfg.kv_chunk) and Sq == Skv:
        return full_attention(q, k, v, causal=causal, window=window)
    if train:
        return chunked_attention(
            q, k, v, causal=causal, window=window, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, impl="triangular" if causal else "masked")
    return fused_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode attention (one new token against a cache) — partial/combinable form


def decode_attention_partial(q, k_cache, v_cache, valid_mask):
    """q [B,Hq,hd]; caches [B,S,Hkv,hd]; valid_mask [B,S] bool.

    Returns unnormalized (o [B,Hq,hd] f32, m [B,Hq], l [B,Hq]) so
    partials over a split S can be LSE-combined (flash-decoding).
    """
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Hkv, G, hd).to(F32)
    s = torch.einsum("bhgd,bshd->bhgs", q5, k_cache.to(F32)) / math.sqrt(hd)
    s = torch.where(valid_mask[:, None, None, :], s, -math.inf)
    m = torch.amax(s, dim=-1)
    p = torch.where(torch.isfinite(s), torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(F32))
    return o.reshape(B, Hq, hd), m.reshape(B, Hq), l.reshape(B, Hq)


def combine_decode_partials(o, m, l, axis=None):
    """LSE-combine partials.  ``axis=None``: ``o, m, l`` are one partial,
    normalized.  Otherwise ``axis`` lists the devices of the mesh axis
    the cache's sequence is split over and ``o, m, l`` are lists of
    their partials: ``pmax`` of ``m``, each partial scaled by
    ``exp(m - m_g)`` (0 where its block saw no valid key, ``m = -inf``),
    ``psum`` of ``l`` and ``o``; returns the normalized output on every
    device."""
    if axis is None:
        return o / torch.clamp(l, min=1e-30)[..., None]
    m_g = spmd.pmax(m, axis)
    scale = [torch.where(torch.isfinite(mi), torch.exp(mi - mg), 0.0)
             for mi, mg in zip(m, m_g)]
    l_g = spmd.psum([li * si for li, si in zip(l, scale)], axis)
    o_g = spmd.psum([oi * si[..., None] for oi, si in zip(o, scale)], axis)
    return [og / torch.clamp(lg, min=1e-30)[..., None]
            for og, lg in zip(o_g, l_g)]


def decode_attention(q, k_cache, v_cache, valid_mask, dtype):
    o, m, l = decode_attention_partial(q, k_cache, v_cache, valid_mask)
    return combine_decode_partials(o, m, l).to(dtype)


# ---------------------------------------------------------------------------
# MLPs


def mlp_spec(cfg, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    down_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    if cfg.mlp == "swiglu":
        return {
            "gate": dense_spec(d, ff, ("embed", "mlp")),
            "up": dense_spec(d, ff, ("embed", "mlp")),
            "down": dense_spec(ff, d, ("mlp", "embed"), scale=down_scale),
        }
    return {
        "in": dense_spec(d, ff, ("embed", "mlp"), bias=cfg.attn_bias),
        "out": dense_spec(ff, d, ("mlp", "embed"), bias=cfg.attn_bias,
                          scale=down_scale),
    }


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
        return dense(p["down"], h)
    h = F.gelu(dense(p["in"], x), approximate="tanh")
    return dense(p["out"], h)


# ---------------------------------------------------------------------------
# Tensor-parallel forms (module docstring).  ``xs[j]`` is model index
# ``j``'s input, whole, on ``devs[j]``; weights are tensors or
# ``ShardedTensor``s, read a piece at a time on the device that uses it.


def dense_cols(p: dict, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``dense(p, x)[..., lo:hi]``, from columns ``lo:hi`` of ``w`` (and
    ``b``) alone (column-parallel)."""
    w = p["w"]
    y = x @ piece(w, x.device, [(0, w.shape[0]), (lo, hi)]).to(x.dtype)
    if "b" in p:
        y = y + piece(p["b"], x.device, [(lo, hi)]).to(y.dtype)
    return y


def dense_rows(p: dict, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``x @ w[lo:hi]`` without the bias: one row-parallel partial (the
    caller ``psum``s and adds the bias once, ``add_bias``)."""
    return x @ piece(p["w"], x.device, [(lo, hi)]).to(x.dtype)


def add_bias(p: dict, ys: list) -> list:
    if "b" not in p:
        return ys
    return [y + whole(p["b"], y.device).to(y.dtype) for y in ys]


def psum_rows(partials: list, devs: list) -> list:
    """``psum`` of row-parallel partials, accumulated in float32 and
    rounded to their dtype once (a 16-bit partial is rounded once by its
    product already; summing in 16 bits would round again at each
    add)."""
    dt = partials[0].dtype
    return [x.to(dt) for x in spmd.psum([x.float() for x in partials],
                                        devs)]


def psum_scatter_rows(partials: list, devs: list) -> list:
    """``psum_rows``' sequence-parallel counterpart: row-parallel partials
    [B, S, d] reduce-scattered along the sequence in float32, model index
    ``j`` keeping rows ``split_range(S, M, j)``, rounded to their dtype
    once."""
    dt = partials[0].dtype
    return [x.to(dt) for x in spmd.psum_scatter(
        [x.float() for x in partials], 1, devs)]


def seq_gather(xs: list, devs: list, sp: bool):
    """A model row's inputs -> (the whole sequence on every device, the
    reduce that returns a row-parallel output to ``xs``' layout).
    ``sp``: ``xs`` are the sequence shards, ``all_gather``ed along the
    sequence, and the reduce is ``psum_scatter_rows``; else ``xs`` as
    they are and ``psum_rows``."""
    if sp:
        return spmd.all_gather(xs, 1, devs), psum_scatter_rows
    return xs, psum_rows


def seq_scatter(x: torch.Tensor, devs: list, sp: bool) -> list:
    """A tensor [B, S, ...] whole on one device -> the row's layout:
    ``sp``: model index ``j``'s rows ``split_range(S, M, j)`` on
    ``devs[j]``, else the whole on each (a slice or ``x`` itself where
    it lies on the device, else a copy)."""
    if not sp:
        return [x.to(d) for d in devs]
    S, M = x.shape[1], len(devs)
    return [x[:, lo:hi].to(d) for d, (lo, hi) in
            zip(devs, (split_range(S, M, j) for j in range(M)))]


def seq_whole(row: list, dev, sp: bool) -> torch.Tensor:
    """``seq_scatter``'s inverse: a row's layout -> the whole on ``dev``
    (the shards concatenated, or the first device's)."""
    if sp:
        return torch.cat([h.to(dev) for h in row], 1)
    return row[0].to(dev)


def kv_heads_of(cfg, lo: int, hi: int) -> tuple[int, int] | None:
    """The KV heads query heads ``lo:hi`` read, as a range, when the
    range's grouping is the whole layout's (each of its query heads
    ``h`` reads KV head ``h // G`` and local head ``h - lo`` reads local
    KV head ``(h - lo) // G_loc``); ``None`` where it is not."""
    Hq, Hkv = cfg.q_heads(), cfg.n_kv_heads
    G, n = Hq // Hkv, hi - lo
    if Hq % Hkv or not (G % n == 0 or n % G == 0):
        return None
    return lo // G, (hi - 1) // G + 1


def head_devices(cfg, devs: list) -> list:
    """The devices of a model row that run its attention: all of them, a
    head shard each, where the query heads split evenly over them
    (``activation_hints``' head TP), else the row's first, whole."""
    return devs if cfg.q_heads() % len(devs) == 0 else devs[:1]


def _kv_range(cfg, lo: int, hi: int) -> tuple[int, int]:
    kr = kv_heads_of(cfg, lo, hi)
    return kr if kr is not None else (0, cfg.n_kv_heads)


def _local_kv(cfg, k, v, lo: int, hi: int):
    """Query heads ``lo:hi``'s K/V: as projected where the grouping
    splits with them, else each local query head's KV head repeated."""
    if kv_heads_of(cfg, lo, hi) is not None:
        return k, v
    G = cfg.q_heads() // cfg.n_kv_heads
    return (torch.repeat_interleave(k, G, dim=2)[:, :, lo:hi],
            torch.repeat_interleave(v, G, dim=2)[:, :, lo:hi])


def project_qkv_heads(p: dict, x: torch.Tensor, cfg, positions, lo: int,
                      hi: int, kv_x: torch.Tensor | None = None):
    """Query heads ``lo:hi`` of ``project_qkv`` and the KV heads they
    read -> (q [B,S,hi-lo,hd], k, v [B,Skv,n_kv_loc,hd], (klo, khi)): the
    KV heads' range (the whole, repeated per query head, where the
    grouping does not split, ``kv_heads_of``).  ``kv_x``: the sequence
    K/V are projected from (a cross-attention's), else ``x``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    kv_x = x if kv_x is None else kv_x
    q = dense_cols(p["q"], x, lo * hd, hi * hd).reshape(B, S, hi - lo, hd)
    klo, khi = _kv_range(cfg, lo, hi)
    k = dense_cols(p["k"], kv_x, klo * hd, khi * hd).reshape(
        B, kv_x.shape[1], -1, hd)
    v = dense_cols(p["v"], kv_x, klo * hd, khi * hd).reshape(
        B, kv_x.shape[1], -1, hd)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v, (klo, khi)


def attention_tp(p: dict, xs: list, cfg, positions: list | None,
                 devs: list, *, causal: bool = True, window: int = 0,
                 train: bool = False, kv_xs: list | None = None,
                 reduce=psum_rows):
    """Head-TP attention (sequence form) over the model devices ``devs``
    -> (the attention block's output on every device, each device's (k,
    v, (klo, khi)) for the cache).  Model index ``j`` runs query heads
    ``split_range(Hq, M, j)`` through ``attention`` (the hand-written
    kernel when serving on the card), then its rows of the output
    projection; the partials are ``psum``med and the bias added once.
    ``kv_xs[j]``: the sequence a cross-attention's K/V come from, on
    ``devs[j]``; ``positions`` (``None`` where no RoPE reads them).
    ``xs``, ``kv_xs`` and ``positions`` hold the whole sequence;
    ``reduce``: the partials' sum, ``psum_scatter_rows`` to hand each
    device its sequence shard (``seq_gather``)."""
    M = len(devs)
    hd = cfg.head_dim
    partials, kvs = [], []
    for j, x in enumerate(xs):
        lo, hi = split_range(cfg.q_heads(), M, j)
        q, k, v, kr = project_qkv_heads(
            p, x, cfg, None if positions is None else positions[j], lo, hi,
            None if kv_xs is None else kv_xs[j])
        ka, va = _local_kv(cfg, k, v, lo, hi)
        a = attention(q, ka, va, cfg, causal=causal, window=window,
                      train=train)
        B, S = a.shape[:2]
        partials.append(dense_rows(p["o"], a.reshape(B, S, -1), lo * hd,
                                   hi * hd))
        kvs.append((k, v, kr))
    return add_bias(p["o"], reduce(partials, devs)), kvs


def gathered_cols(p: dict, xs: list, n: int, devs: list) -> list:
    """``dense(p, x)`` [..., n] on every device: column-parallel (model
    index ``j`` computes columns ``split_range(n, M, j)``), then
    ``all_gather``."""
    M = len(devs)
    return spmd.all_gather([dense_cols(p, x, *split_range(n, M, j))
                            for j, x in enumerate(xs)], -1, devs)


def attention_cached_tp(p: dict, xs: list, cfg, devs: list,
                        positions: list | None, kv) -> list:
    """One token's attention by head shard against a cache every device
    reads whole: model index ``j`` projects its query heads (RoPE at
    ``positions[j]``), ``kv(j, klo, khi)`` gives its KV heads of the
    cache on ``devs[j]`` and their valid mask ([B, S] bool), it attends
    (``decode_attention``) and computes its rows of the output
    projection; ``psum``, the bias once -> the output [B, 1, d] on every
    device."""
    M = len(devs)
    hd = cfg.head_dim
    partials = []
    for j, x in enumerate(xs):
        B = x.shape[0]
        lo, hi = split_range(cfg.q_heads(), M, j)
        q = dense_cols(p["q"], x, lo * hd, hi * hd).reshape(B, 1, hi - lo, hd)
        if cfg.pos == "rope":
            q = rope(q, positions[j], cfg.rope_theta)
        kc, vc, valid = kv(j, *_kv_range(cfg, lo, hi))
        kc, vc = _local_kv(cfg, kc, vc, lo, hi)
        a = decode_attention(q[:, 0], kc, vc, valid, x.dtype)
        partials.append(dense_rows(p["o"], a.reshape(B, 1, -1), lo * hd,
                                   hi * hd))
    return add_bias(p["o"], psum_rows(partials, devs))


def attention_decode_tp(p: dict, xs: list, cfg, lens: list, devs: list,
                        kcs: list, vcs: list):
    """One token's self-attention over a cache whose sequence is split
    over the model row ``devs``: ``kcs[j]``/``vcs[j]`` [B, L/M, Hkv, hd]
    hold positions ``j*L/M ..`` on ``devs[j]``; ``lens[j]`` [B] (tokens
    already cached) on ``devs[j]``.  The flat q/k/v projections are
    column-parallel and gathered; the new K/V row is written (in place)
    into the block that holds position ``lens``; each block's partial
    (``decode_attention_partial``) is LSE-combined over the row; the
    output projection is row-parallel, then ``psum``.  -> the block's
    output [B, 1, d] on every device."""
    M = len(devs)
    hd, Hq, Hkv = cfg.head_dim, cfg.q_heads(), cfg.n_kv_heads
    B = xs[0].shape[0]
    qs = gathered_cols(p["q"], xs, Hq * hd, devs)
    ks = gathered_cols(p["k"], xs, Hkv * hd, devs)
    vs = gathered_cols(p["v"], xs, Hkv * hd, devs)
    os_, ms, ls = [], [], []
    for j, dev in enumerate(devs):
        pos = lens[j][:, None]
        q = qs[j].reshape(B, 1, Hq, hd)
        k = ks[j].reshape(B, 1, Hkv, hd)
        v = vs[j].reshape(B, 1, Hkv, hd)
        if cfg.pos == "rope":
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        kc, vc = kcs[j], vcs[j]
        Lb = kc.shape[1]
        at = lens[j].long() - j * Lb
        own = (at >= 0) & (at < Lb)
        rows = torch.arange(B, device=dev)
        slot = torch.clamp(at, 0, Lb - 1)
        kc[rows, slot] = torch.where(own[:, None, None], k[:, 0].to(
            kc.dtype), kc[rows, slot])
        vc[rows, slot] = torch.where(own[:, None, None], v[:, 0].to(
            vc.dtype), vc[rows, slot])
        valid = (torch.arange(Lb, device=dev)[None, :] + j * Lb
                 <= lens[j].long()[:, None])
        o, m, l = decode_attention_partial(q[:, 0], kc, vc, valid)
        os_.append(o), ms.append(m), ls.append(l)
    a = combine_decode_partials(os_, ms, ls, axis=devs)
    partials = []
    for j, aj in enumerate(a):
        lo, hi = split_range(Hq, M, j)
        aj = aj.to(xs[j].dtype)[:, lo:hi].reshape(B, 1, -1)
        partials.append(dense_rows(p["o"], aj, lo * hd, hi * hd))
    return add_bias(p["o"], psum_rows(partials, devs))


def mlp_tp(p: dict, xs: list, cfg, devs: list, reduce=psum_rows) -> list:
    """The MLP over a model row: column-parallel ``gate``/``up`` (``in``)
    on ``split_range(d_ff, M, j)``, row-parallel ``down`` (``out``), then
    ``reduce`` (as in ``attention_tp``) and the output bias once."""
    M = len(devs)
    out = []
    if cfg.mlp == "swiglu":
        ff = p["gate"]["w"].shape[1]
        for j, x in enumerate(xs):
            lo, hi = split_range(ff, M, j)
            h = F.silu(dense_cols(p["gate"], x, lo, hi)) * dense_cols(
                p["up"], x, lo, hi)
            out.append(dense_rows(p["down"], h, lo, hi))
        return add_bias(p["down"], reduce(out, devs))
    ff = p["in"]["w"].shape[1]
    for j, x in enumerate(xs):
        lo, hi = split_range(ff, M, j)
        h = F.gelu(dense_cols(p["in"], x, lo, hi), approximate="tanh")
        out.append(dense_rows(p["out"], h, lo, hi))
    return add_bias(p["out"], reduce(out, devs))
