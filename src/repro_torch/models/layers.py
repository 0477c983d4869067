"""Core neural layers: norms, RoPE, GQA attention, MLPs.

Port of the reference ``models/layers.py``: pure functions over explicit
param dicts (specs built by the matching ``*_spec`` function).  Attention
implementations:

* ``full_attention``    — materialized scores; short sequences only.
* ``chunked_attention`` — the reference's flash-style chunked attention in
  plain torch (``masked`` and ``triangular``), kept as the oracle of the
  chunked branch.
* ``attention()``'s chunked branch calls ``fused_attention``
  (``kernels/flash_attention/ops.py``), which computes the same function
  through the hand-written kernel on a CUDA tensor — what the
  reference's ``fused_attention`` does through the Pallas kernel on a TPU.

The reference's ``Hints`` (activation sharding constraints) have no
counterpart yet: sharding is ROADMAP A9.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import fused_attention
from repro_torch.models.params import normal, ones, zeros

F32 = torch.float32

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
    freqs = torch.pow(torch.tensor(theta, dtype=F32, device=x.device),
                      -torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None] * freqs             # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Projections


def dense_spec(d_in: int, d_out: int, axes: tuple, bias: bool = False,
               scale: float | None = None) -> dict:
    out = {"w": normal((d_in, d_out), axes, scale=scale)}
    if bias:
        out["b"] = zeros((d_out,), (None,))
    return out


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype: float32 weights are cast per call, as
    the reference casts them (a transient copy of ``w`` on the device)."""
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
    """x [B,S,d] -> q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (+RoPE applied)."""
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


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      impl: str = "triangular") -> torch.Tensor:
    """Flash-style chunked attention in plain torch (the reference's
    XLA path, loop for loop).

    q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd].  The queries sit at the end of
    the kv range (``offset = Skv - Sq``); both sides pad to chunk
    multiples and padded keys are masked.
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

    def one_q_chunk(q_start, lo, hi):
        """Attend one query chunk against kv chunks ``lo..hi-1``."""
        q5 = q[:, q_start:q_start + q_chunk].reshape(B, q_chunk, Hkv, G, hd)
        carry = (torch.full((B, Hkv, G, q_chunk), -math.inf, device=dev),
                 torch.zeros((B, Hkv, G, q_chunk), device=dev),
                 torch.zeros((B, Hkv, G, q_chunk, hd), device=dev))
        mask_fn = make_mask_fn(q_start)
        for j in range(lo, hi):
            ks = j * kv_chunk
            carry = _online_step(carry, k[:, ks:ks + kv_chunk],
                                 v[:, ks:ks + kv_chunk], ks, q5, mask_fn, hd)
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
        outs.append(one_q_chunk(q_start, lo, hi))
    out = torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)
    return out[:, :Sq0]


def attention(q, k, v, cfg, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Dispatch on sequence length: full for short, the fused (kernel)
    chunked form otherwise."""
    if (cfg.pad_q_heads or cfg.repeat_kv) and q.shape[2] != k.shape[2]:
        # the reference's repeated-KV (MHA) layout for TP-padded heads
        G = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    Sq, Skv = q.shape[1], k.shape[1]
    if Skv <= min(1024, cfg.kv_chunk) and Sq == Skv:
        return full_attention(q, k, v, causal=causal, window=window)
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


def combine_decode_partials(o, m, l):
    """Normalize one partial (the single-device form: no cross-shard
    combine until sharding lands, ROADMAP A9)."""
    return o / torch.clamp(l, min=1e-30)[..., None]


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
