"""Mamba-2 SSD (state-space duality) block.

Port of the reference ``models/mamba2.py``.  Chunked SSD algorithm (Dao &
Gu 2024) with a single B/C group::

    h_t = a_t h_{t-1} + dt_t * B_t (x) x_t        a_t = exp(dt_t * A_h)
    y_t = C_t . h_t + D_h * x_t

computed per chunk of Q positions.  The reference inlines the chunk math
in a ``lax.scan``; here ``apply_ssd`` builds the same chunk views and
calls ``ssd_chunked`` (``kernels/ssd/ops.py``): the intra-chunk term
through the ``ssd_intra`` kernel, the inter-chunk recurrence as a loop
over chunks.  Decode is the O(1)-state single-step recurrence.

Layout: x is split into ``nh`` heads of ``hp = ssm_head_dim``; the state
is ``[B, nh, hp, N]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.layers import apply_norm, dense, dense_spec
from repro_torch.models.params import LeafSpec, ones, zeros

F32 = torch.float32


def dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return di, nh, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_spec(cfg) -> dict:
    d = cfg.d_model
    di, nh, hp, N = dims(cfg)
    conv_ch = di + 2 * N          # conv runs over (x, B, C)
    w = 4
    return {
        # fused input projection -> [z, x, B, C, dt]
        "in_z": dense_spec(d, di, ("embed", "mlp")),
        "in_x": dense_spec(d, di, ("embed", "mlp")),
        "in_bc": dense_spec(d, 2 * N, ("embed", None)),
        "in_dt": dense_spec(d, nh, ("embed", None)),
        "conv_w": zeros((w, conv_ch), (None, None)),
        "conv_b": zeros((conv_ch,), (None,)),
        "a_log": LeafSpec((nh,), (None,), "ssm_a"),
        "dt_bias": LeafSpec((nh,), (None,), "dt_bias"),
        "d_skip": ones((nh,), (None,)),
        "norm": {"scale": ones((di,), ("mlp",))},
        "out": dense_spec(di, d, ("mlp", "embed")),
    }


def _conv(u, w, b):
    """Causal depthwise conv + SiLU; ``u`` times the float32 taps promotes
    to float32, as in the reference."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = torch.zeros_like(u)
    for j in range(W):
        y = y + pad[:, j: j + u.shape[1], :] * w[j]
    return F.silu(y + b)


def _project(p, x, cfg):
    """-> z [B,S,di], conv input [B,S,di+2N], dt [B,S,nh] (f32)."""
    z = dense(p["in_z"], x)
    xi = dense(p["in_x"], x)
    bc = dense(p["in_bc"], x)
    dt = dense(p["in_dt"], x).to(F32)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    conv_in = torch.cat([xi, bc], dim=-1)
    return z, conv_in, dt


def _split_conv(conv_out, cfg):
    di, nh, hp, N = dims(cfg)
    xc = conv_out[..., :di]
    Bc = conv_out[..., di: di + N].to(F32)
    Cc = conv_out[..., di + N:].to(F32)
    return xc, Bc, Cc


def apply_ssd(p: dict, x: torch.Tensor, cfg, state0=None,
              return_state: bool = False):
    """Sequence form (prefill). x [B,S,d] -> y [B,S,d]."""
    B, S0, d = x.shape
    di, nh, hp, N = dims(cfg)
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q
    if S != S0:  # pad; dt is zeroed on the pad so the state is untouched
        x = F.pad(x, (0, 0, 0, S - S0))
    nc = S // Q

    z, conv_in, dt = _project(p, x, cfg)
    if S != S0:
        dt = dt * (torch.arange(S, device=x.device) < S0).to(
            dt.dtype)[None, :, None]
    if state0 is not None:
        W = p["conv_w"].shape[0]
        ext = torch.cat([state0["conv"], conv_in], dim=1)
        conv_out = _conv(ext, p["conv_w"], p["conv_b"])[:, W - 1:, :]
    else:
        conv_out = _conv(conv_in, p["conv_w"], p["conv_b"])
    xc, Bc, Cc = _split_conv(conv_out, cfg)
    xh = xc.reshape(B, S, nh, hp)

    A = -torch.exp(p["a_log"].to(F32))                          # [nh]
    dlog = dt * A                                                # [B,S,nh]
    u = dt[..., None] * xh.to(F32)                               # [B,S,nh,hp]

    # chunk views, as the reference builds them
    dlog_c = dlog.reshape(B, nc, Q, nh)
    u_c = u.reshape(B, nc, Q, nh, hp)
    B_cn = Bc.reshape(B, nc, Q, N)
    C_cn = Cc.reshape(B, nc, Q, N)
    cum = torch.cumsum(dlog_c, dim=2)                            # [B,nc,Q,nh]

    h0 = None if state0 is None else state0["ssm"]
    y, h_last = ssd_chunked(cum, u_c, B_cn, C_cn, h0)
    y = y.reshape(B, S, nh, hp)
    y = y + p["d_skip"].to(F32)[:, None] * xh.to(F32)

    # gated RMSNorm + output projection
    y = y.reshape(B, S, di) * F.silu(z.to(F32))
    y = apply_norm(p["norm"], y.to(x.dtype), "rmsnorm")
    out = dense(p["out"], y)[:, :S0]
    if return_state:
        W = p["conv_w"].shape[0]
        return out, {"ssm": h_last, "conv": conv_in[:, S0 - (W - 1): S0, :]}
    return out


def ssd_decode_step(p: dict, x: torch.Tensor, cfg, state):
    """One-token recurrence. x [B,1,d]; state {ssm [B,nh,hp,N],
    conv [B,W-1,ch]} -> (y [B,1,d], new state; fresh tensors)."""
    B = x.shape[0]
    di, nh, hp, N = dims(cfg)
    z, conv_in, dt = _project(p, x, cfg)                  # S=1
    window = torch.cat([state["conv"], conv_in], dim=1)
    cv = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype))
    cv = F.silu(cv + p["conv_b"].to(x.dtype))[:, None, :]
    xc, Bc, Cc = _split_conv(cv, cfg)
    xh = xc.reshape(B, nh, hp).to(F32)
    A = -torch.exp(p["a_log"].to(F32))
    a = torch.exp(dt[:, 0] * A)                            # [B,nh]
    u = dt[:, 0, :, None] * xh                             # [B,nh,hp]
    h = (a[:, :, None, None] * state["ssm"]
         + torch.einsum("bhp,bn->bhpn", u, Bc[:, 0]))
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0], h)
    y = y + p["d_skip"].to(F32)[:, None] * xh
    y = y.reshape(B, 1, di) * F.silu(z.to(F32))
    y = apply_norm(p["norm"], y.to(x.dtype), "rmsnorm")
    out = dense(p["out"], y)
    return out, {"ssm": h, "conv": window[:, 1:, :]}
