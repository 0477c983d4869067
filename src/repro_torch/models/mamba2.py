"""Mamba-2 SSD (state-space duality) block.

Port of the reference ``models/mamba2.py``.  Chunked SSD algorithm (Dao &
Gu 2024) with a single B/C group::

    h_t = a_t h_{t-1} + dt_t * B_t (x) x_t        a_t = exp(dt_t * A_h)
    y_t = C_t . h_t + D_h * x_t

computed per chunk of Q positions.  The reference inlines the chunk math
in a ``lax.scan``; here ``apply_ssd`` builds the same chunk views and
calls ``ssd_chunked`` (``kernels/ssd/ops.py``): the intra-chunk term
through the ``ssd_intra`` kernel, the inter-chunk recurrence as a loop
over chunks.  The kernel has no backward, so the training route
(``train=True``) runs the reference's own chunk scan (``_chunk_scan``),
each chunk rematerialized as the reference's ``jax.checkpoint`` does.
Decode is the O(1)-state single-step recurrence.

Layout: x is split into ``nh`` heads of ``hp = ssm_head_dim``; the state
is ``[B, nh, hp, N]``.

Head-sharded forms (``ssd_tp``, ``ssd_decode_tp``; a model row's devices
``devs``, the reference's layout: ``in_z``/``in_x`` by column,
``norm.scale`` and ``out`` by row over ``model``, the SSD activation and
state by head): model index ``j`` owns heads ``split_range(nh, M, j)``
and their ``hp`` channels each.  It projects its columns of ``z`` and
``x`` and the whole ``B``, ``C`` and its heads' ``dt`` (replicated
weights), convolves its ``x`` channels and the whole ``B``/``C``, runs the
SSD on its heads (``ssd_intra`` once per head shard on the card), then
the gated RMSNorm, whose mean square is over all of ``di``: each shard's
float32 sum of squares is ``psum``med before the scale.  Its rows of
``out`` give a partial, ``psum``med (``psum_rows``).  Under sequence
parallelism the caller ``all_gather``s the residual's sequence shards
before the block (the scan runs over the whole sequence) and passes
``reduce=psum_scatter_rows``, which reduce-scatters the partials back
onto the shards.  The conv state is
replicated, as the reference lays it out: each device's last ``W - 1``
rows of its ``x`` channels are gathered.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import piece
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.layers import (add_bias, apply_norm, dense,
                                       dense_cols, dense_rows, dense_spec,
                                       psum_rows, remat, split_range)
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


def _chunk_step(h, cq, uq, Bq, Cq):
    """One chunk of the reference's scan: h [B,nh,hp,N] the state before
    it; cq [B,Q,nh] the within-chunk cumulative log decay, uq
    [B,Q,nh,hp], Bq/Cq [B,Q,N] -> (h after it, y [B,Q,nh,hp]).

    The decay ``exp(cq_q - cq_k)`` is masked before the ``exp`` (to
    ``-inf`` above the diagonal), where the reference masks after it:
    the same values, but above the diagonal ``cq_q - cq_k`` is positive
    and its ``exp`` overflows to inf at full width, where the
    reference's backward then gives the masked entries ``0 * inf =
    NaN``."""
    Q = cq.shape[1]
    # intra-chunk (the kernel's part): masked decay-weighted gram
    gram = torch.einsum("bqn,bkn->bqk", Cq, Bq)                # [B,Q,Q]
    decay = cq[:, :, None, :] - cq[:, None, :, :]               # [B,Q,K,nh]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cq.device).tril()
    M = torch.exp(torch.where(mask[None, :, :, None], decay, -math.inf)) \
        * gram[..., None]
    y_intra = torch.einsum("bqkh,bkhp->bqhp", M, uq)
    # inter-chunk: contribution of the carried state
    y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", Cq, h, torch.exp(cq))
    # state update: h' = a_total * h + sum_j exp(cum_Q - cum_j) B_j u_j
    a_tot = torch.exp(cq[:, -1, :])                             # [B,nh]
    w_j = torch.exp(cq[:, -1, None, :] - cq)                    # [B,Q,nh]
    dh = torch.einsum("bqh,bqhp,bqn->bhpn", w_j, uq, Bq)
    return a_tot[:, :, None, None] * h + dh, y_intra + y_inter


def _chunk_scan(cum, u_c, B_cn, C_cn, h0):
    """The reference's chunk scan over chunked views (``ssd_chunked``'s
    arguments) -> (y [b,nc,Q,nh,hp], h_last [b,nh,hp,N])."""
    b, nc = cum.shape[:2]
    h = h0
    ys = []
    for c in range(nc):
        h, y = remat(_chunk_step, h, cum[:, c], u_c[:, c], B_cn[:, c],
                     C_cn[:, c])
        ys.append(y)
    return torch.stack(ys, dim=1), h


def apply_ssd(p: dict, x: torch.Tensor, cfg, state0=None,
              return_state: bool = False, train: bool = False):
    """Sequence form (train/prefill). x [B,S,d] -> y [B,S,d].  ``train``
    takes the reference's chunk scan in place of the kernel."""
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
    if train:
        if h0 is None:
            h0 = torch.zeros((B, nh, hp, N), dtype=F32, device=x.device)
        y, h_last = _chunk_scan(cum, u_c, B_cn, C_cn, h0)
    else:
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


# ---------------------------------------------------------------------------
# Head-sharded forms (module docstring).  ``xs[j]`` is model index ``j``'s
# input, whole, on ``devs[j]``; a state is {"ssm": its heads [B,nh_j,hp,N],
# "conv": the whole conv state [B,W-1,di+2N]} on its device.

RMS_EPS = 1e-6     # ``apply_norm``'s


def _shard(cfg, M: int, j: int):
    """Model index ``j``'s heads ``(lo, hi)`` and channels ``(clo, chi)``."""
    hp = cfg.ssm_head_dim
    lo, hi = split_range(dims(cfg)[1], M, j)
    return lo, hi, lo * hp, hi * hp


def _project_shard(p, x, cfg, lo, hi, clo, chi):
    """``_project`` on one shard -> z [B,S,cw], conv input [B,S,cw+2N]
    (its x channels, then B and C), dt [B,S,hi-lo] (f32)."""
    N = cfg.ssm_state
    z = dense_cols(p["in_z"], x, clo, chi)
    xi = dense_cols(p["in_x"], x, clo, chi)
    bc = dense_cols(p["in_bc"], x, 0, 2 * N)
    dt = dense_cols(p["in_dt"], x, lo, hi).to(F32)
    dt = F.softplus(dt + piece(p["dt_bias"], x.device, [(lo, hi)]).to(F32))
    return z, torch.cat([xi, bc], dim=-1), dt


def _conv_shard(t, di: int, clo: int, chi: int):
    """A shard's channels of a whole conv tensor (taps [W,ch], bias [ch],
    state [B,W-1,ch]): its x channels, then B and C."""
    return torch.cat([t[..., clo:chi], t[..., di:]], dim=-1)


def _conv_state_whole(parts: list, cfg, devs: list) -> list:
    """Each shard's conv rows [B,W-1,cw+2N] -> the whole conv state on every
    device: the x channels gathered, B and C the device's own (every shard
    computes the same)."""
    N2 = 2 * cfg.ssm_state
    xs = spmd.all_gather([c[..., :-N2] for c in parts], -1, devs)
    return [torch.cat([x, c[..., -N2:]], dim=-1) for x, c in zip(xs, parts)]


def _gated_norm_out(p, ys, zs, cfg, devs, dtype,
                    reduce=psum_rows) -> list:
    """The gated RMSNorm over all of ``di`` and the row-parallel output:
    ``ys[j]``/``zs[j]`` [B,S,cw] -> the block's output, ``reduce``d
    (``ssd_tp``)."""
    di = dims(cfg)[0]
    M = len(devs)
    gs, sq = [], []
    for y, z in zip(ys, zs):
        # apply_norm reads y in the compute type, in float32
        g = (y * F.silu(z.to(F32))).to(dtype).to(F32)
        gs.append(g)
        sq.append(torch.sum(g * g, dim=-1, keepdim=True))
    tot = spmd.psum(sq, devs)
    parts = []
    for j, (g, t) in enumerate(zip(gs, tot)):
        _, _, clo, chi = _shard(cfg, M, j)
        scale = piece(p["norm"]["scale"], g.device, [(clo, chi)])
        n = (g * torch.rsqrt(t / di + RMS_EPS) * scale).to(dtype)
        parts.append(dense_rows(p["out"], n, clo, chi))
    return add_bias(p["out"], reduce(parts, devs))


def ssd_tp(p: dict, xs: list, cfg, devs: list, state0s: list | None = None,
           return_state: bool = False, train: bool = False,
           reduce=psum_rows):
    """``apply_ssd`` by head shard over the model row ``devs`` -> the
    block's output [B,S,d] on every device (+ each device's state with
    ``return_state``); ``state0s[j]``: device ``j``'s state to continue
    from; ``train`` takes the chunk scan; ``reduce``: the output's sum
    (``layers.attention_tp``)."""
    M = len(devs)
    di, nh, hp, N = dims(cfg)
    B, S0, _ = xs[0].shape
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q
    nc = S // Q
    W = p["conv_w"].shape[0]
    ys, zs, states = [], [], []
    for j, x in enumerate(xs):
        dev = x.device
        lo, hi, clo, chi = _shard(cfg, M, j)
        nj, cw = hi - lo, chi - clo
        if S != S0:
            x = F.pad(x, (0, 0, 0, S - S0))
        z, conv_in, dt = _project_shard(p, x, cfg, lo, hi, clo, chi)
        if S != S0:
            dt = dt * (torch.arange(S, device=dev) < S0).to(
                dt.dtype)[None, :, None]
        taps = _conv_shard(piece(p["conv_w"], dev, [(0, W)]), di, clo, chi)
        bias = _conv_shard(piece(p["conv_b"], dev, [(0, di + 2 * N)]), di,
                           clo, chi)
        st = None if state0s is None else state0s[j]
        if st is not None:
            ext = torch.cat([_conv_shard(st["conv"], di, clo, chi), conv_in],
                            dim=1)
            conv_out = _conv(ext, taps, bias)[:, W - 1:, :]
        else:
            conv_out = _conv(conv_in, taps, bias)
        xh = conv_out[..., :cw].reshape(B, S, nj, hp)
        Bc = conv_out[..., cw: cw + N].to(F32)
        Cc = conv_out[..., cw + N:].to(F32)
        A = -torch.exp(piece(p["a_log"], dev, [(lo, hi)]).to(F32))
        u = dt[..., None] * xh.to(F32)
        cum = torch.cumsum((dt * A).reshape(B, nc, Q, nj), dim=2)
        u_c = u.reshape(B, nc, Q, nj, hp)
        B_cn, C_cn = Bc.reshape(B, nc, Q, N), Cc.reshape(B, nc, Q, N)
        h0 = None if st is None else st["ssm"]
        if train:
            if h0 is None:
                h0 = torch.zeros((B, nj, hp, N), dtype=F32, device=dev)
            y, h_last = _chunk_scan(cum, u_c, B_cn, C_cn, h0)
        else:
            y, h_last = ssd_chunked(cum, u_c, B_cn, C_cn, h0)
        y = y.reshape(B, S, nj, hp) + piece(p["d_skip"], dev, [(lo, hi)]).to(
            F32)[:, None] * xh.to(F32)
        ys.append(y.reshape(B, S, cw)[:, :S0])
        zs.append(z[:, :S0])
        states.append((h_last, conv_in[:, S0 - (W - 1): S0, :]))
    outs = _gated_norm_out(p, ys, zs, cfg, devs, xs[0].dtype,
                           reduce)
    if not return_state:
        return outs
    convs = _conv_state_whole([c for _, c in states], cfg, devs)
    return outs, [{"ssm": h, "conv": c} for (h, _), c in zip(states, convs)]


def ssd_decode_tp(p: dict, xs: list, cfg, devs: list, states: list):
    """``ssd_decode_step`` by head shard over ``devs``: ``xs[j]`` [B,1,d],
    ``states[j]`` device ``j``'s state -> (the output [B,1,d] on every
    device, the new states: fresh tensors)."""
    M = len(devs)
    di, nh, hp, N = dims(cfg)
    B = xs[0].shape[0]
    W = p["conv_w"].shape[0]
    ys, zs, hs, windows = [], [], [], []
    for j, (x, st) in enumerate(zip(xs, states)):
        dev = x.device
        lo, hi, clo, chi = _shard(cfg, M, j)
        nj, cw = hi - lo, chi - clo
        z, conv_in, dt = _project_shard(p, x, cfg, lo, hi, clo, chi)
        window = torch.cat([_conv_shard(st["conv"], di, clo, chi), conv_in],
                           dim=1)
        taps = _conv_shard(piece(p["conv_w"], dev, [(0, W)]), di, clo, chi)
        bias = _conv_shard(piece(p["conv_b"], dev, [(0, di + 2 * N)]), di,
                           clo, chi)
        cv = torch.einsum("bwc,wc->bc", window, taps.to(x.dtype))
        cv = F.silu(cv + bias.to(x.dtype))
        xh = cv[:, :cw].reshape(B, nj, hp).to(F32)
        Bc, Cc = cv[:, cw: cw + N].to(F32), cv[:, cw + N:].to(F32)
        A = -torch.exp(piece(p["a_log"], dev, [(lo, hi)]).to(F32))
        a = torch.exp(dt[:, 0] * A)
        u = dt[:, 0, :, None] * xh
        h = (a[:, :, None, None] * st["ssm"]
             + torch.einsum("bhp,bn->bhpn", u, Bc))
        y = torch.einsum("bn,bhpn->bhp", Cc, h)
        y = y + piece(p["d_skip"], dev, [(lo, hi)]).to(F32)[:, None] * xh
        ys.append(y.reshape(B, 1, cw))
        zs.append(z)
        hs.append(h)
        windows.append(window[:, 1:, :])
    outs = _gated_norm_out(p, ys, zs, cfg, devs, xs[0].dtype)
    convs = _conv_state_whole(windows, cfg, devs)
    return outs, [{"ssm": h, "conv": c} for h, c in zip(hs, convs)]
