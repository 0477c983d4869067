"""RG-LRU recurrent block (recurrentgemma / Griffin-style).

Port of the reference ``models/rglru.py``.  The recurrent block: dual
linear branches (gate + recurrent), a short causal depthwise conv, and
the Real-Gated LRU::

    r_t = sigmoid(W_a u_t + b_a)          recurrence gate
    i_t = sigmoid(W_i u_t + b_i)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    out = W_o (gelu(gate_branch) * h)

The sequence form's linear recurrence is the reference's
``jax.lax.associative_scan`` in XLA (not a Pallas kernel).  The serving
route (``_linear_scan``) runs it through ``kernels/rglru_scan``'s
``linear_scan``: on a CUDA tensor one hand-written kernel
(``csrc/linear_scan.cu``) that reads a and b once and writes h once; on a
CPU tensor its plain version, ceil(log2 S) Hillis-Steele passes in place
in one copy of a and b, which autograd cannot differentiate (each pass
bumps the version of tensors the previous pass saved).  The kernel has no
backward either, so the training route (``train=True``) runs the same
passes out of place (``_linear_scan_train``) and launches no kernel.
Decode is the single-step recurrence with an O(1) state.  The recurrence
runs in float32.

Channel-sharded forms (``rglru_tp``, ``rglru_decode_tp``; a model row's
devices ``devs``, the reference's layout: every weight over ``mlp`` →
``model``): model index ``j`` owns channels ``split_range(dr, M, j)``.  It
projects its columns of both branches, convolves its channels, and
computes its rows' partial of each gate's GEMM (``w_a``/``w_i`` are split
by row, as ``spec_for`` uses an axis once); the partials are summed in
float32 and each device keeps its own channels (``spmd.psum_scatter``).
The scan runs on ``[B, S, dr/M]`` (one ``linear_scan`` launch a shard on
the card), then its rows of ``out`` give a partial, ``psum``med.  The
state (``h`` and the conv rows) stays split by channel.  Where the
residual is sequence-parallel (not recurrentgemma-9b, whose config
turns it off) the caller gathers the sequence shards first and passes
``reduce=psum_scatter_rows``, as for ``mamba2.ssd_tp``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import piece
from repro_torch.kernels.rglru_scan.scan import linear_scan
from repro_torch.models.layers import (add_bias, dense, dense_cols,
                                       dense_rows, dense_spec, psum_rows,
                                       split_range)
from repro_torch.models.params import LeafSpec, zeros

RGLRU_C = 8.0


def rglru_spec(cfg) -> dict:
    d = cfg.d_model
    dr = d  # lru width = d_model for the assigned config
    w = cfg.rglru_conv_width
    return {
        "in_x": dense_spec(d, dr, ("embed", "mlp")),
        "in_gate": dense_spec(d, dr, ("embed", "mlp")),
        "conv_w": zeros((w, dr), (None, "mlp")),
        "conv_b": zeros((dr,), ("mlp",)),
        # float32 GEMMs (``_gates``): stored float32 in every store
        "w_a": dense_spec(dr, dr, ("mlp", "mlp"), cast=False),
        "w_i": dense_spec(dr, dr, ("mlp", "mlp"), cast=False),
        "lam": LeafSpec((dr,), ("mlp",), "rglru_a"),
        "out": dense_spec(dr, d, ("mlp", "embed")),
    }


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """u [B,S,dr], w [W,dr]: y_t = sum_j w_j * u_{t-W+1+j} + b.  With
    float32 taps the result is float32, as jax promotes it."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = torch.zeros_like(u)
    for j in range(W):
        y = y + pad[:, j: j + S, :] * w[j]
    return y + b


def _gates(p: dict, u: torch.Tensor):
    """a_t (decay) and gated input for the LRU, in float32.

    ``F.softplus`` returns x itself above its threshold of 20, where jax
    computes ``logaddexp(x, 0)``; the two differ by less than float32's
    rounding there (e^-20 ~ 2e-9 relative), and the init draws Lambda in
    [2.2, 6.9] (``models/params.py``), far below the threshold."""
    uf = u.float()
    return _gate_values(torch.sigmoid(dense(p["w_a"], uf)),
                        torch.sigmoid(dense(p["w_i"], uf)), p["lam"], uf)


def _gate_values(r, i, lam, uf):
    """The decay and gated input from the gates ``r``, ``i`` (float32)."""
    log_a = -RGLRU_C * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = ``h0`` or 0), the
    serving route: ``linear_scan`` (the kernel on a CUDA tensor, the
    plain passes on a CPU one).  A returned state ``h[:, -1]`` is a
    strided view; the kernel takes ``h0`` contiguous."""
    return linear_scan(a, b, None if h0 is None else h0.contiguous())


def _linear_scan_train(a: torch.Tensor, b: torch.Tensor,
                       h0: torch.Tensor | None = None) -> torch.Tensor:
    """``linear_scan_plain``'s passes out of place: each pass makes new a and
    b (its first ``off`` positions carried over), so autograd keeps every
    pass's inputs and differentiates them."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])],
                      dim=1)
        if 2 * off < S:  # the last pass needs no composed decay
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def apply_rglru(p: dict, x: torch.Tensor, cfg,
                h0: torch.Tensor | None = None,
                conv0: torch.Tensor | None = None,
                return_state: bool = False, train: bool = False):
    """Sequence form. x [B,S,d] -> y [B,S,d] (+ (h [B,dr] float32, conv
    state) with ``return_state``).  ``conv0`` [B,W-1,dr] is the conv
    history a continued prefill prepends.  The conv state is the last
    W-1 rows of ``dense(in_x, x)`` — of this call's x alone, as the
    reference takes it.  ``train`` takes the out-of-place scan."""
    W = cfg.rglru_conv_width
    gate = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    u_in = dense(p["in_x"], x)
    if conv0 is not None:  # prefill continuation: prepend conv history
        ext = torch.cat([conv0, u_in], dim=1)
        u = _causal_depthwise_conv(ext, p["conv_w"], p["conv_b"])[:, W - 1:]
    else:
        u = _causal_depthwise_conv(u_in, p["conv_w"], p["conv_b"])
    a, b = _gates(p, u)
    h = (_linear_scan_train if train else _linear_scan)(a, b, h0)
    y = dense(p["out"], (gate.float() * h).to(x.dtype))
    if return_state:
        return y, (h[:, -1, :], u_in[:, -(W - 1):, :])
    return y


def rglru_decode_step(p: dict, x: torch.Tensor, cfg, state):
    """One-token step. x [B,1,d]; state = (h [B,dr] float32, conv
    [B,W-1,dr]) -> (y [B,1,d], (h', conv')), a fresh state."""
    h_prev, conv_prev = state
    gate = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    u_new = dense(p["in_x"], x)                      # [B,1,dr]
    window = torch.cat([conv_prev, u_new], dim=1)     # [B,W,dr]
    u = torch.einsum("bwd,wd->bd", window, p["conv_w"].to(x.dtype))
    u = (u + p["conv_b"].to(x.dtype))[:, None, :]
    a, b = _gates(p, u)
    h = a[:, 0] * h_prev + b[:, 0]
    y = dense(p["out"], (gate[:, 0].float() * h).to(x.dtype))
    return y[:, None, :], (h, window[:, 1:, :])


# ---------------------------------------------------------------------------
# Channel-sharded forms (module docstring).  ``xs[j]`` is model index
# ``j``'s input, whole, on ``devs[j]``; its state is {"h": [B,dr_j]
# float32, "conv": [B,W-1,dr_j]}, its channels only.


def _gates_tp(p: dict, us: list, devs: list) -> list:
    """``_gates`` over the row: ``us[j]`` device ``j``'s channels of u ->
    [(a, gated)] of its channels, contiguous (``linear_scan`` takes no
    strided tensor)."""
    M, dr = len(devs), p["lam"].shape[0]
    ufs = [u.float() for u in us]

    def gate(w):
        return spmd.psum_scatter([dense_rows(p[w], uf, *split_range(
            dr, M, j)) for j, uf in enumerate(ufs)], -1, devs)
    out = []
    for j, (r, i, uf) in enumerate(zip(gate("w_a"), gate("w_i"), ufs)):
        lam = piece(p["lam"], uf.device, [split_range(dr, M, j)])
        a, b = _gate_values(torch.sigmoid(r), torch.sigmoid(i), lam, uf)
        out.append((a.contiguous(), b.contiguous()))
    return out


def _branches(p: dict, x: torch.Tensor, lo: int, hi: int):
    """Channels ``lo:hi`` of the gate branch and of ``in_x``'s output, and
    the conv taps and bias of those channels."""
    gate = F.gelu(dense_cols(p["in_gate"], x, lo, hi), approximate="tanh")
    W = p["conv_w"].shape[0]
    return (gate, dense_cols(p["in_x"], x, lo, hi),
            piece(p["conv_w"], x.device, [(0, W), (lo, hi)]),
            piece(p["conv_b"], x.device, [(lo, hi)]))


def _out_tp(p: dict, gates: list, hs: list, xs: list, devs: list,
            reduce=psum_rows) -> list:
    """Row-parallel ``out`` over the shards' gated states, ``reduce``d."""
    M, dr = len(devs), p["lam"].shape[0]
    return add_bias(p["out"], reduce(
        [dense_rows(p["out"], (g.float() * h).to(x.dtype),
                    *split_range(dr, M, j))
         for j, (g, h, x) in enumerate(zip(gates, hs, xs))], devs))


def rglru_tp(p: dict, xs: list, cfg, devs: list, state0s: list | None = None,
             return_state: bool = False, train: bool = False,
             reduce=psum_rows):
    """``apply_rglru`` by channel shard over the model row ``devs`` -> the
    block's output [B,S,d] on every device (+ each device's state with
    ``return_state``); ``state0s[j]``: device ``j``'s state to continue
    from (``apply_rglru``'s ``h0`` and ``conv0``); ``reduce``: the
    output's sum (``layers.attention_tp``)."""
    M, dr = len(devs), cfg.d_model
    W = cfg.rglru_conv_width
    gates, u_ins, us = [], [], []
    for j, x in enumerate(xs):
        gate, u_in, w, b = _branches(p, x, *split_range(dr, M, j))
        if state0s is not None:
            ext = torch.cat([state0s[j]["conv"], u_in], dim=1)
            u = _causal_depthwise_conv(ext, w, b)[:, W - 1:]
        else:
            u = _causal_depthwise_conv(u_in, w, b)
        gates.append(gate)
        u_ins.append(u_in)
        us.append(u)
    scan = _linear_scan_train if train else _linear_scan
    hs = [scan(a, b, None if state0s is None else state0s[j]["h"])
          for j, (a, b) in enumerate(_gates_tp(p, us, devs))]
    outs = _out_tp(p, gates, hs, xs, devs, reduce)
    if return_state:
        return outs, [{"h": h[:, -1, :], "conv": u[:, -(W - 1):, :]}
                      for h, u in zip(hs, u_ins)]
    return outs


def rglru_decode_tp(p: dict, xs: list, cfg, devs: list, states: list):
    """``rglru_decode_step`` by channel shard over ``devs``: ``xs[j]``
    [B,1,d], ``states[j]`` device ``j``'s state -> (the output [B,1,d] on
    every device, the new states: fresh tensors)."""
    M, dr = len(devs), cfg.d_model
    gates, us, windows = [], [], []
    for j, (x, st) in enumerate(zip(xs, states)):
        gate, u_new, w, b = _branches(p, x, *split_range(dr, M, j))
        window = torch.cat([st["conv"], u_new], dim=1)
        u = torch.einsum("bwd,wd->bd", window, w.to(x.dtype))
        us.append((u + b.to(x.dtype))[:, None, :])
        gates.append(gate[:, 0])
        windows.append(window[:, 1:, :])
    hs = [a[:, 0] * st["h"] + b[:, 0] for (a, b), st in
          zip(_gates_tp(p, us, devs), states)]
    outs = _out_tp(p, gates, hs, xs, devs)
    return [y[:, None, :] for y in outs], [{"h": h, "conv": c}
                                           for h, c in zip(hs, windows)]
