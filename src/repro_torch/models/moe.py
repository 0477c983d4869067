"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

Port of the reference ``models/moe.py``'s single-device path
(``_moe_gspmd``): a float32 router with top-k, a stable sort of the
(token, expert) pairs by expert id, each pair's position in its
expert's run, a scatter of the tokens into an ``[E, C, d]`` buffer
bounded by the capacity ``C = ceil8(T*k/E * capacity_factor)``, the
experts' SwiGLU as batched products, and the weighted combine through
the inverse permutation.  A pair past its expert's capacity is dropped:
its combine weight contributes 0, as in the reference.

The reference runs this dispatch in XLA (argsort, searchsorted, a
scatter, einsums) and has no Pallas kernel for it, so here it is stock
torch ops.

Expert parallelism (``moe_ep``, the reference's ``_moe_shard_map``):
on a mesh whose ``model`` axis splits the experts (``uses_ep``: kind
train or prefill, ``model`` > 1, ``E % model == 0``), each device routes
its own tokens (its sequence block where the residual is
sequence-parallel), packs the pairs by destination shard with a
per-device capacity ``Cs`` (``_route_and_pack``), ``all_to_all``s them
along ``model``, runs its ``E / model`` experts' FFN from its experts'
blocks with a second local dispatch (``_local_expert_ffn``, capacity
``C2``), ``all_to_all``s the results back and combines.  The aux loss
is over the global token population (``psum`` of the routing sums).
Capacity is per device batch, so where it binds the two forms drop
different pairs.

Dropped pairs are counted on the device, with no host sync inside
``apply_moe``; ``dropped_pairs()`` reads the count (one host read) and
``reset_dropped()`` zeroes it, as ``kernels.LAUNCHES`` is read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_spec, seq_scatter, seq_whole
from repro_torch.models.params import normal

# dropped pairs since the last ``reset_dropped``: one int64 counter per
# device, added to where the pairs are
_DROPPED: dict = {}


def dropped_pairs() -> int:
    """Pairs dropped over capacity since the last ``reset_dropped``."""
    return sum(int(c) for c in _DROPPED.values())


def reset_dropped() -> None:
    _DROPPED.clear()


def _count_dropped(n: torch.Tensor) -> None:
    c = _DROPPED.get(n.device)
    if c is None:
        _DROPPED[n.device] = n
    else:
        c += n


def moe_spec(cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    down_scale = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    ax3 = ("experts", "embed", "mlp")
    ax3T = ("experts", "mlp", "embed")
    return {
        # the router runs in float32 (``_route``): stored float32 in
        # every store
        "router": dense_spec(d, E, ("embed", None), cast=False),
        "gate": normal((E, d, ff), ax3, cast=True),
        "up": normal((E, d, ff), ax3, cast=True),
        "down": normal((E, ff, d), ax3T, scale=down_scale, cast=True),
    }


def capacity(cfg, tokens_per_device_batch: int) -> int:
    c = int(tokens_per_device_batch * cfg.top_k / cfg.n_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 (sublane alignment)


def _route(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Softmax of the router logits ``xf @ w`` [T, E], in full float32
    (TF32 held off for the product, whatever the caller set)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = xf.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.softmax(logits, dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """Each row's ``k`` most probable experts -> (their probabilities,
    their ids) [T, k].  A function of its own, as ``_route`` is, so that
    a check can hold the choice fixed while it moves the weights."""
    return torch.topk(probs, k, dim=-1)


def uses_ep(cfg, hints) -> bool:
    """Where the reference's ``apply_moe`` takes its expert-parallel
    form: a mesh with a ``model`` axis > 1 that divides the experts, in
    a sequence form (train/prefill)."""
    mesh = hints.mesh
    return (getattr(mesh, "devices", None) is not None
            and "model" in mesh.axis_names
            and hints.kind in ("train", "prefill")
            and mesh.shape["model"] > 1
            and cfg.n_experts % mesh.shape["model"] == 0)


def apply_moe(p: dict, x: torch.Tensor, cfg, hints=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d] in x's dtype, the Switch load-balancing
    aux loss, a float32 scalar): the expert-parallel form where
    ``uses_ep(cfg, hints)`` (``_moe_shard_map``), else the global one
    (``_moe_gspmd``)."""
    if hints is not None and uses_ep(cfg, hints):
        return _moe_shard_map(p, x, cfg, hints)
    return _moe_gspmd(p, x, cfg)


def _moe_gspmd(p: dict, x: torch.Tensor, cfg
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global-shape dispatch over all of ``x``'s tokens (module
    docstring)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    dev = x.device

    # -- routing (float32 for a stable softmax) ---------------------------
    probs = _route(xf, p["router"]["w"])                     # [T, E]
    top_w, top_e = _top_k(probs, k)                          # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (Switch-style)
    me = probs.mean(0)                                       # [E]
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)

    # -- sort-based dispatch ------------------------------------------------
    C = capacity(cfg, T)
    e_flat = top_e.reshape(T * k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # position within each expert's run of the sorted pair list
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - starts[e_sorted]
    kept = pos_in_e < C
    _count_dropped((~kept).sum())
    slot = torch.where(kept, e_sorted * C + pos_in_e, E * C)  # E*C = drop
    tok_sorted = order // k                                  # token of pair

    # row E*C takes every dropped pair and is cut off
    buf = xf.new_zeros((E * C + 1, d))
    buf[slot] = xf[tok_sorted]
    buf = buf[:E * C].view(E, C, d)

    # -- expert FFN (swiglu) ------------------------------------------------
    dt = x.dtype
    h = (F.silu(torch.bmm(buf, p["gate"].to(dt)))
         * torch.bmm(buf, p["up"].to(dt)))
    y_buf = torch.bmm(h, p["down"].to(dt)).reshape(E * C, d)

    # -- combine -------------------------------------------------------------
    y_sorted = torch.where(kept[:, None],
                           y_buf[torch.clamp(slot, max=E * C - 1)], 0.0)
    y_pairs = torch.empty_like(y_sorted)
    y_pairs[order] = y_sorted                        # the inverse permutation
    y = torch.einsum("tkd,tk->td", y_pairs.view(T, k, d), top_w.to(dt))
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a mesh (module docstring)


def _ceil8(c: int) -> int:
    return max(8, -(-c // 8) * 8)


def _route_and_pack(xf, top_e, E_loc: int, ms: int, Cs: int):
    """Sort the pairs by (destination shard, expert) and pack them into
    ``[ms * Cs]`` send slots -> (send_x, send_e (local expert id;
    ``E_loc`` marks an empty slot), order, kept, slot): the inverse
    mapping unpacks what comes back."""
    T, k = top_e.shape
    dev = xf.device
    e_flat = top_e.reshape(T * k)
    order = torch.argsort(e_flat, stable=True)  # by expert => by dest
    e_s = e_flat[order]
    dest_s = e_s // E_loc
    starts = torch.searchsorted(dest_s, torch.arange(ms, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[dest_s]
    kept = pos < Cs
    slot = torch.where(kept, dest_s * Cs + pos, ms * Cs)
    # row ms*Cs takes every dropped pair and is cut off
    send_x = xf.new_zeros((ms * Cs + 1, xf.shape[1]))
    send_x[slot] = xf[order // k]
    send_e = torch.full((ms * Cs + 1,), E_loc, dtype=torch.long, device=dev)
    send_e[slot] = e_s % E_loc
    _count_dropped((~kept).sum())
    return send_x[:ms * Cs], send_e[:ms * Cs], order, kept, slot


def _local_expert_ffn(rx, re, gw, uw, dw, E_loc: int, C2: int):
    """The second (local) dispatch by expert id, capacity ``C2``, and the
    experts' SwiGLU -> each received row's output (0 for an empty or
    dropped slot)."""
    Trecv, d = rx.shape
    dev = rx.device
    order2 = torch.argsort(re, stable=True)  # empty slots (E_loc) last
    re_s = re[order2]
    starts2 = torch.searchsorted(re_s, torch.arange(E_loc, device=dev))
    pos2 = (torch.arange(Trecv, device=dev)
            - starts2[torch.clamp(re_s, 0, E_loc - 1)])
    kept2 = (re_s < E_loc) & (pos2 < C2)
    _count_dropped(((re_s < E_loc) & ~kept2).sum())
    slot2 = torch.where(kept2, re_s * C2 + pos2, E_loc * C2)
    buf = rx.new_zeros((E_loc * C2 + 1, d))
    buf[slot2] = rx[order2]
    buf = buf[:E_loc * C2].view(E_loc, C2, d)
    h = F.silu(torch.bmm(buf, gw)) * torch.bmm(buf, uw)
    y_buf = torch.bmm(h, dw).reshape(E_loc * C2, d)
    y2 = torch.where(kept2[:, None],
                     y_buf[torch.clamp(slot2, max=E_loc * C2 - 1)], 0.0)
    y_recv = torch.empty_like(rx)
    y_recv[order2] = y2.to(rx.dtype)
    return y_recv


def moe_ep(p: dict, X: list, cfg, hints, grid):
    """The expert-parallel MoE over the grid: ``X[r][j]`` is batch block
    ``r``'s input on ``grid[r, j]``: its sequence shard [Br, S_j, d]
    under sequence parallelism (the reference's ``shard_map`` over the
    ``residual`` spec), else the whole [Br, S, d].  Each device routes
    and dispatches the tokens it holds.  -> (the outputs in the same
    layout, the aux loss on ``grid[0, 0]``)."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import piece, whole
    R, M = grid.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // M
    d = X[0][0].shape[-1]
    dt = X[0][0].dtype
    cells = []       # per (r, j): its local routing
    for r in range(R):
        for j in range(M):
            x, dev = X[r][j], grid[r, j]
            xf = x.reshape(-1, d)
            probs = _route(xf, whole(p["router"]["w"], dev))
            top_w, top_e = _top_k(probs, k)
            top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True),
                                        min=1e-9)
            cells.append({"x": x, "xf": xf, "probs": probs, "top_w": top_w,
                          "top_e": top_e})
    # aux load-balance loss over the GLOBAL token population
    every = [grid[r, j] for r in range(R) for j in range(M)]
    dev0 = grid[0, 0]
    me = spmd.psum([c["probs"].sum(0) for c in cells], every)[0].to(dev0)
    ce = spmd.psum([F.one_hot(c["top_e"][:, 0], E).float().sum(0)
                    for c in cells], every)[0].to(dev0)
    n_tok = float(sum(c["xf"].shape[0] for c in cells))
    aux = E * torch.sum((me / n_tok) * (ce / n_tok))

    # the largest shard's tokens: the reference's padded shard
    T = max(c["xf"].shape[0] for c in cells)
    Cs = _ceil8(int(T * k / M * cfg.capacity_factor))
    C2 = _ceil8(int(M * Cs * cfg.capacity_factor / E_loc))
    for c in cells:
        (c["send_x"], c["send_e"], c["order"], c["kept"],
         c["slot"]) = _route_and_pack(c["xf"], c["top_e"], E_loc, M, Cs)
    out = []
    for r in range(R):
        devs = list(grid[r])
        row = cells[r * M:(r + 1) * M]
        rx = spmd.all_to_all([c["send_x"] for c in row], 0, 0, devs)
        re = spmd.all_to_all([c["send_e"] for c in row], 0, 0, devs)
        y_recv = []
        for j, dev in enumerate(devs):
            ex = [(j * E_loc, (j + 1) * E_loc)]
            y_recv.append(_local_expert_ffn(
                rx[j], re[j], piece(p["gate"], dev, ex).to(dt),
                piece(p["up"], dev, ex).to(dt),
                piece(p["down"], dev, ex).to(dt), E_loc, C2))
        yb = spmd.all_to_all(y_recv, 0, 0, devs)
        ys = []
        for c, y in zip(row, yb):
            y_sorted = torch.where(c["kept"][:, None],
                                   y[torch.clamp(c["slot"], max=M * Cs - 1)],
                                   0.0)
            y_pairs = torch.empty_like(y_sorted)
            y_pairs[c["order"]] = y_sorted
            yl = torch.einsum("tkd,tk->td", y_pairs.view(-1, k, d),
                              c["top_w"].to(dt))
            ys.append(yl.reshape(c["x"].shape))
        out.append(ys)
    return out, aux


def _moe_shard_map(p: dict, x: torch.Tensor, cfg, hints):
    """``apply_moe``'s expert-parallel form on a whole ``x`` [B,S,d]:
    its batch blocks copied to the grid (their sequence shards under
    sequence parallelism), ``moe_ep``, the outputs gathered back to
    ``x``'s device."""
    grid = hints.grid()
    R, M = grid.shape
    sp = hints.seq_parallel()
    xr = x.chunk(R, 0)
    ys, aux = moe_ep(p, [seq_scatter(xr[r], list(grid[r]), sp)
                         for r in range(R)], cfg, hints, grid)
    return (torch.cat([seq_whole(ys[r], x.device, sp) for r in range(R)], 0),
            aux.to(x.device))
