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
torch ops.  Its expert-parallel path (``_moe_shard_map``: experts split
over a mesh's model axis, two all-to-alls) waits for the LM's sharding
(ROADMAP A11.5).

Dropped pairs are counted on the device, with no host sync inside
``apply_moe``; ``dropped_pairs()`` reads the count (one host read) and
``reset_dropped()`` zeroes it, as ``kernels.LAUNCHES`` is read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_spec
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


def apply_moe(p: dict, x: torch.Tensor, cfg, expert_shards: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d] in x's dtype, the Switch load-balancing
    aux loss, a float32 scalar).

    ``expert_shards`` > 1 asks for the reference's expert-parallel
    dispatch over that many shards of the model axis, which raises."""
    if expert_shards > 1:
        raise NotImplementedError(
            "expert-parallel MoE dispatch (the reference's _moe_shard_map) "
            "waits for the LM's sharding (ROADMAP A11.5)")
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
