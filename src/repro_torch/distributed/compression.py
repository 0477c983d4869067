"""Transport compression: exact integer lane codecs + int8 gradient
quantization.

Two unrelated consumers share this module because both sit on the slow
links:

* **Frontier-exchange lanes** (``lane_plan``/``narrow_lane``/
  ``widen_lane``): the sharded engine's all-to-all moves three int64 lanes per row (packed
key / value / meta).  A per-round, per-lane frame-of-reference narrowing
shrinks the wire format to the smallest signed dtype that holds the
lane's span — **losslessly**: the shift is undone bit-exactly on the
receive side, so the sharded fixpoint stays bit-identical to the
uncompressed transport.  Lanes whose span does not narrow (the value
lane may hold arbitrary bit patterns) ship raw.  The narrow dtype's
``iinfo.max`` doubles as the empty-slot sentinel on the meta lane, which
is why a plan reserves headroom above the lane's maximum.
* **Gradient reduction** (``quantize_int8``/``compressed_psum``): int8
  error-feedback quantization for the data-parallel gradient all-reduce
  — lossy per step, unbiased over steps via the residual carry.  Each
  replica's int8 codes and scale are what cross to the other devices;
  each device dequantizes them and sums in the axis's order.

Port of the reference's ``distributed/compression.py``: the lane plans
in numpy as there, the int8 half in torch.
"""

from __future__ import annotations

import numpy as np
import torch

#: headroom (in codes) kept above a lane's maximum so the narrow
#: dtype's ``iinfo.max`` can serve as the receive-side empty-slot
#: sentinel without colliding with a real row.
_LANE_RESERVE = 2


def lane_plan(cols: list[np.ndarray]) -> tuple[int, np.dtype] | None:
    """Frame-of-reference plan for one logical lane split across source
    shards.  Returns ``(ref, dtype)`` when the lane's global span fits a
    sub-int64 signed dtype with sentinel headroom, else ``None`` (ship
    raw int64)."""
    lo = hi = None
    for c in cols:
        if len(c) == 0:
            continue
        clo, chi = int(c.min()), int(c.max())
        lo = clo if lo is None else min(lo, clo)
        hi = chi if hi is None else max(hi, chi)
    if lo is None:
        return None
    span = hi - lo
    for dt in (np.int8, np.int16, np.int32):
        if span <= int(np.iinfo(dt).max) - _LANE_RESERVE:
            return lo, np.dtype(dt)
    return None


def narrow_lane(col: np.ndarray, plan: tuple[int, np.dtype] | None
                ) -> np.ndarray:
    """Encode one shard's slice of a lane for the wire (exact)."""
    if plan is None:
        return np.asarray(col, np.int64)
    ref, dt = plan
    return (np.asarray(col, np.int64) - ref).astype(dt)


def widen_lane(col: np.ndarray, plan: tuple[int, np.dtype] | None
               ) -> np.ndarray:
    """Bit-exact decode of a wire lane back to int64."""
    if plan is None:
        return np.asarray(col, np.int64)
    ref, _dt = plan
    return col.astype(np.int64) + ref


def lane_sentinel(plan: tuple[int, np.dtype] | None) -> int:
    """Empty-slot sentinel in the lane's *wire* domain (int64 max for
    raw lanes, narrow-dtype max for coded ones — the reserved headroom
    guarantees no real row encodes to it)."""
    if plan is None:
        return int(np.iinfo(np.int64).max)
    return int(np.iinfo(plan[1]).max)


def wire_itemsize(plan: tuple[int, np.dtype] | None) -> int:
    return 8 if plan is None else plan[1].itemsize


# ---------------------------------------------------------------------------
# int8 error-feedback gradient reduction


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale): round half
    to even, as the reference's ``jnp.round``."""
    amax = torch.amax(torch.abs(x)) if x.numel() else x.new_zeros(())
    scale = torch.clamp(amax.float(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def error_feedback(x: torch.Tensor, residual: torch.Tensor):
    """One replica's side of the error-feedback all-reduce -> (q, scale,
    new residual): it sends ``q, scale = quantize_int8(x + r)`` and keeps
    ``x + r - dequantize(q, scale)``, so the error is carried into the
    next step instead of being lost."""
    target = x.float() + residual.to(x.device)
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def sum_codes(sent, devices) -> list:
    """The mean of the replicas' dequantized codes (``sent``: one (q,
    scale) a replica) on every device: each device receives the int8
    codes and scales, dequantizes them and sums in the axis's order."""
    done, out = {}, []
    for d in devices:
        if d not in done:
            acc = dequantize_int8(sent[0][0].to(d), sent[0][1].to(d))
            for q, scale in sent[1:]:
                acc = acc + dequantize_int8(q.to(d), scale.to(d))
            done[d] = acc / len(sent)
        out.append(done[d])
    return out


def compressed_psum(xs, residuals, devices=None):
    """Error-feedback int8 all-reduce over one mesh axis: ``xs[i]`` and
    ``residuals[i]`` are replica ``i``'s value and carried error, on
    ``devices[i]``.  Returns (the mean on every device, the new
    residuals): ``error_feedback`` on each replica, ``sum_codes``."""
    devices = list(devices) if devices is not None else [x.device
                                                          for x in xs]
    sent, new_res = [], []
    for x, r in zip(xs, residuals):
        q, scale, nr = error_feedback(x, r)
        sent.append((q, scale))
        new_res.append(nr)
    return sum_codes(sent, devices), new_res


def init_residuals(grads):
    from repro_torch.models.params import tree_map
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads(grads, residuals) -> list:
    """One replica's half of ``compressed_grad_reduce``: its int8 codes
    (q, scale) a leaf, in ``tree_leaves``' order, each new residual
    written into its leaf of ``residuals`` in place.  A replica's
    gradients may be freed as soon as this returns."""
    from repro_torch.models.params import tree_leaves
    codes = []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        q, scale, nr = error_feedback(g, r)
        with torch.no_grad():
            r.copy_(nr)
        codes.append((q, scale))
        del nr
    return codes


def reduce_codes(codes, like, devices) -> list:
    """The other half: the replicas' codes (``compress_grads`` each) ->
    on each of ``devices`` the reduced gradient tree, in ``like``'s
    layout and leaf dtypes."""
    from repro_torch.models.params import tree_leaves
    leaves = tree_leaves(like)
    out = [[None] * len(leaves) for _ in devices]
    for k, leaf in enumerate(leaves):
        for i, mean in enumerate(sum_codes([c[k] for c in codes],
                                           devices)):
            out[i][k] = mean.to(leaf.dtype)
    return [_refill(like, o) for o in out]


def compressed_grad_reduce(grads, residuals, devices=None):
    """``compressed_psum`` leaf by leaf: ``grads`` and ``residuals`` are
    lists over the axis's replicas of trees of one layout, replica ``i``
    on ``devices[i]``.  Returns (the replicas' reduced gradient trees,
    in each leaf's dtype, and their new residual trees — the residual
    leaves given, updated in place)."""
    from repro_torch.models.params import tree_leaves
    devices = list(devices) if devices is not None else [
        tree_leaves(g)[0].device for g in grads]
    codes = [compress_grads(g, r) for g, r in zip(grads, residuals)]
    return reduce_codes(codes, grads[0], devices), residuals


def _refill(tree, leaves):
    """``tree``'s layout with its leaves, in ``tree_leaves``' order
    (dict keys sorted), replaced by ``leaves``."""
    from repro_torch.models.params import tree_leaves, tree_map
    by_id = {id(x): v for x, v in zip(tree_leaves(tree), leaves)}
    return tree_map(lambda x: by_id[id(x)], tree)


def reduced_bytes(grads) -> dict:
    """Bytes one replica sends per reduction: int8 codes plus a float32
    scale a leaf, beside the float32 values uncompressed."""
    from repro_torch.models.params import tree_leaves
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    return {"int8": n + 4 * len(leaves), "float32": 4 * n}
