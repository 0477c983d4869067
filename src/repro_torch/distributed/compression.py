"""Transport compression of the frontier exchange: exact integer lane
codecs.

The sharded engine's all-to-all moves three int64 lanes per row (packed
key / value / meta).  A per-round, per-lane frame-of-reference narrowing
shrinks the wire format to the smallest signed dtype that holds the
lane's span — **losslessly**: the shift is undone bit-exactly on the
receive side, so the sharded fixpoint stays bit-identical to the
uncompressed transport.  Lanes whose span does not narrow (the value
lane may hold arbitrary bit patterns) ship raw.  The narrow dtype's
``iinfo.max`` doubles as the empty-slot sentinel on the meta lane, which
is why a plan reserves headroom above the lane's maximum.

The port's copy of the lane plans of the reference's
``distributed/compression.py`` (numpy only).  The int8 gradient
all-reduce of that module belongs to training and is not ported yet
(ROADMAP A11).
"""

from __future__ import annotations

import numpy as np

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
