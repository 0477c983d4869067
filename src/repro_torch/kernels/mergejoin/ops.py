"""Sort-merge join built on the probe and key-value sort kernels (port of
the reference ``kernels/mergejoin/ops.py``).

``merge_join_bounded`` is the fixed-capacity join; the expansion of
(lo, hi) runs into pairs is the searchsorted-on-prefix-sums trick (pure
index arithmetic, stock torch ops — the reference leaves the same work to
XLA outside its Pallas kernels).

``merge_join_gather_bounded`` is the fused device-pipeline form: the same
probe + expansion, but candidate pairs are refined (multi-key / hash
verification) and the joined *payload columns* are gathered and compacted
on device — the ``(li, ri)`` pair arrays never exist on host.  Inputs
follow the handle-tier convention (pad lanes are garbage; real lanes are
``[:n]``), so the keys are re-padded with the join sentinels here instead
of by the caller.

The reference's ``.at[...].set(mode="drop")`` scatters become scatters
into a ``cap + 1`` buffer whose last lane takes every dropped write and is
sliced off.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mergejoin.mergejoin import probe_sorted
from repro_torch.kernels.sortmerge.ops import device_sort_kv

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _u64_const(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _u64_const(0x9E3779B97F4A7C15)
_MUL1 = _u64_const(0xBF58476D1CE4E5B9)
_MUL2 = _u64_const(0x94D049BB133111EB)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64_dev(x: torch.Tensor) -> torch.Tensor:
    """Device twin of ``backend.base.splitmix64`` on int64 lanes: adds and
    products wrap mod 2**64, so the bits equal the uint64 original."""
    z = x.to(torch.int64) + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MUL1
    z = (z ^ _shr(z, 27)) * _MUL2
    return z ^ _shr(z, 31)


def _scatter_drop(out_cap: int, tgt: torch.Tensor, src: torch.Tensor
                  ) -> torch.Tensor:
    """``zeros(out_cap).at[tgt].set(src, mode="drop")`` for ``tgt`` in
    ``[0, out_cap]`` (``out_cap`` marks a dropped lane)."""
    out = torch.zeros(out_cap + 1, dtype=src.dtype, device=src.device)
    out[tgt] = src
    return out[:out_cap]


def _expand(lo, counts, out_cap: int, cap_l: int):
    """Candidate pair lanes: for each output lane, its left row and the
    offset inside that row's right-side run."""
    starts = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    out_idx = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
    row = (torch.searchsorted(starts, out_idx, right=True) - 1).clamp(
        0, cap_l - 1)
    within = out_idx - starts[row]
    return row, within, out_idx, total


def merge_join_bounded(l_keys: torch.Tensor, r_keys: torch.Tensor,
                       out_cap: int):
    """Equi-join -> (li, ri, valid, total).  li/ri index the *original*
    (unsorted) inputs; up to ``out_cap`` pairs are emitted.  The caller
    pads the left side with int64 max and the right with int64 min."""
    l_keys = l_keys.to(torch.int64)
    r_keys = r_keys.to(torch.int64)
    m = r_keys.shape[0]
    r_sorted, r_perm = device_sort_kv(
        r_keys, torch.arange(m, dtype=torch.int32, device=r_keys.device))
    lo, hi = probe_sorted(l_keys, r_sorted)
    counts = (hi - lo).to(torch.int64)
    row, within, out_idx, total = _expand(lo, counts, out_cap,
                                          l_keys.shape[0])
    valid = (out_idx < total) & (within < counts[row])
    ri = r_perm[(lo[row] + within).clamp(0, m - 1)]
    li = row.to(torch.int32)
    return (torch.where(valid, li, -1), torch.where(valid, ri, -1), valid,
            total)


def pack_pairs_bounded(li, ri, valid):
    """Pack a bounded join's pair output into one int64 tensor
    (``li << 32 | ri``) so the host-materializing path downloads a single
    transfer.  Pairs are a prefix (``valid`` lanes come first), so the
    caller slices ``[:total]`` before the download."""
    li64 = torch.where(valid, li, 0).to(torch.int64)
    ri64 = torch.where(valid, ri, 0).to(torch.int64)
    return (li64 << 32) | (ri64 & 0xFFFFFFFF)


def device_compact(cols, mask: torch.Tensor, n_real: int):
    """Stable-compact every column to the lanes where ``mask`` holds
    (lanes >= ``n_real`` are pads and never survive).  Returns cap-sized
    tensors whose kept lanes form the prefix, plus the kept count."""
    cap = cols[0].shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=mask.device)
    ok = mask & (lane < n_real)
    pos = torch.cumsum(ok.to(torch.int64), 0) - 1
    tgt = torch.where(ok, pos, cap)
    outs = tuple(_scatter_drop(cap, tgt, c) for c in cols)
    return outs, ok.sum()


def merge_join_gather_bounded(l_keys, r_keys, n_l: int, n_r: int,
                              l_pay, r_pay, verify_l, verify_r,
                              out_cap: int, hash_keys: bool = False):
    """Fused sort-merge join + verify + payload gather.

    Joins ``l_keys[:n_l]`` with ``r_keys[:n_r]`` (``hash_keys`` joins on
    the splitmix64 domain with exact-key verification — the HJ axis),
    refines candidates on the ``(verify_l[i], verify_r[i])`` column pairs
    (multi-key joins), then gathers each payload column at the surviving
    pairs and compacts to a prefix.  Returns

        (l_out, r_out, stats)  with  stats = [total, total0, hash_bad]

    ``total`` — surviving pairs (the real result length), ``total0`` —
    candidate pairs *before* verification (if > ``out_cap`` the caller
    must re-run with a larger capacity: candidates past the cap were
    dropped unverified), ``hash_bad`` — a real hashed right key collided
    with the right pad sentinel (astronomically rare; the caller redoes
    the join on the host).
    """
    l_keys = l_keys.to(torch.int64)
    r_keys = r_keys.to(torch.int64)
    cap_l, cap_r = l_keys.shape[0], r_keys.shape[0]
    dev = l_keys.device
    lane_l = torch.arange(cap_l, dtype=torch.int64, device=dev)
    lane_r = torch.arange(cap_r, dtype=torch.int64, device=dev)
    real_l, real_r = lane_l < n_l, lane_r < n_r
    if hash_keys:
        lk_dom = splitmix64_dev(l_keys)
        rk_dom = splitmix64_dev(r_keys)
        # a real hashed right key equal to the right pad sentinel would
        # let real left keys match pad lanes; the symmetric left case is
        # harmless because left-pad counts are zeroed below
        hash_bad = (real_r & (rk_dom == _I64_MIN)).any()
    else:
        lk_dom, rk_dom = l_keys, r_keys
        hash_bad = torch.zeros((), dtype=torch.bool, device=dev)
    # handle-tier pads are garbage: re-pad with the join sentinels here
    # (left MAX / right MIN, so pads can never produce pairs)
    lk = torch.where(real_l, lk_dom, _I64_MAX)
    rk = torch.where(real_r, rk_dom, _I64_MIN)
    r_sorted, r_perm = device_sort_kv(
        rk, torch.arange(cap_r, dtype=torch.int32, device=dev))
    lo, hi = probe_sorted(lk, r_sorted)
    # left pads probe MAX and would count pairs whenever a real right key
    # equals MAX; zeroing their counts makes that collision structurally
    # impossible (the remaining guard — a real *left* key equal to the
    # right pad sentinel MIN — is checked by the caller via handle bounds)
    counts = torch.where(real_l, (hi - lo).to(torch.int64), 0)
    row, within, out_idx, total0 = _expand(lo, counts, out_cap, cap_l)
    ok = out_idx < total0  # candidates are emitted as a prefix
    li = row
    ri = r_perm[(lo[row] + within).clamp(0, cap_r - 1)].to(torch.int64)
    if hash_keys:
        ok = ok & (l_keys[li] == r_keys[ri])
    for vl, vr in zip(verify_l, verify_r):
        ok = ok & (vl[li] == vr[ri])
    pos = torch.cumsum(ok.to(torch.int64), 0) - 1
    tgt = torch.where(ok, pos, out_cap)
    l_out = tuple(_scatter_drop(out_cap, tgt, p[li]) for p in l_pay)
    r_out = tuple(_scatter_drop(out_cap, tgt, p[ri]) for p in r_pay)
    stats = torch.stack([ok.sum(), total0, hash_bad.to(torch.int64)])
    return l_out, r_out, stats
