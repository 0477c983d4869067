"""Composite sorts built on the bitonic kernels (port of the reference
``kernels/sortmerge/ops.py``).

``device_sort`` / ``device_sort_kv`` call the kernel wrappers, which
launch the CUDA kernels on CUDA tensors and run the plain versions on CPU
tensors.

Tagged-key stable variants: the bitonic network is not order-preserving,
so the paper's chained-sort lexsort (SU unique filter, §2.3) cannot run
through it directly.  ``device_stable_sort_perm`` packs
``(key - kmin) << tag_bits | lane_index`` into a single int64 so that the
*unstable* bitonic sort of the tagged keys is a *stable* sort of the raw
keys — equal keys order by lane index, i.e. original position.  All
tagged values are distinct, so the low bits of the sorted array ARE the
permutation: no payload lane.  ``device_dedup_rows`` chains one tagged
sort per column (least-significant first) to get exactly numpy's stable
``lexsort``, then neighbor-compares.

Width guard: tagging needs ``ceil(log2(cap))`` low bits, so the key span
``kmax - kmin`` must fit the remaining ``63 - tag_bits`` — the *caller*
checks ``fits_tagged_width`` and takes the stock-torch stable-sort
fallback otherwise (see backend/torch_ops.py), so no int64 shift ever
runs on keys too wide to tag.

Incremental merge maintenance: an append to a version-stamped column is
an O(Δ) change, so re-running the full O(N log N) tagged sort per append
wastes exactly the asymptotics the semi-naive fixpoint saves elsewhere.
``device_merge_runs`` merges two individually sorted runs with two rank
launches (``merge_ranks``) plus one stock-torch scatter — final position
= own lane + rank in the other run, stable with left-run-first ties.
``merge_sorted_mirror_impl`` is the index-maintenance composite built on
it: slice the appended tail out of the resident column buffer,
tagged-sort only the tail (O(Δ log Δ)), re-base the resident tagged run
if the key minimum moved, merge, and de-tag — nothing touches the host.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sortmerge.sortmerge import (bitonic_sort,
                                                     bitonic_sort_kv,
                                                     merge_ranks)

INT64_MAX = torch.iinfo(torch.int64).max


def device_sort(x: torch.Tensor) -> torch.Tensor:
    return bitonic_sort(x)


def device_sort_kv(keys: torch.Tensor, vals: torch.Tensor):
    return bitonic_sort_kv(keys, vals)


# ---------------------------------------------------------------------------
# Tagged-key stable variants


def tag_bits_for(cap: int) -> int:
    """Low bits needed to tag every lane of a padded buffer of size ``cap``."""
    return max(1, (cap - 1).bit_length())


def fits_tagged_width(kmin: int, kmax: int, cap: int) -> bool:
    """True iff keys spanning [kmin, kmax] can be tagged at buffer size
    ``cap``: the span plus one pad code must fit ``63 - tag_bits`` bits
    (python ints — no intermediate overflow)."""
    span = int(kmax) - int(kmin) + 1  # pad code is span itself -> +1 codes
    return span + 1 <= (1 << (63 - tag_bits_for(cap)))


def _tag(keys: torch.Tensor, real: torch.Tensor, lane: torch.Tensor,
         kmin: int, tag_bits: int) -> torch.Tensor:
    """Tagged codes: real lanes ``(key - kmin) << tag_bits | lane``, pad
    lanes the max code for this width, strictly above every real code
    (``fits_tagged_width`` keeps real codes <= max_code - 1)."""
    max_code = (1 << (63 - tag_bits)) - 1
    # pad content is arbitrary: zero it before the shift so no pad lane
    # shifts a value wider than the tag leaves room for
    k = torch.where(real, keys - kmin, 0)
    return torch.where(real, (k << tag_bits) | lane,
                       (max_code << tag_bits) | lane)


def device_stable_sort_perm(keys: torch.Tensor, n_real: int, kmin: int, *,
                            tag_bits: int):
    """Stable (sorted keys, permutation) of ``keys[:n_real]``.

    ``keys``: signed integer, padded to a power-of-two ``cap`` (pad
    content is ignored — pad lanes are re-tagged past every real key).
    Returns full-``cap`` int64 tensors; lanes >= n_real hold int64-max /
    their own index.
    """
    keys = keys.to(torch.int64)
    cap = keys.shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=keys.device)
    real = lane < n_real
    s = device_sort(_tag(keys, real, lane, int(kmin), tag_bits))
    perm = s & ((1 << tag_bits) - 1)
    skeys = torch.where(real, (s >> tag_bits) + int(kmin),
                        torch.iinfo(torch.int64).max)
    return skeys, perm


def device_dedup_rows(cols, n_real: int, kmins, *, tag_bits: int):
    """SU unique filter over multi-column rows via chained tagged sorts.

    ``cols``: int64 tensors padded to ``cap``; ``kmins``: per-column
    minima (python ints, host-computed).  Chains one stable tagged sort
    per column, least-significant first — exactly numpy's
    ``lexsort(tuple(reversed(cols)))`` — then keeps the first row of each
    equal run.  Returns (ascending kept row ids padded with ``cap``, kept
    count as a 0-d tensor).
    """
    cap = cols[0].shape[0]
    dev = cols[0].device
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    mask = (1 << tag_bits) - 1
    order = lane
    for ci in range(len(cols) - 1, -1, -1):
        k = cols[ci][order].to(torch.int64)
        s = device_sort(_tag(k, order < n_real, lane, int(kmins[ci]),
                             tag_bits))
        order = order[s & mask]
    diff = torch.zeros(cap, dtype=torch.bool, device=dev)
    diff[0] = True
    for c in cols:
        cs = c[order]
        diff[1:] |= cs[1:] != cs[:-1]
    keep = diff & (order < n_real)
    rows = torch.sort(torch.where(keep, order, cap)).values
    return rows, keep.sum()


# ---------------------------------------------------------------------------
# Incremental merge maintenance


def _run_ranks(a, b, n_a: int, n_b: int):
    """Ranks for a stable two-run merge: for each ``a`` lane the count of
    *real* ``b`` elements strictly below it (side left), and for each
    ``b`` lane the count of real ``a`` elements at or below it (side
    right) — a's elements win ties, which is what makes the merge of two
    stable runs equal the full stable sort.  Pad tails must sort above
    every real key on both sides (the searches run over the full padded
    arrays), and ranks are clamped by the other run's real length so pad
    *content* never leaks into positions."""
    ra = merge_ranks(a, b, side_right=False)
    rb = merge_ranks(b, a, side_right=True)
    return (ra.to(torch.int64).clamp(max=n_b),
            rb.to(torch.int64).clamp(max=n_a))


def _scatter_runs(out, a, pos_a, b, pos_b):
    """``out[pos] = run`` for both runs, where ``pos == len(out)`` marks a
    lane to drop (the reference's ``.at[].set(mode="drop")``): scatter
    into one spare slot past the end, then cut it off."""
    cap = out.shape[0]
    buf = torch.cat([out, out[:1]])
    buf[pos_a] = a
    buf[pos_b] = b
    return buf[:cap]


def device_merge_runs(a, b, n_a: int, n_b: int):
    """Bounded two-run merge: ``a[:n_a]`` and ``b[:n_b]`` are each sorted
    ascending; returns one sorted array of ``a.shape[0]`` lanes whose
    real prefix ``[:n_a + n_b]`` is the stable merge (ties keep ``a``
    elements first) and whose pad tail is ``int64 max``.

    Shape contract: the output capacity is ``a.shape[0]`` — the caller
    guarantees ``n_a + n_b <= a.shape[0]`` and pads both inputs with
    ``int64 max`` tails."""
    cap = a.shape[0]
    ra, rb = _run_ranks(a, b, n_a, n_b)
    lane_a = torch.arange(cap, dtype=torch.int64, device=a.device)
    lane_b = torch.arange(b.shape[0], dtype=torch.int64, device=a.device)
    pos_a = torch.where(lane_a < n_a, lane_a + ra, cap)
    pos_b = torch.where(lane_b < n_b, lane_b + rb, cap)
    out = torch.full((cap,), INT64_MAX, dtype=torch.int64, device=a.device)
    return _scatter_runs(out, a, pos_a, b, pos_b)


def _pad_codes(cap: int, tag_bits: int, device) -> torch.Tensor:
    """Per-lane pad codes that sort strictly above every real tagged code
    at this width (``fits_tagged_width`` keeps real high parts below
    ``max_code``)."""
    max_code = (1 << (63 - tag_bits)) - 1
    return (max_code << tag_bits) | torch.arange(cap, dtype=torch.int64,
                                                 device=device)


def merge_sorted_mirror_impl(buf, base_tagged, n_run: int, delta_start: int,
                             n_total: int, kmin: int, kmin_old: int, *,
                             dcap: int, tag_bits: int):
    """Incremental (sorted, perm) maintenance for an append-only column.

    ``buf``: the resident padded column buffer at the *new* version
    (rows ``[delta_start, n_total)`` are the appended tail).
    ``base_tagged``: the resident sorted run in tagged form — ``(key -
    kmin_old) << tag_bits | row`` for lanes ``< n_run``, pad codes
    above.  ``n_run`` and ``delta_start`` coincide for a full mirror; a
    tombstone-compacted mirror has ``n_run < delta_start`` (the run holds
    only the alive rows of the first ``delta_start`` source rows, with
    *original* row ids in the low bits).  Steps:

    1. slice the ``dcap``-lane appended tail out of ``buf`` and
       tagged-sort it with *absolute* lane tags (``lane + delta_start``)
       — the O(Δ log Δ) part;
    2. re-base the resident run's codes if the key minimum moved (``kmin
       < kmin_old``: a constant shift of the high part, order preserved);
    3. merge the two runs (ranks + scatter, O(N));
    4. de-tag: sorted keys (pads ``int64 max``) + permutation (pads own
       index) — bit-identical to a full stable re-sort of the run's rows
       plus the tail.  The real merged prefix is ``n_run + (n_total -
       delta_start)`` lanes.

    Returns ``(sorted_keys, perm, merged_tagged)`` — the caller stores
    ``merged_tagged`` back as the next resident run.
    """
    buf = buf.to(torch.int64)
    dev = buf.device
    cap = buf.shape[0]
    d = n_total - delta_start
    n_real = n_run + d
    # 1. tagged delta run.  The dcap-lane window may not fit past
    # delta_start near the top of the buffer, so it slides back and the
    # real rows are masked by their *global* lane
    start = min(delta_start, cap - dcap)
    seg = buf[start:start + dcap]
    lane_d = torch.arange(dcap, dtype=torch.int64, device=dev)
    gl = lane_d + start
    real_d = (gl >= delta_start) & (gl < n_total)
    # pad content is arbitrary: zero it before the shift
    k = torch.where(real_d, seg - kmin, 0)
    drun = torch.where(real_d, (k << tag_bits) | gl,
                       _pad_codes(dcap, tag_bits, dev))
    drun = device_sort(drun)
    # 2. re-base the resident run to the new key minimum
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    real = lane < n_run
    shift = (kmin_old - kmin) << tag_bits
    base = torch.where(real, torch.where(real, base_tagged, 0) + shift,
                       _pad_codes(cap, tag_bits, dev))
    # 3. merge (tagged codes are all distinct, so ties cannot occur)
    ra, rb = _run_ranks(base, drun, n_run, d)
    pos_a = torch.where(real, lane + ra, cap)
    pos_b = torch.where(lane_d < d, lane_d + rb, cap)
    merged = _scatter_runs(_pad_codes(cap, tag_bits, dev), base, pos_a,
                           drun, pos_b)
    # 4. de-tag (codes are non-negative, so >> is a logical shift here)
    perm = merged & ((1 << tag_bits) - 1)
    skeys = torch.where(lane < n_real, (merged >> tag_bits) + kmin,
                        INT64_MAX)
    return skeys, perm, merged


def tagged_from_sorted(skeys, perm, n_real: int, kmin: int, *,
                       tag_bits: int):
    """Re-pack a (sorted, perm) mirror into its tagged-run form — the
    seed a full sort leaves behind so the *next* append can take the
    merge path instead of re-sorting."""
    cap = skeys.shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=skeys.device)
    real = lane < n_real
    k = torch.where(real, skeys - kmin, 0)
    return torch.where(real, (k << tag_bits) | perm,
                       _pad_codes(cap, tag_bits, skeys.device))
