#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--scale N] [--seed S] [--reps R]``

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``); exit non-zero when
   torch sees no CUDA device;
2. build every CUDA kernel of the port from the sources in the checkout;
3. engine phase: ``lubm_like(--scale)`` loaded, inferred and queried on
   the ``torch`` backend (``eval_mode="full"``) five times: ``infer1``
   and ``query1`` with raw resident columns (``compress=False``), the
   same two with the reference's default compressed tier
   (``compress=True``), and ``query1`` compressed with
   ``sort_mode="sketch"`` (the device sketch); each run's decoded-fact
   checksum, ``facts_inferred`` and every query's row set equal to the
   port's ``numpy`` backend on the same facts, and each compressed run's
   coded resident bytes below its raw ones; the sort kernels' launches
   counted by log2 of the padded length (``engine_sort_sizes``).
   ``Ops.unique_mask`` once at
   full width against ``NumpyOps.unique_mask``; the probe's launches by
   (log2 n, log2 m) and the unique mask's by log2 n over all of that
   (``engine_probe_sizes``).  Every kernel launched
   on that path; then one more raw and one more compressed ``infer1``
   run under ``torch.profiler`` for the device busy time;
4. LM phase: ``yi-6b`` (32 layers, d=4096, GQA 32/4) and then
   ``mamba2-1.3b`` (48 layers, d=2048, SSD) at full width with random
   weights from ``--seed``, each served greedily: B = 2 prompts of
   S = 2048 random tokens through ``prefill_fn`` (``max_len = S + 16``),
   then 16 ``decode_fn`` steps.  The first decode step's logits must match ``hidden()`` over
   the prompt plus that token (``3e-2 * max(1, scale)``, as the
   reference's decode test), and the two forwards must have launched
   ``flash_attention`` (yi, every launch on the tensor-core ``wgmma``
   route) or ``ssd_intra`` (mamba2) once per layer each;
5. kernel phase: each kernel at the main path's shapes on the card (the
   index-mirror merge's ranks at the largest shapes the engine phase
   gave them, the LM kernels at the prefill shapes of the LM phase),
   compared with its plain PyTorch version (bit-exact for the integer
   kernels, within a stated tolerance for the float ones; attention on
   both of its routes), timed with
   CUDA events (median of ``--reps`` runs, L2 flushed before each)
   beside the plain version, one PyTorch library call as a yardstick
   where one exists, and the bound; both sorts also at 2^13, 2^16, 2^18
   and their table shapes beside ``torch.sort``, with the device kernels
   one call launches and their split into the first tile launch, the
   fused cross-tile launches and the later tile launches
   (``torch.profiler``); the probe at m = 2^10 .. 2^21 right keys (n =
   m / 2) and at the engine's shapes beside two ``torch.searchsorted``
   calls, the unique mask at 2^13 .. 2^21 keys beside ``torch.ne``, and
   the merge ranks at every merge shape the engine phase gave them, each
   launch apart beside one ``torch.searchsorted`` call (``rank_size``
   rows), each checked bit for bit; ``ssd_intra``'s gram pass timed
   apart (``gram_ms``);
6. a ``{"kernels": [...]}`` line with every ported kernel's numbers
   (``queued`` lists the kernels still to port: none); attention's row
   times the ``wgmma`` route beside the CUDA-core kernel on the same
   inputs (``simt_ms``) and counts the LM phase's launches by route;
   the merge ranks' row times its two launches apart (``left_ms``,
   ``right_ms``); ``ssd_intra``'s row carries its gram pass
   (``gram_ms``) and the bound at the float32 rate without tensor cores
   (``bound_old_ms``) beside the TF32 one;
7. the last line: ``{"ok": true, "device": {...}}``.

Float32 products run in full float32 (``allow_tf32`` off for matmuls
and cuDNN) wherever a kernel is compared with its plain version.

Nothing of JAX and nothing of the reference ``repro`` package is
imported.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM non-tensor-core float32 peak, the
#                             table's only rate for scalar (non-matrix) ops
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core peak


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after a warm-up, with the L2 cache flushed before each run.  A spin
    kernel (~0.5 ms) keeps the card busy while the host enqueues the
    events and ``fn``'s launches, so a short kernel's time is its device
    time, not the wrapper's host overhead."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int,
             ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, pairs) -> int:
    """Largest |kernel - plain| over all outputs (int64 exact)."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, int(d), 1)
    return err


# the device kernels of csrc/bitonic_sort.cu (tile launches, then the two
# kinds of cross-tile launch), and those of the engine's other kernels
SORT_KERNELS = ("tile_network", "cross_fused", "cross_smem")
OUR_KERNELS = (*SORT_KERNELS, "probe_splitters", "probe_gather",
               "rank_splitters", "rank_gather", "unique_mask_vec")


def is_sort_kernel(name: str) -> bool:
    return any(k in name for k in SORT_KERNELS)


def sort_split(torch, fn, n: int, elem_bytes: int) -> dict:
    """One sort call's device kernels, from ``torch.profiler`` (as
    ``lm_profile`` counts them), L2 flushed first, in three groups: the
    first tile launch, every cross-tile launch (``cross_fused`` and
    ``cross_smem``) and the later tile launches, each with its launches,
    device ms and bound (each launch reads and writes the ``n``-element
    array once); ``other`` is the wrapper's pad copy and fill.  The tracer
    can miss the first launches after it starts, even behind a spin kernel
    and a pause (seen after earlier profiles in one process), so three
    calls run and the last is counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(3):
            flush.bitwise_not_()  # L2 flushed before each call
            fn()
        torch.cuda.synchronize()
    calls = [(e.name, e.time_range.elapsed_us() / 1e3) for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and not any(w in e.name for w in ("spin", "bitwise_not"))),
        key=lambda e: e.time_range.start)]
    last = 0
    for i in range(1, len(calls)):
        if is_sort_kernel(calls[i - 1][0]) and not is_sort_kernel(
                calls[i][0]):
            last = i  # a wrapper's pad copy after a sort kernel: a new call
    calls = calls[last:]
    sort = [(k, ms) for k, ms in calls if is_sort_kernel(k)]
    other = [ms for k, ms in calls if not is_sort_kernel(k)]
    if not sort:
        fail("sort_split: the profiler saw no sort kernel")
    tile = SORT_KERNELS[0]
    groups = {"first_tile": sort[:1],
              "cross": [c for c in sort[1:] if tile not in c[0]],
              "later_tiles": [c for c in sort[1:] if tile in c[0]]}
    per_launch = bound_ms(2 * n * elem_bytes, 0)[0]
    out = {g: {"launches": len(c), "ms": sum(ms for _, ms in c),
               "bound_ms": len(c) * per_launch}
           for g, c in groups.items()}
    out["other"] = {"launches": len(other), "ms": sum(other)}
    out["sort_kernels"] = len(sort)
    out["device_kernels"] = len(calls)
    out["kernel_names"] = sorted({m.group(0) for k, _ in sort for m in [
        re.search(rf"({'|'.join(SORT_KERNELS)})<[^>]*>", k)] if m})
    return out


def sort_detail(torch, rng, reps: int, sizes=(13, 16, 18)) -> list:
    """Both sort kernels at 2^s for each of ``sizes`` (by default 2^13,
    2^16 and 2^18, the engine's most frequent large sort) and at the table
    shapes: bit checks against the plain versions, kernel ms beside
    ``torch.sort`` ms, and at the table shapes the device kernels one call
    launches, their split into first tile, cross-tile and later tile
    launches, and a check that the sort kernels counted are
    ``launch_plan``'s."""
    import numpy as np

    from repro_torch.kernels.sortmerge.ops import tag_bits_for
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain, launch_plan, sort_tier)

    rows = []
    for name, lg_top in (("bitonic_sort", 21), ("bitonic_sort_kv", 20)):
        for lg in sorted({*sizes, lg_top}):
            n = 1 << lg
            if name == "bitonic_sort":  # tagged keys, as the index builds
                tb = tag_bits_for(n)
                raw = rng.randint(0, 1 << 30, n).astype(np.int64)
                x = torch.tensor((raw << tb) | np.arange(n, dtype=np.int64),
                                 device="cuda")
                err = max_abs_err(torch, [(bitonic_sort(x),
                                           bitonic_sort_plain(x))])
                call, lib, eb = (lambda: bitonic_sort(x),
                                 lambda: torch.sort(x), 8)
            else:  # keys with many ties, an int32 payload
                k = torch.tensor(rng.randint(0, 1 << 16, n).astype(np.int64),
                                 device="cuda")
                v = torch.arange(n, dtype=torch.int32, device="cuda")
                (gk, gv), (wk, wv) = (bitonic_sort_kv(k, v),
                                      bitonic_sort_kv_plain(k, v))
                err = max_abs_err(torch, [(gk, wk), (gv, wv)])
                call, lib, eb = (lambda: bitonic_sort_kv(k, v),
                                 lambda: torch.sort(k), 12)
            kv = name == "bitonic_sort_kv"
            row = {"sort_size": name, "n": n,
                   "tile": sort_tier(n, kv)[0], "max_abs_err": err,
                   "kernel_ms": time_ms(torch, call, reps),
                   "library_ms": time_ms(torch, lib, reps),
                   "bound_ms": bound_ms(2 * eb * n, 0)[0],
                   "plan_launches": len(launch_plan(n, kv=kv))}
            if lg == lg_top:
                row["split"] = sort_split(torch, call, n, eb)
            print(json.dumps(row), flush=True)
            if err:
                fail(f"{name} at n={n}: kernel and plain version differ")
            if lg == lg_top and (
                    row["split"]["sort_kernels"] != row["plan_launches"]):
                fail(f"{name} at n={n}: {row['split']['sort_kernels']} "
                     f"sort kernels, launch_plan says "
                     f"{row['plan_launches']}")
            rows.append(row)
    return rows


# (log2 n, log2 m) of the probe's by-size rows: n = m / 2 from 2^10 to
# 2^21 right keys, then the engine's most frequent shape (32 left keys
# against 2^21) and its largest (engine_probe_sizes at scale 500); log2
# of the unique mask's
PROBE_SIZES = ((9, 10), (12, 13), (15, 16), (17, 18), (20, 21), (5, 21),
               (15, 21), (18, 19))
UNIQUE_SIZES = (13, 16, 18, 21)


def search_detail(torch, rng, reps: int, probe_sizes=PROBE_SIZES,
                  unique_sizes=UNIQUE_SIZES) -> list:
    """``probe_sorted`` at n = 2^a left keys against m = 2^b sorted right
    keys for each (a, b) of ``probe_sizes`` (keys drawn from [0, 2m), as
    the kernel phase's), and ``unique_mask_sorted`` at 2^s sorted keys
    with about eight rows per value for each of ``unique_sizes``: bit
    checks against the plain versions (the mask also on the view
    ``x[1:]``, 8 bytes past a 16-byte boundary), kernel ms beside the
    library call's ms, and the bound."""
    import numpy as np

    from repro_torch.kernels.mergejoin.mergejoin import (probe_plan,
                                                         probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.uniquefilter.uniquefilter import (
        unique_mask_sorted, unique_mask_sorted_plain)

    rows = []
    for lg_n, lg_m in probe_sizes:
        n, m = 1 << lg_n, 1 << lg_m
        r = torch.tensor(np.sort(rng.randint(0, 2 * m, m)).astype(np.int64),
                         device="cuda")
        lk = torch.tensor(rng.randint(0, 2 * m, n).astype(np.int64),
                          device="cuda")
        s, table = probe_plan(m)
        rows.append({
            "search_size": "probe_sorted", "n": n, "m": m, "s": s,
            "table": table,
            "max_abs_err": max_abs_err(torch, zip(probe_sorted(lk, r),
                                                  probe_sorted_plain(lk, r))),
            "kernel_ms": time_ms(torch, lambda: probe_sorted(lk, r), reps),
            "library_ms": time_ms(
                torch, lambda: (torch.searchsorted(r, lk),
                                torch.searchsorted(r, lk, right=True)), reps),
            "bound_ms": bound_ms(8 * n + 8 * m + 8 * n, 0)[0]})
        print(json.dumps(rows[-1]), flush=True)
    for lg in unique_sizes:
        n = 1 << lg
        x = torch.tensor(np.sort(rng.randint(0, n // 8, n + 1)).astype(
            np.int64), device="cuda")
        xa, xu = x[:n], x[1:]  # 16-byte aligned, and 8 bytes past it
        rows.append({
            "search_size": "unique_mask_sorted", "n": n,
            "max_abs_err": max_abs_err(torch, [
                (unique_mask_sorted(v), unique_mask_sorted_plain(v))
                for v in (xa, xu)]),
            "kernel_ms": time_ms(torch, lambda: unique_mask_sorted(xa), reps),
            "unaligned_ms": time_ms(torch, lambda: unique_mask_sorted(xu),
                                    reps),
            "library_ms": time_ms(torch, lambda: torch.ne(xa[1:], xa[:-1]),
                                  reps),
            "bound_ms": bound_ms(9 * n, n)[0]})
        print(json.dumps(rows[-1]), flush=True)
    for row in rows:
        if row["max_abs_err"]:
            fail(f"{row['search_size']} at n={row['n']}: kernel and plain "
                 "version differ")
    return rows


def rank_detail(torch, rng, reps: int, shapes) -> list:
    """``merge_ranks`` at each (run lanes, delta lanes) of ``shapes`` (the
    index-mirror merges the engine phase ran): both runs sorted, as the
    merge gives them, each launch timed apart (the run ranked into the
    delta, side left; the delta into the run, side right) beside one
    ``torch.searchsorted`` call each, with the tree the plan takes and
    the bound; at the largest shape also the run's keys in random order
    (``x_order``), which the kernel must take as well.  Bit checks against
    the plain version."""
    import numpy as np

    from repro_torch.kernels.mergejoin.mergejoin import merge_ranks_plan
    from repro_torch.kernels.sortmerge.sortmerge import (merge_ranks,
                                                         merge_ranks_plain)

    rows = []
    cases = [(cap, dcap, "sorted") for cap, dcap in shapes]
    cases.append((*max(shapes), "random"))
    for cap, dcap, order in cases:
        base, drun = (torch.tensor(np.sort(rng.randint(
            0, 1 << 52, k, dtype=np.int64)), device="cuda")
            for k in (cap, dcap))
        # random: the run's keys shuffled where they are the searched keys
        xs = (base[torch.randperm(cap, device="cuda")] if order == "random"
              else base)
        row = {"rank_size": "merge_ranks", "run": cap, "delta": dcap,
               "x_order": order}
        for side, x, other in (("left", xs, drun), ("right", drun, base)):
            right = side == "right"
            s, table = merge_ranks_plan(x.shape[0], other.shape[0])
            row[side] = {
                "n": x.shape[0], "m": other.shape[0], "s": s,
                "table": table,
                "max_abs_err": max_abs_err(torch, [(
                    merge_ranks(x, other, right),
                    merge_ranks_plain(x, other, right))]),
                "kernel_ms": time_ms(
                    torch, lambda: merge_ranks(x, other, right), reps),
                "library_ms": time_ms(
                    torch, lambda: torch.searchsorted(other, x, right=right),
                    reps),
                "bound_ms": bound_ms(12 * x.shape[0] + 8 * other.shape[0],
                                     0)[0]}
        row["kernel_ms"] = row["left"]["kernel_ms"] + row["right"]["kernel_ms"]
        row["library_ms"] = (row["left"]["library_ms"]
                             + row["right"]["library_ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    for row in rows:
        if row["left"]["max_abs_err"] or row["right"]["max_abs_err"]:
            fail(f"merge_ranks at ({row['run']}, {row['delta']}, "
                 f"{row['x_order']}): kernel and plain version differ")
    return rows


def kernel_phase(torch, seed: int, reps: int, merge_shapes) -> dict:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.sortmerge.ops import tag_bits_for
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain, merge_ranks, merge_ranks_plain)
    from repro_torch.kernels.uniquefilter.uniquefilter import (
        unique_mask_sorted, unique_mask_sorted_plain)

    rng = np.random.RandomState(seed)
    dev = "cuda"
    out = {}

    # bitonic_sort: 2^21 tagged int64 keys, the index-build form
    n = 1 << 21
    tb = tag_bits_for(n)
    raw = rng.randint(0, 1 << 30, n).astype(np.int64)
    x = torch.tensor((raw << tb) | np.arange(n, dtype=np.int64), device=dev)
    got = bitonic_sort(x)
    want = bitonic_sort_plain(x)
    torch.cuda.synchronize()
    lg = int(np.log2(n))
    out["bitonic_sort"] = {
        "shape": [n], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, [(got, want)]),
        "kernel_ms": time_ms(torch, lambda: bitonic_sort(x), reps),
        "plain_ms": time_ms(torch, lambda: bitonic_sort_plain(x), reps),
        "library_ms": time_ms(torch, lambda: torch.sort(x), reps),
        "library_call": "torch.sort",
        "bound": bound_ms(2 * 8 * n, n * lg)}

    # bitonic_sort_kv: 2^20 int64 keys (many ties) carrying int32 values
    n = 1 << 20
    k = torch.tensor(rng.randint(0, 1 << 16, n).astype(np.int64), device=dev)
    v = torch.arange(n, dtype=torch.int32, device=dev)
    gk, gv = bitonic_sort_kv(k, v)
    wk, wv = bitonic_sort_kv_plain(k, v)
    torch.cuda.synchronize()
    lg = int(np.log2(n))
    out["bitonic_sort_kv"] = {
        "shape": [n], "dtype": "int64+int32",
        "max_abs_err": max_abs_err(torch, [(gk, wk), (gv, wv)]),
        "kernel_ms": time_ms(torch, lambda: bitonic_sort_kv(k, v), reps),
        "plain_ms": time_ms(torch, lambda: bitonic_sort_kv_plain(k, v),
                            reps),
        "library_ms": time_ms(torch, lambda: torch.sort(k), reps),
        "library_call": "torch.sort (keys + int64 indices)",
        "bound": bound_ms(2 * 12 * n, n * lg)}

    # probe_sorted: n = 2^20 left keys against m = 2^21 sorted right keys
    n, m = 1 << 20, 1 << 21
    r = torch.tensor(np.sort(rng.randint(0, 1 << 22, m)).astype(np.int64),
                     device=dev)
    lk = torch.tensor(rng.randint(0, 1 << 22, n).astype(np.int64),
                      device=dev)
    lo, hi = probe_sorted(lk, r)
    plo, phi = probe_sorted_plain(lk, r)
    torch.cuda.synchronize()
    out["probe_sorted"] = {
        "shape": [n, m], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, [(lo, plo), (hi, phi)]),
        "kernel_ms": time_ms(torch, lambda: probe_sorted(lk, r), reps),
        "plain_ms": time_ms(torch, lambda: probe_sorted_plain(lk, r), reps),
        "library_ms": time_ms(
            torch, lambda: (torch.searchsorted(r, lk),
                            torch.searchsorted(r, lk, right=True)), reps),
        "library_call": "torch.searchsorted (left and right)",
        # bytes: both inputs read once, both int32 bounds written once;
        # operations: two binary searches per left key
        "bound": bound_ms(8 * n + 8 * m + 8 * n,
                          2 * n * int(np.ceil(np.log2(m))))}

    # merge_ranks: the two rank launches of one index-mirror merge — a
    # resident tagged run of `cap` lanes against a sorted delta run of
    # `dcap` lanes (left side), and the delta run against the resident
    # run (right side), at the largest (cap, dcap) of the engine phase
    cap, dcap = max(merge_shapes)
    base, drun = (torch.tensor(np.sort(rng.randint(0, 1 << 52, k,
                                                   dtype=np.int64)),
                               device=dev)
                  for k in (cap, dcap))

    def ranks(fn):
        return fn(base, drun, False), fn(drun, base, True)
    got = ranks(merge_ranks)
    want = ranks(merge_ranks_plain)
    torch.cuda.synchronize()
    out["merge_ranks"] = {
        "shape": [cap, dcap], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, zip(got, want)),
        "kernel_ms": time_ms(torch, lambda: ranks(merge_ranks), reps),
        # the two launches apart: the run ranked into the delta (side
        # left) and the delta ranked into the run (side right)
        "left_ms": time_ms(torch, lambda: merge_ranks(base, drun, False),
                           reps),
        "right_ms": time_ms(torch, lambda: merge_ranks(drun, base, True),
                            reps),
        "plain_ms": time_ms(torch, lambda: ranks(merge_ranks_plain), reps),
        "library_ms": time_ms(
            torch, lambda: (torch.searchsorted(drun, base),
                            torch.searchsorted(base, drun, right=True)),
            reps),
        "library_call": "torch.searchsorted (both runs)",
        # bytes: both runs read once, both rank arrays written once;
        # operations: one binary search per element of each run
        "bound": bound_ms(12 * (cap + dcap),
                          cap * int(np.ceil(np.log2(dcap)))
                          + dcap * int(np.ceil(np.log2(cap))))}

    # unique_mask_sorted: 2^21 sorted int64 keys with many ties (about
    # eight rows per distinct value), the width of a resident column
    n = 1 << 21
    x = torch.tensor(np.sort(rng.randint(0, n // 8, n)).astype(np.int64),
                     device=dev)
    got = unique_mask_sorted(x)
    want = unique_mask_sorted_plain(x)
    torch.cuda.synchronize()
    out["unique_mask_sorted"] = {
        "shape": [n], "dtype": "int64",
        "distinct": int(got.sum()),
        "max_abs_err": max_abs_err(torch, [(got, want)]),
        "kernel_ms": time_ms(torch, lambda: unique_mask_sorted(x), reps),
        "plain_ms": time_ms(torch, lambda: unique_mask_sorted_plain(x),
                            reps),
        "library_ms": time_ms(torch, lambda: torch.ne(x[1:], x[:-1]), reps),
        "library_call": "torch.ne(x[1:], x[:-1])",
        # bytes: the keys read once, the bool mask written once;
        # operations: one compare per element
        "bound": bound_ms(9 * n, n)}

    sort_detail(torch, rng, reps)
    search_detail(torch, rng, reps)
    rank_detail(torch, rng, reps, merge_shapes)
    out.update(lm_kernel_rows(torch, rng, reps))

    # the launches above compare and time the kernels; they are not the
    # main path's, so they are dropped from the counts
    kernels.reset_counts()
    for name, row in out.items():
        b, by = row.pop("bound")
        row["bound_ms"], row["bound_by"] = b, by
        print(json.dumps({"kernel": name, **row}), flush=True)
        if row["max_abs_err"] > row.get("tolerance", 0):
            fail(f"{name}: kernel and plain version differ "
                 f"(max abs err {row['max_abs_err']})")
    return out


def float_err(torch, got, want, tol: float, what: str) -> float:
    """Largest |kernel - plain| of one float output; fails past ``tol``
    or on a non-finite value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs plain "
             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if err > tol:
        fail(f"{what}: kernel and plain version differ by {err} > {tol}")
    return err


def lm_kernel_rows(torch, rng, reps: int) -> dict:
    """The LM kernels at the LM phase's prefill shapes, against their
    plain versions; plus a windowed and an unaligned attention case."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain, launch_route)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.ssd import (gram_scratch, ssd_intra,
                                             ssd_intra_plain)

    dev = "cuda"
    out = {}

    def normal(*shape, dtype=torch.float32):
        return torch.tensor(rng.randn(*shape).astype(np.float32),
                            device=dev).to(dtype)

    def attention_case(b_, sq, skv, hq, hkv, d_, win, dt, tol, route):
        """One attention comparison on the route it must take."""
        qq = normal(b_, sq, hq, d_, dtype=dt)
        kk, vv = (normal(b_, skv, hkv, d_, dtype=dt) for _ in range(2))
        before = kernels.LAUNCHES["flash_attention_wgmma"]
        what = (f"flash_attention ({b_}x{sq}x{skv}, {hq}/{hkv} heads, hd "
                f"{d_}, window {win}, {dt})")
        err = float_err(
            torch, flash_attention(qq, kk, vv, causal=True, window=win),
            flash_attention_plain(qq, kk, vv, causal=True, window=win), tol,
            what)
        took = ("wgmma" if kernels.LAUNCHES["flash_attention_wgmma"] > before
                else "simt")
        if took != route:
            fail(f"{what}: took the {took} route, expected {route}")
        return {"shape": [b_, sq, skv, hq, hkv, d_], "window": win,
                "dtype": str(dt).replace("torch.", ""), "route": took,
                "max_abs_err": err, "tolerance": tol}

    # flash_attention: yi-6b's prefill, B=2, S=2048, Hq=32, Hkv=4, hd=128,
    # bf16, causal, on the tensor-core route; 2e-2 absolute in bf16
    # (tests/test_kernels.py)
    B, S, Hq, Hkv, hd = 2, 2048, 32, 4, 128
    q = normal(B, S, Hq, hd, dtype=torch.bfloat16)
    k, v = (normal(B, S, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))
    before = kernels.LAUNCHES["flash_attention_wgmma"]
    err = float_err(torch, flash_attention(q, k, v, causal=True),
                    flash_attention_plain(q, k, v, causal=True), 2e-2,
                    "flash_attention (yi prefill)")
    if kernels.LAUNCHES["flash_attention_wgmma"] != before + 1:
        fail("flash_attention (yi prefill) did not take the wgmma route")
    # a windowed case, Sq != Skv with ragged tails (no tile divides them)
    # on both routes, and fp16 at yi's shape (4e-3: an ulp of the output)
    side = [attention_case(*c) for c in (
        (1, 300, 300, 8, 2, 128, 100, torch.bfloat16, 2e-2, "wgmma"),
        (2, 77, 200, 12, 1, 64, 0, torch.float32, 1e-5, "simt"),
        (2, 77, 200, 12, 1, 64, 0, torch.bfloat16, 2e-2, "wgmma"),
        (B, S, S, Hq, Hkv, hd, 0, torch.float16, 4e-3, "wgmma"))]
    qt, kt_, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    band = S * (S + 1) // 2
    out["flash_attention"] = {
        "shape": [B, S, Hq, Hkv, hd], "dtype": "bfloat16", "causal": True,
        "route": "wgmma", "max_abs_err": err, "tolerance": 2e-2,
        "side_cases": side,
        "kernel_ms": time_ms(
            torch, lambda: flash_attention(q, k, v, causal=True), reps),
        # the CUDA-core kernel (the float32 route) on the same bf16
        # inputs: the time the tensor-core route replaces
        "simt_ms": time_ms(
            torch, lambda: launch_route("simt", q, k, v, causal=True), reps),
        "plain_ms": time_ms(
            torch, lambda: flash_attention_plain(q, k, v, causal=True), reps),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt_, vt, is_causal=True, enable_gqa=True), reps),
        "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        # bytes: q, k, v read once, out written once (bf16); operations:
        # the causal band's two products (QK^T and PV), 2 FLOPs per
        # multiply-add, at the bf16 tensor-core peak (the inputs' type)
        "bound": bound_ms(2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd),
                          4 * B * Hq * hd * band, BF16_OPS_PER_S)}

    # ssd_intra: mamba2-1.3b's prefill, b=2, nc=8, Q=256, nh=64, hp=64,
    # N=128, float32; 1e-4 of max|y| and of max|state| (sums over Q and N
    # reassociated)
    b, nc, Q, nh, hp, N = 2, 8, 256, 64, 64, 128
    dlog = -np.abs(rng.randn(b, nc, Q, nh)).astype(np.float32) * 0.05
    cum = torch.tensor(np.cumsum(dlog, axis=2), device=dev)
    u = normal(b, nc, Q, nh, hp)
    Bm, Cm = normal(b, nc, Q, N), normal(b, nc, Q, N)
    y, st = ssd_intra(cum, u, Bm, Cm)
    yp, sp = ssd_intra_plain(cum, u, Bm, Cm)
    tols = [1e-4 * max(1.0, float(w.abs().max())) for w in (yp, sp)]
    errs = [float_err(torch, g, w, t, f"ssd_intra ({what})")
            for g, w, t, what in ((y, yp, tols[0], "y"),
                                  (st, sp, tols[1], "state"))]
    tri = Q * (Q + 1) // 2
    gram = gram_scratch(b, nc, Q, dev)
    lib = _build.library("ssd_intra")

    def gram_pass():
        _build.check(lib.ssd_gram_f32(
            Bm.data_ptr(), Cm.data_ptr(), b, nc, Q, N, gram.data_ptr(),
            gram.shape[0], torch.cuda.current_stream().cuda_stream),
            "ssd_gram")
    # bytes: cum, u, B, C read once, y and the states written once;
    # operations the function needs (2 per multiply-add): the gram
    # C.B^T's lower triangle once per (b, c), and per head the decay (exp
    # of a difference, times the gram), M u over the triangle, the state
    # weights and the state product u^T B
    nbytes = 4 * (b * nc * Q * nh + 2 * b * nc * Q * nh * hp
                  + 2 * b * nc * Q * N + b * nc * nh * hp * N)
    ops = b * nc * (tri * N * 2 + nh * (tri * 2 + tri * hp * 2 + Q * hp
                                        + Q * hp * N * 2))
    out["ssd_intra"] = {
        "shape": [b, nc, Q, nh, hp, N], "dtype": "float32",
        "max_abs_err": max(errs), "tolerance": max(tols),
        "kernel_ms": time_ms(torch, lambda: ssd_intra(cum, u, Bm, Cm), reps),
        # the gram pass alone (the kernel's first launch)
        "gram_ms": time_ms(torch, gram_pass, reps),
        "plain_ms": time_ms(torch, lambda: ssd_intra_plain(cum, u, Bm, Cm),
                            reps),
        "library_ms": None, "library_call": None,
        # the kernel runs the work as three TF32 tensor-core products
        # (split float32), so the operations count three times at the TF32
        # peak
        "bound": bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S),
        # the old yardstick: the same work at the float32 peak without
        # tensor cores
        "bound_old_ms": bound_ms(nbytes, ops)[0]}
    return out


def row_sets(engine, queries):
    return [{tuple(sorted(r.items())) for r in engine.query(q)}
            for q in queries]


def merge_shapes(torch_ops):
    """Record the (run lanes, delta lanes) of every index-mirror merge the
    engine runs: ``merge_sorted_mirror_impl`` is wrapped in the
    ``torch_ops`` module's namespace, where ``TorchOps`` looks it up.
    Returns the list and an undo function."""
    seen = []
    orig = torch_ops.merge_sorted_mirror_impl

    def recording(buf, *args, dcap, **kw):
        seen.append((int(buf.shape[0]), int(dcap)))
        return orig(buf, *args, dcap=dcap, **kw)
    torch_ops.merge_sorted_mirror_impl = recording

    def undo():
        torch_ops.merge_sorted_mirror_impl = orig
    return seen, undo


# (preset, config overrides) of the engine phase's runs, in order: the two
# raw presets of the first slice, the reference's default compressed
# tier under both presets, and the device sketch planner
RUNS = [
    ("infer1", {"compress": False}),
    ("query1", {"compress": False}),
    ("infer1", {"compress": True}),
    ("query1", {"compress": True}),
    ("query1", {"compress": True, "sort_mode": "sketch"}),
]


def engine_config(preset: str, overrides: dict):
    from repro_torch.core import EngineConfig
    cfg = getattr(EngineConfig, preset)(backend="torch")
    cfg.eval_mode = "full"
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def engine_phase(torch, scale: int, seed: int):
    from repro_torch import kernels
    from repro_torch.backend import torch_ops
    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    from repro_torch.datasets import LUBM_QUERIES, lubm_like

    t0 = time.perf_counter()
    facts = lubm_like(scale, seed=seed)
    print(json.dumps({"phase": "engine", "scale": scale,
                      "base_facts": len(facts),
                      "gen_s": time.perf_counter() - t0}), flush=True)

    # oracle: the port's numpy backend on the same facts.  Results do not
    # depend on the configuration (the paper's invariant, held by the CPU
    # tests over the whole grid), so one AI-indexed run serves every run
    t0 = time.perf_counter()
    cfg = EngineConfig.query1(backend="numpy")
    cfg.eval_mode = "full"
    ref = HiperfactEngine(cfg)
    ref.add_rules(rdfs_plus_rules())
    ref.insert_facts(facts)
    ref_stats = ref.infer()
    ref_rows = row_sets(ref, LUBM_QUERIES)
    ref_sum = decoded_fact_checksum(ref)
    print(json.dumps({"oracle": "numpy", "preset": "query1",
                      "facts_inferred": ref_stats.facts_inferred,
                      "rows": [len(s) for s in ref_rows],
                      "checksum": ref_sum,
                      "seconds": time.perf_counter() - t0}), flush=True)

    launches = {name: 0 for name in kernels.ENGINE_KERNELS}
    # the sort kernels' launches by log2 of the padded length, and the
    # probe's by (log2 n, log2 m) and the unique mask's by log2 n, all runs
    sizes = {"sort_sizes": {name: {} for name in kernels.SORT_SIZES},
             "search_sizes": {name: {} for name in kernels.SEARCH_SIZES}}
    shapes, undo = merge_shapes(torch_ops)
    for preset, overrides in RUNS:
        e = HiperfactEngine(engine_config(preset, overrides))
        e.add_rules(rdfs_plus_rules())
        snap = e.ops.transfers.snapshot()
        work = e.ops.sort_work.snapshot()
        codecs0 = e.ops.residency_stats()["codecs"]
        n_shapes = len(shapes)
        kernels.reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        e.insert_facts(facts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = e.infer()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows = row_sets(e, LUBM_QUERIES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = kernels.counts()  # ... and ends here
        moved = e.ops.transfers.delta(snap)
        sorted_work = e.ops.sort_work.delta(work)
        res = e.ops.residency_stats()
        res["codecs"] = {k: v - codecs0[k] for k, v in res["codecs"].items()}
        checksum = decoded_fact_checksum(e)
        rec = {"preset": preset, **overrides, "backend": "torch",
               "eval_mode": "full",
               "load_s": t1 - t0, "infer_s": t2 - t1, "query_s": t3 - t2,
               "facts_inferred": stats.facts_inferred,
               "iterations": stats.iterations,
               "sketch_misses": stats.sketch_misses,
               "rows": [len(s) for s in rows],
               "launches": counts["launches"],
               "sort_sizes": counts["sort_sizes"],
               "search_sizes": counts["search_sizes"],
               "width_fallbacks": counts["fallbacks"],
               "transfers": {"h2d_calls": moved.h2d_calls,
                             "h2d_bytes": moved.h2d_bytes,
                             "d2h_calls": moved.d2h_calls,
                             "d2h_bytes": moved.d2h_bytes},
               "residency": res,
               "sort_work": sorted_work.as_dict(),
               "merge_shapes": sorted(set(shapes[n_shapes:])),
               "cache": e.ops.cache.stats(),
               "checksum": checksum,
               "checksum_equal": checksum == ref_sum,
               "rows_equal": rows == ref_rows}
        print(json.dumps(rec), flush=True)
        for name in launches:
            launches[name] += counts["launches"][name]
        add_sizes(sizes, counts)
        label = f"{preset} {overrides}"
        if stats.facts_inferred != ref_stats.facts_inferred:
            fail(f"{label}: facts_inferred {stats.facts_inferred} != "
                 f"{ref_stats.facts_inferred} (numpy)")
        if checksum != ref_sum:
            fail(f"{label}: decoded fact checksum differs from numpy")
        if rows != ref_rows:
            fail(f"{label}: query row sets differ from numpy")
        if overrides["compress"] and not (
                0 < res["resident_bytes_coded"] < res["resident_bytes_raw"]):
            fail(f"{label}: coded resident bytes {res['resident_bytes_coded']}"
                 f" not below raw {res['resident_bytes_raw']}")
        # release this engine's device cache before the next run
        e.ops.cache.clear()
    undo()
    print(json.dumps({"engine_sort_sizes": {
        k: dict(sorted(v.items()))
        for k, v in sizes["sort_sizes"].items()}}), flush=True)
    counts = unique_mask_entry(torch)
    launches = {k: launches[k] + counts["launches"][k] for k in launches}
    add_sizes(sizes, counts)
    # the probe's and the unique mask's launches over the five runs and
    # Ops.unique_mask, by size: how the kernel phase's shapes stand
    print(json.dumps({"engine_probe_sizes": {
        k: dict(sorted(v.items()))
        for k, v in sizes["search_sizes"].items()}}), flush=True)
    # a run may skip a kernel for a reason of its data or its mode: an
    # index mirror whose column outgrows its power-of-two buffer is
    # re-sorted, not merged (at scale 500, infer1's only in-infer LPIM
    # compaction does), and only the sketch planner and Ops.unique_mask
    # reach unique_mask_sorted, so the check is over the whole path
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} never launched on the path")
    device_profile(torch, facts, "infer1", {"compress": False})
    device_profile(torch, facts, "infer1", {"compress": True})
    return launches, sorted(set(shapes))


def add_sizes(sizes: dict, counts: dict) -> None:
    """Add a run's launches by size (``kernels.counts()``) to ``sizes``."""
    for group, per_kernel in sizes.items():
        for name, by_lg in counts[group].items():
            for lg, c in by_lg.items():
                per_kernel[name][lg] = per_kernel[name].get(lg, 0) + c


def unique_mask_entry(torch) -> dict:
    """``Ops.unique_mask`` (the compressed backend's entry point of the
    unique-mask kernel) once at full width: a sorted column of 2^20 rows
    with ties, against ``NumpyOps.unique_mask``.  Returns the kernel
    counters of that call."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.backend import get_backend

    ops = get_backend("torch", compress=True)
    x = np.sort(np.random.RandomState(7).randint(0, 1 << 17, 1 << 20)
                ).astype(np.int64) + (1 << 40)
    snap = ops.transfers.snapshot()
    kernels.reset_counts()  # the entry point's run starts here
    t0 = time.perf_counter()
    got = ops.unique_mask(x)
    secs = time.perf_counter() - t0
    counts = kernels.counts()  # ... and ends here
    moved = ops.transfers.delta(snap)
    want = get_backend("numpy").unique_mask(x)
    equal = bool(np.array_equal(got, want))
    print(json.dumps({"entry": "Ops.unique_mask", "rows": len(x),
                      "distinct": int(want.sum()), "seconds": secs,
                      "launches": counts["launches"],
                      "h2d_bytes": moved.h2d_bytes,
                      "d2h_bytes": moved.d2h_bytes, "equal": equal}),
          flush=True)
    if not equal:
        fail("Ops.unique_mask differs from NumpyOps.unique_mask")
    return counts


def device_events(prof) -> dict:
    """{kernel name: (device us, calls)} of a profile's device-side events
    (kernels, memcpys): a host op's device time repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType
    return {ev.key: (ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def device_profile(torch, facts, preset: str, overrides: dict) -> None:
    """Device busy time of one more fresh run of ``preset`` (load, infer,
    queries) under ``torch.profiler``: the sum of device kernel times,
    the share spent in the port's own CUDA kernels, and the top kernels.
    The profiler's overhead lengthens ``wall_s``, so ``idle_share`` is an
    upper bound; the timed runs above are the end-to-end numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES

    e = HiperfactEngine(engine_config(preset, overrides))
    e.add_rules(rdfs_plus_rules())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e.insert_facts(facts)
        e.infer()
        row_sets(e, LUBM_QUERIES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    e.ops.cache.clear()
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    ours = sum(us for k, (us, _) in per.items()
               if any(n in k for n in OUR_KERNELS)) / 1e6
    sorts = sum(us for k, (us, _) in per.items() if is_sort_kernel(k)) / 1e6
    copies = sum(us for k, (us, _) in per.items()
                 if "memcpy" in k.lower()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "profile": preset, **overrides, "wall_s": wall,
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / wall if busy else "not measured",
        "own_kernels_s": ours, "sort_kernels_s": sorts, "copies_s": copies,
        "top_device_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                               for k, (us, c) in top]}), flush=True)


# (config, the launch counts its forward raises once per layer) of the LM
# phase: yi's attention must take the tensor-core route every time
LM_MODELS = [("yi-6b", ("flash_attention", "flash_attention_wgmma")),
             ("mamba2-1.3b", ("ssd_intra",))]
LM_COUNTS = ("flash_attention", "flash_attention_wgmma", "ssd_intra")
# prompts, prompt tokens (> 1024 puts yi's attention on the kernel's
# branch; 8 chunks of 256 for mamba2) and greedy decode steps
LM_BATCH, LM_SEQ, LM_STEPS = 2, 2048, 16


def lm_phase(torch, seed: int, batch: int, seq: int, steps: int) -> dict:
    """Greedy serving of each LM at full width; returns each LM kernel's
    launches over its model's run."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, init_params, param_bytes,
                                    param_count)

    launches = {}
    for arch, own in LM_MODELS:
        cfg = get_config(arch)
        model = build_model(cfg)
        spec = model.spec()
        t0 = time.perf_counter()
        params = init_params(spec, seed)
        if cfg.family == "ssm":
            seed_conv_taps(torch, params, seed)
        torch.cuda.synchronize()
        print(json.dumps({"lm": arch, "layers": cfg.n_layers,
                          "d_model": cfg.d_model, "dtype": cfg.dtype,
                          "params": param_count(spec),
                          "param_gb": param_bytes(spec) / 1e9,
                          "init_s": time.perf_counter() - t0}), flush=True)
        prompts = torch.tensor(np.random.RandomState(seed).randint(
            0, cfg.vocab, (batch, seq)).astype(np.int32), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompts, seq + steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1)
        first = None
        step_ms = []
        for i in range(steps):
            ts = time.perf_counter()
            step, cache = model.decode_fn(params, tok, cache)
            first = step if first is None else first
            tok = step.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
        t2 = time.perf_counter()
        # consistency: hidden() over the prompt and the first greedy
        # token, against the first decode step's logits
        ext = torch.cat([prompts, logits.argmax(-1)[:, None].to(
            prompts.dtype)], dim=1)
        with torch.no_grad():
            h, _ = model.hidden(params, ext)
            ref = model._logits(params, h[:, seq, :])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = kernels.counts()["launches"]  # ... and ends here
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lens = cache["lens"].tolist()
        err = float((first.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        bound = 3e-2 * max(1.0, scale)
        del cache
        err32, scale32 = f32_consistency(torch, cfg, params, ext, seq)
        bound32 = 1e-3 * max(1.0, scale32)
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(first).all())
        print(json.dumps({
            "lm": arch, "batch": batch, "prompt": seq, "decode_steps": steps,
            "prefill_s": t1 - t0,
            "decode_ms_per_token": (t2 - t1) / steps * 1e3,
            "decode_ms_first": step_ms[0],
            "decode_ms_median": statistics.median(step_ms),
            "decode_ms_steps": step_ms,
            "generated_tokens_per_s": batch * steps / (t2 - t1),
            "forward_s": t3 - t2,
            "peak_device_gb": peak_gb,
            "logits_shape": list(logits.shape), "finite": finite,
            "consistency_err": err, "consistency_bound": bound,
            "f32_consistency_err": err32, "f32_consistency_bound": bound32,
            "cache_lens": lens,
            "launches": {k: counts[k] for k in LM_COUNTS}}), flush=True)
        if not finite or list(logits.shape) != [batch, cfg.vocab]:
            fail(f"{arch}: logits {list(logits.shape)}, finite={finite}")
        if err > bound or err32 > bound32:
            fail(f"{arch}: decode logits differ from the forward by {err} "
                 f"(bound {bound}; float32: {err32}, bound {bound32})")
        if lens != [seq + steps] * batch:
            fail(f"{arch}: cache lens {lens}")
        # two forwards ran (the prefill and the check), each once per layer
        want = {k: (2 * cfg.n_layers if k in own else 0) for k in LM_COUNTS}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{arch}: LM kernel launches {got}, expected {want}")
        launches.update({k: counts[k] for k in own})
        del logits, first, step, h, ref
        lm_profile(torch, arch, model, params, prompts)
        del params, model
        torch.cuda.empty_cache()
    return launches


def seed_conv_taps(torch, params, seed: int) -> None:
    """Draw the SSM blocks' conv taps and bias from the seed as upstream
    Mamba-2 initializes them (``nn.Conv1d``'s default for a depthwise
    conv of width W: uniform in +-1/sqrt(W)).  The reference's spec
    initializes them to zeros, which makes every SSM block of a fresh
    model output exactly 0: the SSD path would carry no signal and the
    consistency check would be vacuous."""
    ssm = params["blocks"]["b0"]["ssm"]
    bound = 1.0 / ssm["conv_w"].shape[1] ** 0.5   # [layers, W, channels]
    gen = torch.Generator(device=ssm["conv_w"].device).manual_seed(seed + 1)
    for name in ("conv_w", "conv_b"):
        ssm[name].uniform_(-bound, bound, generator=gen)


def f32_consistency(torch, cfg, params, ext, seq: int) -> tuple:
    """The consistency check again with the same weights in float32
    (``cfg.dtype`` only sets the compute type): decode after a prefill of
    ``seq`` tokens against ``hidden()`` over ``seq + 1``.  In float32 the
    two differ by reassociation only, so a fault that the bf16 bound
    could hide shows here.  Returns (max abs error, max |logit|)."""
    import dataclasses

    from repro_torch.models import build_model

    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    with torch.no_grad():
        _, cache = model.prefill_fn(params, ext[:, :seq], seq + 1)
        step, _ = model.decode_fn(params, ext[:, seq], cache)
        h, _ = model.hidden(params, ext)
        ref = model._logits(params, h[:, seq, :])
    return (float((step - ref).abs().max()), float(ref.abs().max()))


def lm_profile(torch, arch: str, model, params, prompts, steps: int = 4):
    """Device time of ``steps`` decode steps under ``torch.profiler``,
    against a fresh prefill of the prompts' first 256 tokens (outside
    the window): the device busy share of a decode step and its top
    kernels.  The profiler's overhead lengthens ``wall_s``, so
    ``idle_share`` is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    short = prompts[:, :256]
    logits, cache = model.prefill_fn(params, short, short.shape[1] + steps)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step, cache = model.decode_fn(params, tok, cache)
            tok = step.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "lm_profile": arch, "decode_steps": steps, "wall_s": wall,
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / wall if busy else "not measured",
        "device_kernels": sum(c for _, c in per.values()),
        "top_device_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                               for k, (us, c) in top]}), flush=True)


KERNELS = [
    {"name": "bitonic_sort", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/bitonic_sort.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:218"},
    {"name": "bitonic_sort_kv", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/bitonic_sort.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:252"},
    {"name": "probe_sorted", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/probe_sorted.cu",
     "replaces": "src/repro/kernels/mergejoin/mergejoin.py:46"},
    {"name": "merge_ranks", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/merge_ranks.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:172"},
    {"name": "unique_mask_sorted", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/unique_mask.cu",
     "replaces": "src/repro/kernels/uniquefilter/uniquefilter.py:32"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    {"name": "ssd_intra", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/ssd_intra.cu",
     "replaces": "src/repro/kernels/ssd/ssd.py:53"},
]
QUEUED: list = []  # every Pallas kernel of the reference has a port


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=500,
                    help="lubm_like scale (~2136 base facts per unit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=7,
                    help="timed runs per kernel (median reported)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    # float32 products in full float32 wherever kernels meet plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_library_s": secs}), flush=True)

    launches, merge_shapes = engine_phase(torch, args.scale, args.seed)
    launches.update(lm_phase(torch, args.seed, LM_BATCH, LM_SEQ,
                             LM_STEPS))
    rows = kernel_phase(torch, args.seed, args.reps, merge_shapes)

    line = []
    for k in KERNELS:
        r = rows[k["name"]]
        extra = {}
        if k["name"] == "flash_attention":  # launches by route, and the
            n_tc = launches["flash_attention_wgmma"]  # CUDA-core time
            extra = {"routes": {"wgmma": n_tc,
                                "simt": launches["flash_attention"] - n_tc},
                     "simt_ms": r["simt_ms"]}
        elif k["name"] == "merge_ranks":  # the two launches apart
            extra = {"left_ms": r["left_ms"], "right_ms": r["right_ms"]}
        elif k["name"] == "ssd_intra":  # the gram pass, the old yardstick
            extra = {"gram_ms": r["gram_ms"],
                     "bound_old_ms": r["bound_old_ms"]}
        line.append({**k, "status": "ported and checked",
                     "launches": launches[k["name"]],
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], **extra})
    print(json.dumps({"kernels": line, "queued": QUEUED, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
