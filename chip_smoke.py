#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--scale N] [--seed S] [--reps R]``

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``); exit non-zero when
   torch sees no CUDA device;
2. build every CUDA kernel of the port from the sources in the checkout;
3. engine phase: ``lubm_like(--scale)`` loaded, inferred and queried by
   the ``infer1`` and ``query1`` presets on the ``torch`` backend
   (``eval_mode="full"``), every kernel launched on that path, and the
   decoded-fact checksum and every query's row set equal to the port's
   ``numpy`` backend on the same facts; then one more ``infer1`` run
   under ``torch.profiler`` for the device busy time;
4. kernel phase: each kernel at the main path's shapes on the card (the
   index-mirror merge's ranks at the largest shapes the engine phase
   gave them), bit-compared with its plain PyTorch version, timed with
   CUDA events (median of ``--reps`` runs, L2 flushed before each)
   beside the plain version, one PyTorch library call as a yardstick
   and the bound;
5. a ``{"kernels": [...]}`` line with every ported kernel's numbers and
   the kernels still queued for later slices;
6. the last line: ``{"ok": true, "device": {...}}``.

Nothing of JAX and nothing of the reference ``repro`` package is
imported.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM non-tensor-core float32 peak, the
#                             table's only rate for scalar (non-matrix) ops


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
    after a warm-up, with the L2 cache flushed before each run."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
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


def kernel_phase(torch, seed: int, reps: int, merge_shape) -> dict:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.sortmerge.ops import tag_bits_for
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain, merge_ranks, merge_ranks_plain)

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
    cap, dcap = merge_shape
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

    # the launches above compare and time the kernels; they are not the
    # main path's, so they are dropped from the counts
    kernels.reset_counts()
    for name, row in out.items():
        b, by = row.pop("bound")
        row["bound_ms"], row["bound_by"] = b, by
        print(json.dumps({"kernel": name, **row}), flush=True)
        if row["max_abs_err"] != 0:
            fail(f"{name}: kernel and plain version differ "
                 f"(max abs err {row['max_abs_err']})")
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
    # tests over the whole grid), so one AI-indexed run serves both presets
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

    launches = {name: 0 for name in kernels.LAUNCHES}
    shapes, undo = merge_shapes(torch_ops)
    for preset in ("infer1", "query1"):
        cfg = getattr(EngineConfig, preset)(backend="torch")
        cfg.eval_mode = "full"
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        snap = e.ops.transfers.snapshot()
        work = e.ops.sort_work.snapshot()
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
        checksum = decoded_fact_checksum(e)
        rec = {"preset": preset, "backend": "torch", "eval_mode": "full",
               "load_s": t1 - t0, "infer_s": t2 - t1, "query_s": t3 - t2,
               "facts_inferred": stats.facts_inferred,
               "iterations": stats.iterations,
               "rows": [len(s) for s in rows],
               "launches": counts["launches"],
               "width_fallbacks": counts["fallbacks"],
               "transfers": {"h2d_calls": moved.h2d_calls,
                             "h2d_bytes": moved.h2d_bytes,
                             "d2h_calls": moved.d2h_calls,
                             "d2h_bytes": moved.d2h_bytes},
               "sort_work": sorted_work.as_dict(),
               "merge_shapes": sorted(set(shapes[n_shapes:])),
               "cache": e.ops.cache.stats(),
               "checksum": checksum,
               "checksum_equal": checksum == ref_sum,
               "rows_equal": rows == ref_rows}
        print(json.dumps(rec), flush=True)
        for name, c in counts["launches"].items():
            launches[name] += c
        if stats.facts_inferred != ref_stats.facts_inferred:
            fail(f"{preset}: facts_inferred {stats.facts_inferred} != "
                 f"{ref_stats.facts_inferred} (numpy)")
        if checksum != ref_sum:
            fail(f"{preset}: decoded fact checksum differs from numpy")
        if rows != ref_rows:
            fail(f"{preset}: query row sets differ from numpy")
        # release this engine's device cache before the next preset
        e.ops.cache.clear()
    undo()
    # a preset may skip a kernel for a reason of its data: an index
    # mirror whose column outgrows its power-of-two buffer is re-sorted,
    # not merged (at scale 500, infer1's only in-infer LPIM compaction
    # does), so the check is over the path of both presets together
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} never launched on the path")
    device_profile(torch, facts, "infer1")
    return launches, max(shapes)


OUR_KERNELS = ("tile_passes", "cross_pass", "probe_kernel", "rank_kernel")


def device_profile(torch, facts, preset: str) -> None:
    """Device busy time of one more fresh run of ``preset`` (load, infer,
    queries) under ``torch.profiler``: the sum of device kernel times,
    the share spent in the port's own CUDA kernels, and the top kernels.
    The profiler's overhead lengthens ``wall_s``, so ``idle_share`` is an
    upper bound; the timed runs above are the end-to-end numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES

    cfg = getattr(EngineConfig, preset)(backend="torch")
    cfg.eval_mode = "full"
    e = HiperfactEngine(cfg)
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
    # device-side events only (kernels, memcpys): a host op's device time
    # repeats the time of the kernels it launched
    per = {ev.key: (ev.self_device_time_total, ev.count)
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0}
    busy = sum(us for us, _ in per.values()) / 1e6
    ours = sum(us for k, (us, _) in per.items()
               if any(n in k for n in OUR_KERNELS)) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "profile": preset, "wall_s": wall,
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / wall if busy else "not measured",
        "own_kernels_s": ours,
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
]
QUEUED = [
    {"name": "unique_mask_sorted", "status": "queued", "roadmap": "B5",
     "replaces": "src/repro/kernels/uniquefilter/uniquefilter.py:32"},
    {"name": "flash_attention", "status": "queued", "roadmap": "B6",
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    {"name": "ssd_intra", "status": "queued", "roadmap": "B7",
     "replaces": "src/repro/kernels/ssd/ssd.py:53"},
]


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

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_library_s": secs}), flush=True)

    launches, merge_shape = engine_phase(torch, args.scale, args.seed)
    rows = kernel_phase(torch, args.seed, args.reps, merge_shape)

    line = []
    for k in KERNELS:
        r = rows[k["name"]]
        line.append({**k, "status": "ported and checked",
                     "launches": launches[k["name"]],
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line, "queued": QUEUED, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
