#!/usr/bin/env python3
"""Time builds of the port's probe, unique-mask and merge-rank kernels on one
NVIDIA GPU.

Usage: ``python3 tools/search_probe.py --kernel
probe_sorted|unique_mask|merge_ranks [--reps R] [--seed S] [--old PATH]
[--alt NAME:PATH ...] [--variant NAME:CONST=VALUE,... ...]``

Each ``--variant`` is the kernel's source
(``src/repro_torch/kernels/csrc/probe_sorted.cu``, ``unique_mask.cu`` or
``merge_ranks.cu``) with some of the ``constexpr int`` constants at its
head replaced (``NAME:`` alone is the source as it stands); the patched
copies are written to the probe's build directory (the shared headers are
found in ``csrc/``), and the source in the tree is never changed.
``--alt NAME:PATH`` adds another source with the same C entry point;
``--old PATH`` an earlier design's source (the first probe and rank
designs' entry points took no tree scratch).  Every build is made with
``nvcc -Xptxas -v``, all in parallel.  Then, for each build in turn
(``--old`` first and last), the wrapper is pointed at it (and the Python
mirror of its tree constants set to the build's) and
``chip_smoke.search_detail`` runs that kernel at its by-size shapes, or
``chip_smoke.rank_detail`` the merge ranks at ``RANK_SHAPES``: bit checks
against the plain version, kernel ms beside the library call's ms and the
bound.  Prints one JSON line per build and writes them all, with each
build's register and spill report, to
``chiprun_out/search_probe_<kernel>.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

# an earlier design's C entry point, where it differs: (argument kinds,
# the call made with the wrapper's arguments)
OLD_ENTRY = {
    "probe_sorted": ("pipippp",
                     lambda f: lambda *a: f(*a[:6], a[-1])),
    "merge_ranks": ("pipiipp",
                    lambda f: lambda *a: f(*a[:6], a[-1])),
}
# (run lanes, delta lanes) of the merge-rank rows: the engine's largest
# index-mirror merge and smaller ones
RANK_SHAPES = [(1 << 21, 1 << 13), (1 << 20, 1 << 13), (1 << 19, 1 << 12),
               (1 << 18, 1 << 10)]
# the merge-rank tree constants the wrapper's plan mirrors
RANK_MIRROR = ("RANK_TABLE_LOG2", "RANK_SMALL_N_LOG2",
               "RANK_SMALL_TABLE_LOG2")
# the trials behind the shipped constants, by library
VARIANTS = {
    "probe_sorted": [
        "shipped:",
        "threads-512:PROBE_THREADS=512",
        "threads-256:PROBE_THREADS=256",
        "table-13:PROBE_TABLE_LOG2=13",
        "table-12:PROBE_TABLE_LOG2=12",
        "table-13-threads-512:PROBE_TABLE_LOG2=13,PROBE_THREADS=512",
    ],
    "unique_mask": [
        "shipped:",
        "threads-128:UM_THREADS=128",
        "threads-512:UM_THREADS=512",
        "threads-1024:UM_THREADS=1024",
    ],
    # the tree's size for few keys (n <= 2^13: the delta ranked into the
    # run), down to none (a binary search over device memory), and the
    # block size
    "merge_ranks": [
        "shipped:",
        "small-6:RANK_SMALL_TABLE_LOG2=6",
        "small-10:RANK_SMALL_TABLE_LOG2=10",
        "small-0:RANK_SMALL_TABLE_LOG2=0",
        "small-128:RANK_SMALL_THREADS=128",
        "small-1024:RANK_SMALL_THREADS=1024",
        "threads-512:RANK_THREADS=512",
    ],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--old", type=Path, default=None,
                    help="another source with the same C entry point")
    ap.add_argument("--alt", action="append", default=[],
                    help="NAME:PATH, another source with the current entry "
                         "point")
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME:CONST=VALUE,... (constants of the .cu)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("search_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mergejoin import mergejoin
    from sort_probe import build, patched

    card = chip_smoke.card_line()
    print(card, flush=True)
    lib_name = args.kernel
    shipped = (_build.CSRC / _build.SOURCES[lib_name][0]).read_text()
    sources, values = {}, {}
    for spec in args.variant or VARIANTS[lib_name]:
        name, _, assigns = spec.partition(":")
        values[name] = {k: int(v) for k, v in (
            a.split("=") for a in assigns.split(",") if a)}
        sources[name] = patched(shipped, values[name])
    for spec in args.alt:
        name, _, path = spec.partition(":")
        sources[name], values[name] = Path(path).read_text(), {}
    order = list(sources)
    if args.old is not None:
        sources["old"], values["old"] = args.old.read_text(), {}
        order = ["old", *order, "old"]
    built = build(sources, _build.BUILD_DIR / "search_probe", stem=lib_name)
    mirror = {k: getattr(mergejoin, k) for k in ("PROBE_TABLE_LOG2",
                                                  *RANK_MIRROR)}
    sizes = ({"unique_sizes": ()} if lib_name == "probe_sorted"
             else {"probe_sizes": ()})

    results = []
    for name in order:
        lib = _build.load(built[name][0], lib_name)
        if name == "old" and lib_name in OLD_ENTRY:
            kinds, call = OLD_ENTRY[lib_name]
            (fn_name, _), = _build.SOURCES[lib_name][1].items()
            fn = getattr(lib, fn_name)
            fn.argtypes = [_build._ARG[k] for k in kinds]
            lib = types.SimpleNamespace(**{fn_name: call(fn)})
        _build._LIBS[lib_name] = lib
        for k, v in mirror.items():  # the wrappers size scratch by them
            setattr(mergejoin, k, values[name].get(k, v))
        if name == "old":  # the first designs took no tree scratch
            mergejoin.PROBE_TABLE_LOG2 = mergejoin.RANK_TABLE_LOG2 = 31
            mergejoin.RANK_SMALL_TABLE_LOG2 = 31
        rec = {"build": name, "values": values[name],
               "ptxas": built[name][1], "card": card}
        print(json.dumps(rec), flush=True)
        rng = np.random.RandomState(args.seed)
        try:
            rec["rows"] = (
                chip_smoke.rank_detail(torch, rng, args.reps, RANK_SHAPES)
                if lib_name == "merge_ranks" else
                chip_smoke.search_detail(torch, rng, args.reps, **sizes))
        except SystemExit:  # a check failed: recorded, the probe goes on
            rec["failed"] = True
        results.append(rec)
    _build._LIBS.pop(lib_name, None)
    for k, v in mirror.items():
        setattr(mergejoin, k, v)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"search_probe_{lib_name}.json").write_text(
        json.dumps(results, indent=1))
    return 1 if any(r.get("failed") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
