#!/usr/bin/env python3
"""Time builds of the port's bitonic sort kernels on one NVIDIA GPU.

Usage: ``python3 tools/sort_probe.py [--reps R] [--seed S] [--old PATH]
[--sweep LO,HI] [--variant NAME:CONST=VALUE,... ...]``
or ``python3 tools/sort_probe.py --ptxas SOURCE [--ptxas SOURCE ...]``

Each ``--variant`` is ``src/repro_torch/kernels/csrc/bitonic_sort.cu``
with some of the constants at its head replaced (``NAME:`` alone is the
source as it stands; ``SORT_MIN_TILES=0`` keeps every size on the top
tier); the patched copies are written to the probe's build directory, and
the source in the tree is never changed.  ``--old PATH`` adds a source of
the first design (kernels ``tile_passes`` and ``cross_pass``, 4096-element
tiles, one launch per cross-tile level) with the same C entry points.
Every build is made with ``nvcc -Xptxas -v``, all in parallel.  Then, for
each build in turn (``--old`` first and last), the wrappers are pointed at
it, ``sortmerge``'s mirror of the constants is set to the build's, and
``chip_smoke.sort_detail`` runs both sorts at 2^13, 2^16, 2^18 and the
table shapes (with ``--sweep``, at every power of two from 2^LO to 2^HI
and the table shapes): bit checks against the plain versions, kernel ms
beside ``torch.sort`` ms, and at the table shapes the device kernels of
one call, checked against ``launch_plan``, and their split into first
tile, cross-tile and later tile launches.  Prints one JSON line per build
and writes them all, with each build's register and spill report, to
``chiprun_out/sort_probe.json``.  With ``--ptxas`` the probe only builds
each named file of ``src/repro_torch/kernels/csrc/`` (by its name or its
path) the same way and prints one JSON line per entry function (mangled
name, registers, spill bytes stored); that needs ``nvcc`` but no card.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# constant of the .cu -> (attribute of sortmerge's mirror, its value)
MIRROR = {
    "SORT_TILE_LOG2": ("SORT_TILE", lambda v: 1 << v),
    "SORT_REG_LOG2": ("SORT_REG", lambda v: 1 << v),
    "SORT_KV_TILE_LOG2": ("SORT_KV_TILE", lambda v: 1 << v),
    "SORT_KV_REG_LOG2": ("SORT_KV_REG", lambda v: 1 << v),
    "SORT_FUSE": ("SORT_FUSE", int),
    "SORT_MIN_TILES": ("SORT_MIN_TILES", int),
    "SORT_CROSS_LEVELS": ("SORT_CROSS_LEVELS", int),
}
# the first design, as the mirror describes it
OLD_PLAN = {"SORT_TILE_LOG2": 12, "SORT_KV_TILE_LOG2": 12, "SORT_FUSE": 1,
            "SORT_CROSS_LEVELS": 1, "SORT_MIN_TILES": 0}
OLD_KERNELS = ("tile_passes", "cross_pass")
# the trials behind the shipped constants: the source as it stands, one
# tile for every size at four tile widths, and a 2^14 key-value tile
VARIANTS = [
    "shipped:",
    "kv-tile-14:SORT_KV_TILE_LOG2=14,SORT_MIN_TILES=0",
    "one-tier-14:SORT_MIN_TILES=0",
    "one-tier-13:SORT_TILE_LOG2=13,SORT_REG_LOG2=4,SORT_MIN_TILES=0",
    "one-tier-12:SORT_TILE_LOG2=12,SORT_REG_LOG2=4,SORT_KV_TILE_LOG2=12,"
    "SORT_MIN_TILES=0",
    "one-tier-10:SORT_TILE_LOG2=10,SORT_REG_LOG2=3,SORT_KV_TILE_LOG2=10,"
    "SORT_KV_REG_LOG2=3,SORT_MIN_TILES=0",
]


def patched(src: str, values: dict) -> str:
    """``src`` with each ``constexpr int NAME = ...;`` of ``values`` set."""
    for name, value in values.items():
        src, hits = re.subn(rf"^constexpr int {name} = \d+;",
                            f"constexpr int {name} = {value};", src,
                            flags=re.M)
        if hits != 1:
            raise SystemExit(f"sort_probe: no constant {name} in the source")
    return src


def ptxas_table(log: str) -> list:
    """[kernel, registers, spill bytes stored] of each entry function in
    ``nvcc -Xptxas -v`` output."""
    rows, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln and name:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
            rows.append([name, None, spill])
        elif "Used" in ln and "registers" in ln and rows:
            rows[-1][1] = int(ln.split("Used ")[1].split()[0])
    return rows


def build(sources: dict, out_dir: Path, stem: str = "bitonic_sort") -> dict:
    """{name: source text} -> {name: (library path, ptxas table)}; the
    files are named ``{stem}-{name}``."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{stem}-{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, ptxas_table(log))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--old", type=Path, default=None,
                    help="a source of the first design, same entry points")
    ap.add_argument("--sweep", type=str, default=None,
                    help="LO,HI: both sorts at every 2^LO..2^HI")
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME:CONST=VALUE,... (constants of the .cu)")
    ap.add_argument("--ptxas", action="append", default=None,
                    metavar="SOURCE",
                    help="only report registers and spills of csrc/SOURCE "
                         "(a file name, or its path in the repository)")
    args = ap.parse_args()
    if args.ptxas:
        from repro_torch.kernels import _build
        built = build({Path(n).stem: (_build.CSRC / Path(n).name).read_text()
                       for n in args.ptxas}, ROOT / "build" / "ptxas_report",
                      stem="ptxas")
        for name, (_, table) in built.items():
            for kernel, regs, spill in table:
                print(json.dumps({"source": f"{name}.cu", "kernel": kernel,
                                  "registers": regs,
                                  "spill_store_bytes": spill}), flush=True)
        return 0

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sort_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.sortmerge import sortmerge

    card = chip_smoke.card_line()
    print(card, flush=True)
    shipped = (_build.CSRC / "bitonic_sort.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", shipped, re.M)}
    sources, values = {}, {}
    for spec in args.variant or VARIANTS:
        name, _, assigns = spec.partition(":")
        values[name] = {k: int(v) for k, v in (
            a.split("=") for a in assigns.split(",") if a)}
        sources[name] = patched(shipped, values[name])
    order = list(sources)
    if args.old is not None:
        sources["old"], values["old"] = args.old.read_text(), OLD_PLAN
        order = ["old", *order, "old"]
    built = build(sources, _build.BUILD_DIR / "sort_probe")
    sizes = (13, 16, 18)
    if args.sweep:
        lo, hi = map(int, args.sweep.split(","))
        sizes = range(lo, hi + 1)

    results = []
    mirror0 = {attr: getattr(sortmerge, attr) for attr, _ in MIRROR.values()}
    kernels0 = chip_smoke.SORT_KERNELS
    for name in order:
        _build._LIBS["bitonic_sort"] = _build.load(built[name][0],
                                                   "bitonic_sort")
        for const, (attr, conv) in MIRROR.items():
            setattr(sortmerge, attr,
                    conv(values[name].get(const, consts[const])))
        chip_smoke.SORT_KERNELS = OLD_KERNELS if name == "old" else kernels0
        rec = {"build": name, "values": values[name],
               "ptxas": built[name][1], "card": card}
        print(json.dumps(rec), flush=True)
        try:
            rec["rows"] = chip_smoke.sort_detail(
                torch, np.random.RandomState(args.seed), args.reps, sizes)
        except SystemExit:  # a check failed: recorded, the probe goes on
            rec["failed"] = True
        results.append(rec)
    _build._LIBS.pop("bitonic_sort", None)
    for attr, value in mirror0.items():
        setattr(sortmerge, attr, value)
    chip_smoke.SORT_KERNELS = kernels0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sort_probe.json").write_text(json.dumps(results, indent=1))
    return 1 if any(r.get("failed") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
