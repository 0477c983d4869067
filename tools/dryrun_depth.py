#!/usr/bin/env python3
"""The dry run's time for a cell too long to trace whole, from traces at
one and two depth units.

Usage: ``PYTHONPATH=src python3 tools/dryrun_depth.py --arch yi-6b
[--shape train_4k] [--mesh single|multi]``

Traces the cell (``repro_torch.launch.dryrun.build_cell`` and
``run_cell``, on the production mesh of fake devices) with the config cut
to one and then two depth units (a layer, or a group of the block pattern
for the hybrid family; the enc-dec family cuts its encoder alike) and
projects the whole depth's trace seconds as ``t1 + (units - 1) * (t2 -
t1)``, and each of the record's per-device figures alike: the peak bytes,
the roofline terms and each collective kind's count, bytes and seconds.
Prints one JSON line with both traces' seconds, op counts, figures and the
process's peak RSS, and the projections.  Touches no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()

    mesh = D.production_mesh(args.mesh == "multi")
    full = get_config(args.arch)
    unit = len(full.pattern) if full.pattern else 1
    out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "n_layers": full.n_layers, "unit": unit}
    for k in (1, 2):
        cut = {"n_layers": k * unit}
        if full.n_enc_layers:
            cut["n_enc_layers"] = k
        cfg = dataclasses.replace(full, **cut)
        with D.ShapeMode():
            fn, fargs, meta = D.build_cell(args.arch, args.shape, mesh,
                                           cfg=cfg)
            rec, _ = D.run_cell(fn, fargs, meta, mesh, "", "depth")
        out[f"units_{k}"] = {
            "layers": k * unit, "trace_s": rec["lower_s"],
            "ops": rec["hlo_bytes"], "figures": figures(rec),
            "max_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6}
    n = full.n_layers // unit
    t1, t2 = out["units_1"]["trace_s"], out["units_2"]["trace_s"]
    out["projected_trace_s"] = t1 + (n - 1) * (t2 - t1)
    out["projected"] = project(out["units_1"]["figures"],
                               out["units_2"]["figures"], n)
    print(json.dumps(out), flush=True)


def figures(rec: dict) -> dict:
    """A record's per-device figures, flat: peak bytes, the roofline
    terms, and ``<kind>.<count|bytes|time_s>`` for each collective."""
    out = {"peak_bytes_per_device": rec["memory"]["peak_bytes_per_device"],
           **rec["roofline"]}
    for kind, c in rec["hlo"]["collectives"].items():
        for k, v in c.items():
            out[f"{kind}.{k}"] = v
    return out


def project(f1: dict, f2: dict, units: int) -> dict:
    """Each figure at ``units`` depth units, linear through one and two
    (a figure missing at one depth counts 0 there)."""
    return {k: f1.get(k, 0) + (units - 1) * (f2.get(k, 0) - f1.get(k, 0))
            for k in sorted(set(f1) | set(f2))}


if __name__ == "__main__":
    main()
