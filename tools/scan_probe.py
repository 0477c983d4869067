#!/usr/bin/env python3
"""The RG-LRU scan kernel on the card, and recurrentgemma-9b's serving
before and after it.

Usage: ``python3 tools/scan_probe.py [--parent DIR] [--out PATH] [--reps R]
[--seed S]``

1. Builds the port's kernels (``csrc/linear_scan.cu`` among them) and runs
   ``chip_smoke.scan_row`` at recurrentgemma-9b's prefill shape ([2, 4096,
   4096] float32) and at the small ragged shapes of ``SMALL``: the kernel
   against the plain passes on the card and against the recurrence
   stepped in float64, without and with ``h0``, each within
   ``chip_smoke.SCAN_TOL`` of the scale (a miss exits non-zero before
   step 2); kernel and plain ms, CUDA events, L2 flushed.
2. With ``--parent DIR`` (another commit's checkout, e.g. a ``git
   archive`` of it unpacked into a git-ignored directory of this one):
   ``chip_smoke.lm_phase`` for recurrentgemma-9b alone, a child process a
   run, in the order parent, this tree, this tree, parent.  Each child
   imports the ``chip_smoke.py`` and ``src/`` of its own tree, so each
   run serves the model as that commit does (full width and depth, B 2 x
   4096-token prompts, 16 greedy steps, its own gates) and prints its
   ``{"lm": ...}``, ``{"lm_prefill_profile": ...}`` and
   ``{"lm_profile": ...}`` lines.

Prints one JSON line per step and, with ``--out``, writes them with the
card's name and power limit to PATH as one JSON record.  Card only;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, D): one position, a ragged tile tail and a ragged channel group,
# two tiles and one row, a channel group and one
SMALL = ((1, 1, 32), (2, 7, 40), (2, 129, 33), (1, 257, 96))
PROBE_KEYS = {"lm": ("prefill_s", "decode_ms_per_token", "peak_device_gb",
                     "consistency_err", "f32_consistency_err", "launches"),
              "lm_prefill_profile": ("wall_s", "device_busy_s", "scan_ms",
                                     "scan_plain_ms", "scan_device_ms",
                                     "scan_share_of_prefill")}
CHILD = """
import json, sys
tree, seed = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke as C
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
models = [m for m in C.LM_MODELS if m[0] == "recurrentgemma-9b"]
C.lm_phase(torch, seed, C.LM_STEPS, models)
"""


def serve(tree: Path, label: str, seed: int) -> dict:
    """recurrentgemma-9b's LM phase as the commit at ``tree`` runs it, in
    a child: the figures of its lines (``PROBE_KEYS``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), str(seed)],
                          cwd=tree, env=env, capture_output=True, text=True,
                          timeout=1200)
    out = {"run": label, "tree": str(tree), "rc": proc.returncode,
           "seconds": time.perf_counter() - t0}
    for ln in proc.stdout.splitlines():
        if not ln.startswith("{"):
            continue
        rec = json.loads(ln)
        for kind, keys in PROBE_KEYS.items():
            if kind in rec:
                out[kind] = {k: rec.get(k) for k in keys}
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-4000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another commit's checkout to serve beside this one")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the whole record here as JSON")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as C
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("scan_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": C.card_line(), "kind": torch.cuda.get_device_name(0)}
    print(record["card"], flush=True)
    t0 = time.perf_counter()
    record["build_s"] = _build.build_all()
    record["build_wall_s"] = time.perf_counter() - t0
    print(json.dumps({"build": record["build_s"]}), flush=True)

    rng = np.random.RandomState(args.seed)
    rows = []
    for shape in (C.SCAN_SHAPE, *SMALL):
        reps = args.reps if shape == C.SCAN_SHAPE else 3
        row = C.scan_row(torch, rng, reps, shape)
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        rows.append(row)
        print(json.dumps({"scan_row": row}), flush=True)
    record["scan_rows"] = rows

    runs = []
    if args.parent is not None:
        for label in ("parent", "change", "change", "parent"):
            tree = args.parent.resolve() if label == "parent" else ROOT
            run = serve(tree, label, args.seed)
            runs.append(run)
            print(json.dumps({"serve": run}), flush=True)
    record["serve"] = runs
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    bad = [r["run"] for r in runs if r["rc"] != 0]
    if bad:
        print(f"scan_probe: serving failed in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
