#!/usr/bin/env python3
"""The LM's mesh forms on the card, this tree beside another commit's.

Usage: ``python3 tools/shard_probe.py --parent DIR [--out PATH]``

``DIR`` is another commit's checkout (e.g. a ``git archive`` of it
unpacked into a git-ignored directory of this one).  In the order
parent, this tree, this tree, parent, a child process imports its
tree's ``chip_smoke.py`` and ``src/``, builds the kernels
(``_build.build_all``), and runs that tree's sharding parts as its smoke
runs them (the smoke's default seed, 0) on a 2x4 mesh over
``[cuda] * 8``, with their own gates: ``shard_train`` (yi-6b 4/32
FSDP+TP steps), ``shard_serve`` (yi-6b whole, split-cache prefill and
decode) and ``shard_mixer`` for every ``SHARD_MIXERS`` entry.  No other
process shares the host.  The child's
lines give each part's times: the FSDP+TP steps' ms, the sharded and
single-device prefill ms and decode ms a step, and the peak GB.

Prints one JSON line per child and, with ``--out``, writes them with the
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
SEED = 0     # chip_smoke.py's default ``--seed``
KEYS = ("step_ms", "single_step_ms", "prefill_ms", "single_prefill_ms",
        "decode_ms", "single_decode_ms", "peak_device_gb", "seq_rows")
CHILD = """
import sys
tree, seed = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke as C
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_host_mesh
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
mesh = make_host_mesh(C.SHARD_MESH, devices=["cuda"] * 8)
C.shard_train(torch, seed, mesh, "cuda")
C.shard_serve(torch, seed, mesh, "cuda")
for arch, shape, batch, seq in C.SHARD_MIXERS:
    C.shard_mixer(torch, seed, arch, shape, batch, seq, "cuda")
"""


def run(tree: Path, label: str) -> dict:
    """The tree's sharding parts in a child -> each part's figures
    (``KEYS``), by part and arch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), str(SEED)],
                          cwd=tree, env=env, capture_output=True, text=True,
                          timeout=1500)
    out = {"run": label, "tree": str(tree), "rc": proc.returncode,
           "seconds": time.perf_counter() - t0, "parts": {}}
    for ln in proc.stdout.splitlines():
        if not ln.startswith("{"):
            continue
        rec = json.loads(ln)
        if rec.get("phase") != "sharding":
            continue
        name = f"{rec['part']} {rec.get('arch', '')} " + "x".join(
            str(v) for v in rec.get("mesh", {}).values())
        out["parts"][name] = {k: rec[k] for k in KEYS if k in rec}
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-4000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for label, tree in (("parent", args.parent.resolve()), ("this", ROOT),
                        ("this", ROOT), ("parent", args.parent.resolve())):
        rec = run(tree, label)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs},
                                       indent=1))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
