#!/usr/bin/env python3
"""Where moonshot-v1-16b-a3b's decode and forward part, on one NVIDIA GPU.

Usage: ``python3 tools/moe_probe.py [--seeds 0,1,2] [--prompt S]``

Serves moonshot-v1-16b-a3b at full width and depth (weights in the
16-bit store from seed 0, B = 2 prompts of S random tokens drawn from
each ``--seeds`` value) and, for each seed:

- the expert loads of one prefill at the configuration's capacity
  factor: per layer the largest expert's pairs, the experts past
  capacity and the pairs dropped;
- ``chip_smoke.consistency_pair`` at capacity factor E / k (no drops)
  in bf16 with free routing, in bf16 with the compared tokens' routing
  pinned to the decode step's, and in float32 with free routing: the
  decode step's logits against ``hidden()``'s, each error over
  max(1, scale), and the (layer, row) pairs whose top-k experts differ
  between the two forwards (``flips``).

Then the host syncs of one prefill and one decode step, under
``torch.cuda.set_sync_debug_mode("warn")``, by the port's source line
that made them.  Prints one JSON line per seed and one for the syncs,
and writes them all to ``chiprun_out/moe_probe.json``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

ARCH = "moonshot-v1-16b-a3b"


def expert_loads(torch, model, params, prompts) -> list:
    """[largest expert's pairs, experts past capacity, pairs dropped] per
    layer of one prefill at the configuration's capacity."""
    from repro_torch.models import moe

    cfg, route, loads = model.cfg, moe._route, []
    C = moe.capacity(cfg, prompts.numel())

    def counting(xf, w):
        p = route(xf, w)
        n = torch.bincount(torch.topk(p, cfg.top_k).indices.reshape(-1),
                           minlength=cfg.n_experts)
        loads.append([int(n.max()), int((n > C).sum()),
                      int(torch.clamp(n - C, min=0).sum())])
        return p

    moe._route = counting
    try:
        model.prefill_fn(params, prompts, prompts.shape[1] + 1)
    finally:
        moe._route = route
    return loads


def sync_sites(torch, model, params, prompts) -> dict:
    """{"file:line": syncs} of one prefill and one decode step."""
    sites = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        ours = [f for f in traceback.extract_stack()
                if "repro_torch" in f.filename]
        where = (f"{ours[-1].filename.split('src/')[-1]}:{ours[-1].lineno}"
                 if ours else "elsewhere")
        sites[where] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            logits, cache = model.prefill_fn(params, prompts,
                                             prompts.shape[1] + 1)
            model.decode_fn(params, logits.argmax(-1), cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--prompt", type=int, default=2048)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, init_params, moe

    if not torch.cuda.is_available():
        print("moe_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    _build.build_all()
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = init_params(model.spec(), 0, store=cfg.dtype)
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    seq, lines = args.prompt, []
    for seed in (int(s) for s in args.seeds.split(",")):
        prompts = torch.tensor(np.random.RandomState(seed).randint(
            0, cfg.vocab, (2, seq)).astype(np.int32), device="cuda")
        with torch.no_grad():
            loads = expert_loads(torch, model, params, prompts)
            logits, _ = model.prefill_fn(params, prompts, seq + 1)
        ext = torch.cat([prompts, logits.argmax(-1)[:, None].to(
            prompts.dtype)], dim=1)
        pairs = {}
        for name, dt, pin in (("bf16_free", "bfloat16", False),
                              ("bf16_pinned", "bfloat16", True),
                              ("f32_free", "float32", False)):
            r = chip_smoke.consistency_pair(
                torch, dataclasses.replace(nodrop, dtype=dt), params, ext,
                seq, pin=pin)
            pairs[name] = {"err": r["err"], "scale": r["scale"],
                           "rel": r["err"] / max(1.0, r["scale"]),
                           "flips": r["flips"], "dropped": r["dropped"]}
        line = {"moe_probe": ARCH, "seed": seed, "prompt": seq,
                "capacity": moe.capacity(cfg, 2 * seq),
                "pairs_per_forward": 2 * seq * cfg.top_k * cfg.n_layers,
                "dropped_at_configured": sum(x[2] for x in loads),
                "loads_by_layer": loads, "consistency": pairs, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    line = {"moe_probe_syncs": ARCH,
            "sites": sync_sites(torch, model, params, prompts), "card": card}
    print(json.dumps(line), flush=True)
    lines.append(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "moe_probe.json").write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
