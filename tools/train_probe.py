#!/usr/bin/env python3
"""The training phase's gradient check and accumulation gate, swept, on
one NVIDIA GPU.

Usage: ``python3 tools/train_probe.py [--archs yi-6b,...] [--eps
3e-4,1e-3,3e-3,1e-2] [--seed S] [--profile]``

For each config of ``chip_smoke.TRAIN_MODELS`` (at its depth, batch and
tokens there; random float32-store weights from ``--seed``), in float32
with TF32 off: ``chip_smoke.grad_check`` at each ``--eps`` (its relative
error, the same at eps / 2, and ``L(p + eps d) - L(p - eps d)``) beside
the directional derivative ``<g, d>``.  For yi-6b also one step at
``accum=2`` against ``accum=1``: the two updates' difference over the
update's L2 norm, and the weights whose difference passes 0.01, 0.1,
0.5 and 1 times the learning rate.  With ``--profile`` (and ``--eps
""`` to skip the sweep), one train step in the config's compute type
after two warm-up steps, under ``torch.profiler``: its wall time, the
device's busy time, the device kernels it ran and the top ones by device
time.  Prints one JSON line per config and writes them to
``chiprun_out/train_probe.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def accum_spread(torch, cs, model, seed: int, data) -> dict:
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)
    p0 = cs.fresh_params(torch, model, seed)
    new = []
    for accum in (1, 2):
        state = init_train_state(cs.fresh_params(torch, model, seed))
        state, met = build_train_step(model, OptimizerConfig(**cs.TRAIN_OPT),
                                      accum)(state, data)
        new.append(state["params"])
        lr = float(met["lr"])
    diff = norm = 0.0
    over = {k: 0 for k in (0.01, 0.1, 0.5, 1.0)}
    for a, b, c in zip(*(tree_leaves(t) for t in (*new, p0))):
        d = (a - b).double()
        diff += float((d * d).sum())
        norm += float(((a - c).double() ** 2).sum())
        for k in over:
            over[k] += int((d.abs() > k * lr).sum())
    return {"update_rel_err": (diff / norm) ** 0.5, "lr": lr,
            "weights_over_lr": {str(k): v for k, v in over.items()}}


def profile_step(torch, cs, cfg, seed: int, data) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)
    model = build_model(cfg)
    state = init_train_state(cs.fresh_params(torch, model, seed))
    step = build_train_step(model, OptimizerConfig(**cs.TRAIN_OPT))
    for _ in range(2):
        state, _ = step(state, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = cs.device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall,
            "device_busy_s": busy if busy else "not measured",
            "idle_share": 1 - busy / wall if busy else "not measured",
            "device_kernels": sum(c for _, c in per.values()),
            "top_device_kernels": [{"name": k[:80], "ms": us / 1e3,
                                    "calls": c} for k, (us, c) in top]}


def main() -> int:
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(m[0]
                                                for m in cs.TRAIN_MODELS))
    ap.add_argument("--eps", default="3e-4,1e-3,3e-3,1e-2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.models import build_model

    print(cs.card_line(), flush=True)
    lines = []
    for arch, layers, batch, seq in cs.TRAIN_MODELS:
        if arch not in args.archs.split(","):
            continue
        t0 = time.perf_counter()
        cfg = cs.train_config(arch, layers)
        model = build_model(dataclasses.replace(cfg, dtype="float32"))
        data = cs.train_batch(torch, cfg, args.seed, batch, seq)
        params = cs.fresh_params(torch, model, args.seed)
        line = {"arch": arch, "layers": cfg.n_layers, "steps": {}}
        for eps in map(float, filter(None, args.eps.split(","))):
            c = cs.grad_check(torch, model, params, data, args.seed, eps)
            line["directional_derivative"] = c["directional_derivative"]
            line["steps"][str(eps)] = {
                "rel_err": c["rel_err"],
                "rel_err_half_eps": c["rel_err_half_eps"],
                "loss_difference": c["loss_plus"] - c["loss_minus"]}
        del params
        if arch == "yi-6b" and line["steps"]:
            line["accum"] = accum_spread(torch, cs, model, args.seed, data)
        if args.profile:
            line["profile"] = profile_step(torch, cs, cfg, args.seed, data)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        del model, data
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_probe.json").write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
