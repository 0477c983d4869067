#!/usr/bin/env python3
"""Time builds of the port's SSD intra-chunk kernel on one NVIDIA GPU.

Usage: ``python3 tools/ssd_probe.py [--reps R] [--seed S] [--old PATH]
[--alt NAME:PATH ...] [--variant NAME:CONST=VALUE,... ...] [--prefill]``

Each ``--variant`` is ``src/repro_torch/kernels/csrc/ssd_intra.cu`` with
some of the ``constexpr int`` constants at its head replaced (``NAME:``
alone is the source as it stands); the patched copies are written to the
probe's build directory, and the source in the tree is never changed.
``--alt NAME:PATH`` adds another source with the same C entry points;
``--old PATH`` the first design's source (its entry point took no gram
scratch and it had no gram pass).  Every build is made with ``nvcc
-Xptxas -v``, all in parallel.  Then, for each build in turn (``--old``
first and last), the wrapper is pointed at it and ``ssd_intra`` runs at
each of ``SHAPES`` (mamba2-1.3b's prefill first): the error against the
plain version (the 1e-4 gate of ``chip_smoke.py``), kernel ms and, where
the build has one, the gram pass's ms, beside the plain version's ms.
With ``--prefill`` each build also serves mamba2-1.3b's prefill at full
width (B = 2 prompts of S = 2048 tokens, random weights from ``--seed``;
``chip_smoke.py``'s LM phase) three times, and the median ``prefill_s``
is recorded.  Prints one JSON line per build and writes them all, with
each build's register and spill report, to
``chiprun_out/ssd_probe.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

# (b, nc, Q, nh, hp, N): mamba2-1.3b's prefill, then the other widths the
# kernel takes (hp = 128 on its second template, N = 64, a ragged Q)
SHAPES = [(2, 8, 256, 64, 64, 128), (2, 8, 256, 32, 128, 128),
          (2, 8, 256, 64, 64, 64), (2, 8, 70, 64, 64, 128)]
# the source as it stands; other designs come in through --alt and --old
VARIANTS = ["shipped:"]


def load(path: Path, old: bool):
    """The build's entry points as the wrapper calls them; the first
    design's ``ssd_intra_f32`` took no gram scratch."""
    from repro_torch.kernels import _build

    if not old:
        return _build.load(path, "ssd_intra")
    lib = ctypes.CDLL(str(path))
    f = lib.ssd_intra_f32
    f.argtypes = [_build._ARG[k] for k in "pppppp" + "i" * 6 + "p"]
    f.restype = ctypes.c_int
    return types.SimpleNamespace(
        ssd_intra_f32=lambda *a: f(*a[:12], a[-1]), ssd_gram_f32=None)


def kernel_rows(torch, rng, reps: int, lib) -> list:
    import numpy as np

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.ssd import (gram_scratch, ssd_intra,
                                             ssd_intra_plain)

    rows = []
    for b, nc, Q, nh, hp, N in SHAPES:
        dlog = -np.abs(rng.randn(b, nc, Q, nh)).astype(np.float32) * 0.05
        cum = torch.tensor(np.cumsum(dlog, axis=2), device="cuda")
        u, Bm, Cm = (torch.tensor(rng.randn(*s).astype(np.float32),
                                  device="cuda")
                     for s in ((b, nc, Q, nh, hp), (b, nc, Q, N),
                               (b, nc, Q, N)))
        y, st = ssd_intra(cum, u, Bm, Cm)
        yp, sp = ssd_intra_plain(cum, u, Bm, Cm)
        errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in ((y, yp), (st, sp))]
        row = {"shape": [b, nc, Q, nh, hp, N], "rel_err": max(errs),
               "gate": 1e-4,
               "kernel_ms": chip_smoke.time_ms(
                   torch, lambda: ssd_intra(cum, u, Bm, Cm), reps),
               "gram_ms": None,
               "plain_ms": chip_smoke.time_ms(
                   torch, lambda: ssd_intra_plain(cum, u, Bm, Cm), reps)}
        if lib.ssd_gram_f32 is not None:
            gram = gram_scratch(b, nc, Q, "cuda")
            row["gram_ms"] = chip_smoke.time_ms(torch, lambda: _build.check(
                lib.ssd_gram_f32(Bm.data_ptr(), Cm.data_ptr(), b, nc, Q, N,
                                 gram.data_ptr(), gram.shape[0],
                                 torch.cuda.current_stream().cuda_stream),
                "ssd_gram"), reps)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def prefill_model(torch, seed: int):
    """mamba2-1.3b at full width with random weights, as the smoke's LM
    phase serves it, and its prompts."""
    import numpy as np

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params

    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg)
    params = init_params(model.spec(), seed)
    chip_smoke.seed_conv_taps(torch, params, seed)
    seq = next(row[3] for row in chip_smoke.LM_MODELS
               if row[0] == "mamba2-1.3b")
    prompts = torch.tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, (chip_smoke.LM_BATCH, seq)).astype(np.int32),
        device="cuda")
    return model, params, prompts


def prefill_s(torch, model, params, prompts, runs: int = 3) -> list:
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.prefill_fn(params, prompts, prompts.shape[1] + 16)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--old", type=Path, default=None,
                    help="the first design's source")
    ap.add_argument("--alt", action="append", default=[],
                    help="NAME:PATH, another source with the current entry "
                         "points")
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME:CONST=VALUE,... (constants of the .cu)")
    ap.add_argument("--prefill", action="store_true",
                    help="also time mamba2-1.3b's prefill with each build")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssd_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import _build
    from sort_probe import build, patched

    card = chip_smoke.card_line()
    print(card, flush=True)
    shipped = (_build.CSRC / "ssd_intra.cu").read_text()
    sources, values = {}, {}
    for spec in args.variant or VARIANTS:
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
    built = build(sources, _build.BUILD_DIR / "ssd_probe", stem="ssd_intra")
    lm = prefill_model(torch, args.seed) if args.prefill else None

    results = []
    for name in order:
        lib = load(built[name][0], name == "old")
        _build._LIBS["ssd_intra"] = lib
        rec = {"build": name, "values": values[name],
               "ptxas": built[name][1], "card": card}
        print(json.dumps(rec), flush=True)
        rec["rows"] = kernel_rows(torch, np.random.RandomState(args.seed),
                                  args.reps, lib)
        if lm is not None:
            rec["prefill_s"] = prefill_s(torch, *lm)
            rec["prefill_s_median"] = statistics.median(rec["prefill_s"])
            print(json.dumps({"build": name,
                              "prefill_s": rec["prefill_s"]}), flush=True)
        rec["failed"] = any(r["rel_err"] > r["gate"] for r in rec["rows"])
        results.append(rec)
    _build._LIBS.pop("ssd_intra", None)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ssd_probe.json").write_text(json.dumps(results, indent=1))
    return 1 if any(r["failed"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
