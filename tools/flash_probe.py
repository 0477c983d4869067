#!/usr/bin/env python3
"""Time builds of the port's tensor-core attention kernel at head dim 64
on one NVIDIA GPU.

Usage: ``python3 tools/flash_probe.py [--old PATH]
[--variant NAME:CONST=VALUE,... ...]``

Each ``--variant`` is ``src/repro_torch/kernels/csrc/flash_attention_tc.cu``
with some of the ``constexpr int`` constants at its head replaced
(``NAME:`` alone is the source as it stands; ``HD64_STAGES`` sets the
ring's depth); the patched
copies are written to the probe's build directory, and the source in the
tree is never changed.  ``--old PATH`` adds another source with the same
C entry points (an earlier design).  Every build is made with ``nvcc
-Xptxas -v``, all in parallel; the probe records each one's registers,
spills, ``ptxas`` warnings and performance notes (``wgmma`` serialized),
and the opcode counts of its attention kernels' SASS (``cuobjdump
-sass``).  Then, for each build in turn (``--old`` first and last), the
wrapper is pointed at it and ``flash_attention`` runs at whisper-tiny's
two shapes (B 16, 6/6 heads, hd 64, bf16, non-causal: the encoder's 1500
x 1500 and the cross-attention's 432 -> 1500): the error against the
plain version (2e-2), kernel ms (median of ``REPS``) beside
``F.scaled_dot_product_attention``'s on the same inputs, and the bound.
Each build is also held against the plain version at the edge cases of
``CASES``.  Inputs are drawn from ``SEED``.
Prints one JSON line per build and writes them all to
``chiprun_out/flash_probe.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

# (B, Sq, Skv, Hq, Hkv): whisper-tiny's encoder and cross-attention
SHAPES = {"encoder": (16, 1500, 1500, 6, 6), "cross": (16, 432, 1500, 6, 6)}
# (B, Sq, Skv, Hq, Hkv, causal, window, dtype name, tolerance): the
# hd-64 tiles' edges (192-row blocks, 128-key tiles), groups of 1 to 12,
# the masks, fp16
CASES = [(1, 1, 1, 1, 1, False, 0, "bfloat16", 2e-2),
         (1, 63, 63, 4, 1, True, 0, "bfloat16", 2e-2),
         (1, 65, 65, 8, 8, False, 17, "float16", 4e-3),
         (2, 191, 191, 4, 4, True, 17, "bfloat16", 2e-2),
         (1, 192, 300, 8, 1, True, 0, "float16", 4e-3),
         (1, 193, 129, 6, 6, False, 0, "bfloat16", 2e-2),
         (2, 300, 77, 8, 1, True, 0, "bfloat16", 2e-2),
         (2, 77, 300, 12, 1, False, 0, "bfloat16", 2e-2),
         (2, 77, 300, 12, 1, True, 100, "float16", 4e-3),
         (16, 1500, 1500, 6, 6, True, 0, "bfloat16", 2e-2),
         (16, 1500, 1500, 6, 6, True, 100, "bfloat16", 2e-2),
         (16, 1500, 1500, 6, 6, False, 0, "float16", 4e-3)]
REPS, SEED = 7, 0   # timed runs a median is taken of; the inputs' seed


# the opcodes counted in the other attention kernels' SASS
KEY_OPS = ("HGMMA", "WARPGROUP", "MUFU", "F2FP", "CALL", "RET", "BAR")


def sass_counts(lib: Path) -> dict:
    """Opcode counts of each attention kernel's SASS in ``lib`` (each
    instantiation apart; outside hd 64 only ``KEY_OPS``), or the error of
    ``cuobjdump``."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    try:
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)[:200]}
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if "flash_tc" in m.group(1) else None
            if name:
                out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if name and m:
            out[name][m.group(1)] += 1
    return {k: {op: n for op, n in v.most_common()
                if "flash_tc64" in k or op.startswith(KEY_OPS)}
            for k, v in out.items()}


def build(sources: dict, out_dir: Path) -> dict:
    """{name: source} -> {name: (library, ptxas table, ptxas warnings)}."""
    from repro_torch.kernels import _build
    from sort_probe import ptxas_table

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"flash_attention_tc-{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libflash_attention_tc-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        warnings = sorted({ln.strip()[:300] for ln in log.splitlines()
                           if re.search(r"warning|Performance|serializ|"
                                        r"setmaxnreg|C75\d\d", ln)})
        built[name] = (lib, ptxas_table(log), warnings)
    return built


def inputs(torch, rng, B, Sq, Skv, Hq, Hkv, dtype):
    return [torch.tensor(rng.randn(B, S, H, 64).astype("float32"),
                         device="cuda").to(dtype)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


def run_build(torch, rng) -> dict:
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)

    rec = {"rows": {}, "cases": [], "failed": []}
    for key, (B, Sq, Skv, Hq, Hkv) in SHAPES.items():
        q, k, v = inputs(torch, rng, B, Sq, Skv, Hq, Hkv, torch.bfloat16)
        before = kernels.LAUNCHES["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=False)
        if kernels.LAUNCHES["flash_attention_wgmma"] != before + 1:
            rec["failed"].append(f"{key}: not on the wgmma route")
        err = float((got.float() - flash_attention_plain(
            q, k, v, causal=False).float()).abs().max())
        if not err <= 2e-2:
            rec["failed"].append(f"{key}: error {err}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = Sq * Skv
        bound = chip_smoke.bound_ms(2 * 2 * B * (Sq + Skv) * Hq * 64,
                                    4 * B * Hq * 64 * pairs,
                                    chip_smoke.BF16_OPS_PER_S)
        rec["rows"][key] = {
            "shape": [B, Sq, Skv, Hq, Hkv, 64], "max_abs_err": err,
            "kernel_ms": chip_smoke.time_ms(
                torch, lambda: flash_attention(q, k, v, causal=False), REPS),
            "sdpa_ms": chip_smoke.time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                REPS),
            "bound_ms": bound[0], "bound_by": bound[1]}
        row = rec["rows"][key]
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        del q, k, v, qt, kt, vt
    for B, Sq, Skv, Hq, Hkv, causal, window, dt, tol in CASES:
        q, k, v = inputs(torch, rng, B, Sq, Skv, Hq, Hkv, getattr(torch, dt))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        case = [B, Sq, Skv, Hq, Hkv, causal, window, dt]
        rec["cases"].append({"case": case, "max_abs_err": err,
                             "tolerance": tol})
        if not err <= tol:
            rec["failed"].append(f"{case}: error {err} > {tol}")
    torch.cuda.synchronize()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="another source with the same entry points")
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME:CONST=VALUE,... (constants of the .cu)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import _build
    from sort_probe import patched

    card = chip_smoke.card_line()
    print(card, flush=True)
    shipped = (_build.CSRC / "flash_attention_tc.cu").read_text()
    sources, values = {}, {}
    for spec in args.variant or ["shipped:"]:
        name, _, assigns = spec.partition(":")
        values[name] = {k: int(v) for k, v in (
            a.split("=") for a in assigns.split(",") if a)}
        sources[name] = patched(shipped, values[name])
    order = list(sources)
    if args.old is not None:
        sources["old"], values["old"] = args.old.read_text(), {}
        order = ["old", *order, "old"]
    built = build(sources, _build.BUILD_DIR / "flash_probe")

    results = []
    for name in order:
        lib, table, warnings = built[name]
        _build._LIBS["flash_attention_tc"] = _build.load(
            lib, "flash_attention_tc")
        rec = {"build": name, "values": values[name], "ptxas": table,
               "ptxas_warnings": warnings, "card": card}
        if name not in {r["build"] for r in results}:
            rec["sass"] = sass_counts(lib)
        try:
            rec.update(run_build(torch, np.random.RandomState(SEED)))
        except RuntimeError as exc:  # a launch or a fault: recorded
            rec["failed"] = [str(exc)[:500]]
            print(json.dumps(rec), flush=True)
            results.append(rec)
            break
        print(json.dumps(rec), flush=True)
        results.append(rec)
    _build._LIBS.pop("flash_attention_tc", None)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_probe.json").write_text(json.dumps(results, indent=1))
    return 1 if any(r["failed"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
