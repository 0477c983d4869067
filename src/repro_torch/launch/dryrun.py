"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake devices.

Port of the reference ``launch/dryrun.py``.  The dry run touches no card
and allocates nothing: the mesh is ``make_production_mesh`` (16x16
single-pod, 2x16x16 multi-pod) over ``fake_devices(N)`` (256 ``meta``
devices, then 256 ``cpu`` ones: the counterpart of the reference's 512
forced host devices), and every
tensor is a ``ShapeTensor`` (``launch/fake.py``: shapes, dtypes and a
device; no data).  For each cell the driver:

  1. builds the arch's step (``build_train_step`` for train shapes,
     ``prefill_fn``/``decode_fn`` for inference shapes) over leaves laid
     out with ``NamedSharding.place`` (the reference's sharded
     ``ShapeDtypeStruct``s);
  2. runs it once under ``ShapeMode`` and a ``Recorder``
     (``launch/hlo_analysis.py``): the port's own eager code on each
     device of the mesh, every op, collective and kernel launch
     recorded by device (the counterpart of ``.lower().compile()``;
     failures here are layout bugs);
  3. writes the reference's record, key for key, to
     ``<out>/<mesh>/<arch>__<shape>.json`` (read by
     ``benchmarks/roofline.py`` and ``benchmarks/dryrun_tables.py``), and
     the per-device detail beside it in ``<out>/<mesh>/detail/``.

The record's keys, and what each means for the port:

* ``lower_s``: seconds of the traced run; ``compile_s``: seconds to
  build the cell (model, layout, inputs);
* ``memory`` (the device with the largest peak): ``argument_bytes``,
  the device's blocks of state, batch and cache; ``output_bytes``, the
  bytes of the outputs on it; ``alias_bytes``, the outputs that are
  arguments updated in place (AdamW's state, decode's cache);
  ``temp_bytes``, the peak of live storage the step created on the
  device less its new outputs; ``peak_bytes_per_device`` = argument +
  temp + output - alias, as the reference computes it;
* ``cost_analysis``: ``flops`` and ``bytes accessed`` of the trace,
  summed over the devices;
* ``hlo_bytes``: the number of ops the trace recorded;
* ``hlo``, ``roofline`` and ``bottleneck``: as in the reference, per
  device (the maximum over the mesh), from ``analyze_trace`` and the
  card's constants below.

The paper's own technique is dry-run as the ``hiperfact-closure`` cell:
one step of ``core/distributed.py``'s semi-naive closure over the mesh's
devices as shards.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi            # all
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from collections import Counter

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              activation_hints,
                                              batch_shardings,
                                              cache_leaf_spec, shardings_for)
from repro_torch.launch.fake import ShapeMode
from repro_torch.launch.hlo_analysis import Recorder, analyze_trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import SHAPES, applicable_shapes, build_model
from repro_torch.models.config import BlockKind
from repro_torch.models.model_api import (model_cache_spec,
                                          prefill_input_specs,
                                          train_input_specs)
from repro_torch.models.params import (LeafSpec, abstract_params,
                                       is_leaf_spec, tree_leaves, tree_map)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import build_train_step

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) roofline denominators, from the
# NVIDIA H100 Tensor Core GPU datasheet: dense BF16 tensor-core peak (the
# datasheet's 1,979 TFLOP/s is with sparsity), HBM3 bandwidth, NVLink 4
# at 900 GB/s a card (450 GB/s each way) within an 8-card HGX board, and
# one 400 Gb/s NIC a card (ConnectX-7) between boards.
PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = {"nvlink": 450e9, "network": 50e9}   # bytes/s, each way
BOARD = 8                    # cards a board


# torch holds a device index in 8 bits: meta:128 reads back as meta:-128,
# meta:255 as plain meta and meta:256 as meta:0, so a device type holds
# 256 distinct devices.  Only meta and cpu devices take every op a
# shape-only tensor meets without a backend (an index into an xla tensor
# asks for XLA), so mesh positions 256-511 are cpu devices.
FAKE_TYPES = ("meta", "cpu")


def fake_devices(n: int) -> list[torch.device]:
    """``n`` distinct fake devices in mesh order (``FAKE_TYPES``)."""
    if n > 256 * len(FAKE_TYPES):
        raise ValueError(f"fake_devices({n}): at most "
                         f"{256 * len(FAKE_TYPES)}")
    return [torch.device(FAKE_TYPES[k // 256], k % 256) for k in range(n)]


def link_spans(devices):
    """The link class a collective's devices cross, as a function of
    them, for a mesh over ``devices`` (in mesh order): ``nvlink`` when
    they all sit on one board of ``BOARD`` consecutive mesh positions
    (the mesh order puts ``model`` innermost, so a board holds 8
    consecutive model indices), else ``network``."""
    board = {d: k // BOARD for k, d in enumerate(devices)}

    def span(group) -> str:
        return "nvlink" if len({board.get(d, -1) for d in group}) == 1 \
            else "network"
    return span


def _serve_spec(spec_tree):
    """Serving params: float leaves stored bf16."""
    def one(s: LeafSpec):
        dt = "bfloat16" if s.dtype in ("float32", "bfloat16") else s.dtype
        return LeafSpec(s.shape, s.axes, s.init, s.scale, dt)
    return tree_map(one, spec_tree, is_leaf=is_leaf_spec)


def _place(tree, shardings):
    return tree_map(lambda x, sh: sh.place(x), tree, shardings)


def cache_shardings(cfg, cspec, mesh, hints):
    """The cache's layout as the port's prefill leaves it and its decode
    reads it (the reference's ``out_shardings`` constraint; here the mesh
    forms lay the cache out themselves, ``cache_leaf_spec``:
    ``cache_seq``, ``heads3`` and ``mlp`` over ``model`` where the model
    size divides them, the batch over the activations' data axes)."""
    return tree_map(lambda s: NamedSharding(mesh, cache_leaf_spec(
        s, mesh, hints.dp())), cspec, is_leaf=is_leaf_spec)


def build_cell(arch: str, shape_name: str, mesh, cfg=None, shape=None):
    """-> (step function, example args (``ShapeTensor`` leaves laid out
    on ``mesh``), meta).  Call it under ``ShapeMode``.  ``cfg`` and
    ``shape`` replace the arch's config and the shape's sizes (the tests'
    smoke cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    kind = shape.kind
    hints = activation_hints(cfg, mesh, shape.global_batch,
                             "train" if kind == "train" else
                             ("prefill" if kind == "prefill" else "decode"))
    model = build_model(cfg, hints)
    B = shape.global_batch
    meta = {"arch": arch, "shape": shape_name, "kind": kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}

    if kind == "train":
        spec = model.spec()
        params = _place(abstract_params(spec), shardings_for(spec, mesh))
        state = {"params": params, "opt": init_opt_state(params)}
        inputs = train_input_specs(cfg, shape)
        batch = _place(inputs, batch_shardings(inputs, mesh, B))
        accum = cfg.accum_for.get(shape_name, 1)
        step = build_train_step(model, OptimizerConfig(), accum)
        return step, (state, batch), meta
    spec = _serve_spec(model.spec())
    params = _place(abstract_params(spec), shardings_for(spec, mesh))
    if kind == "prefill":
        inputs = prefill_input_specs(cfg, shape)
        batch = _place(inputs, batch_shardings(inputs, mesh, B))

        def prefill_step(params, batch):
            toks = batch["tokens"]
            fk = {k: v for k, v in batch.items() if k != "tokens"}
            return model.prefill_fn(params, toks, shape.seq_len, **fk)
        return prefill_step, (params, batch), meta
    # decode: one new token against a cache of seq_len capacity, laid out
    # as the port's prefill leaves it; the mesh forms split the attention
    # cache over ``model`` rounding its length up to a multiple of the
    # model size
    M = mesh.shape.get("model", 1)
    cache_len = shape.seq_len
    if set(cfg.block_kinds()) & {BlockKind.ATTN, BlockKind.MOE} \
            or cfg.family == "encdec":
        cache_len = -(-cache_len // M) * M
    cspec = model_cache_spec(cfg, B, cache_len)
    cache = _place(abstract_params(cspec),
                   cache_shardings(cfg, cspec, mesh, hints))
    tok = NamedSharding(mesh, P(hints.dp())).place(
        torch.empty((B,), dtype=torch.int32, device="meta"))
    meta["cache_len"] = cache_len
    return model.decode_fn, (params, tok, cache), meta


def build_closure_cell(mesh):
    """The paper's technique at pod scale: one semi-naive closure step,
    every mesh device a shard."""
    from repro_torch.core.distributed import ClosureConfig, closure_step

    ccfg = ClosureConfig(edge_cap=1 << 16, delta_cap=1 << 14,
                         slot_cap=1 << 7, join_cap=1 << 15)
    devices = mesh.device_list()

    def buf(n, dev):
        return torch.empty((n,), dtype=torch.int64, device=dev)
    state = [{"edges": buf(ccfg.edge_cap, d), "closure": buf(ccfg.edge_cap, d),
              "delta": buf(ccfg.delta_cap, d), "fresh": buf(1, d),
              "overflow": buf(1, d)} for d in devices]

    def step(state):
        return closure_step(state, ccfg, devices)
    return step, (state,), {"arch": "hiperfact-closure",
                            "shape": "closure_64k", "kind": "infer",
                            "params": 0, "active_params": 0,
                            "closure": ccfg.__dict__}


def _stores(tree) -> dict:
    """{id: store} of the ``ShapeTensor`` leaves of ``tree``."""
    out = {}
    for x in tree_leaves(tree, is_leaf=None):
        st = getattr(x, "_store", None)
        if st is not None:
            out[id(st)] = st
    return out


def _bytes_by_device(stores: dict) -> dict:
    out: dict = {}
    for st in stores.values():
        out[st.device] = out.get(st.device, 0) + st.nbytes
    return out


def _shape_mode() -> ShapeMode:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, ShapeMode):
            return m
    raise RuntimeError("the dry run runs under ShapeMode")


def trace_cell(fn, args, devices):
    """Run ``fn(*args)`` once under a ``Recorder`` (inside the caller's
    ``ShapeMode``) -> (recorder, memory by device, seconds); ``devices``
    are the mesh's."""
    mode = _shape_mode()
    gc.collect()
    arg_stores = _stores(args)
    live0 = mode.tracker.reset_peak()
    rec = Recorder(devices=devices, span=link_spans(devices))
    t0 = time.perf_counter()
    with rec.feeding(mode):
        out = fn(*args)
    seconds = time.perf_counter() - t0
    out_stores = _stores(out)
    del out
    gc.collect()
    args_b = _bytes_by_device(arg_stores)
    outs_b = _bytes_by_device(out_stores)
    alias_b = _bytes_by_device({k: v for k, v in out_stores.items()
                                if k in arg_stores})
    memory = {}
    for dev in devices:
        extra = mode.tracker.peak.get(dev, 0) - live0.get(dev, 0)
        new_out = outs_b.get(dev, 0) - alias_b.get(dev, 0)
        a, o, al = args_b.get(dev, 0), outs_b.get(dev, 0), \
            alias_b.get(dev, 0)
        temp = max(0, extra - new_out)
        memory[dev] = {"argument_bytes": a, "output_bytes": o,
                       "temp_bytes": temp, "alias_bytes": al,
                       "peak_bytes_per_device": a + temp + o - al}
    return rec, memory, seconds


def run_cell(fn, args, meta, mesh, out_dir: str, tag: str,
             build_s: float = 0.0):
    """Trace one cell and write its record -> (record, detail)."""
    n_dev = int(np.prod(mesh.devices.shape))
    trace, memory, t_trace = trace_cell(fn, args, mesh.device_list())
    h = analyze_trace(trace, LINK_BW)
    rec = {k: v for k, v in meta.items()
           if k in ("arch", "shape", "kind", "params", "active_params")}
    rec["mesh"] = {"shape": list(mesh.devices.shape),
                   "axes": list(mesh.axis_names), "devices": n_dev}
    rec["lower_s"] = round(t_trace, 2)
    rec["compile_s"] = round(build_s, 2)
    top = max(memory, key=lambda d: memory[d]["peak_bytes_per_device"])
    rec["memory"] = dict(memory[top])
    rows = h["per_device"]
    rec["cost_analysis"] = {
        "flops": float(sum(r["flops"] for r in rows)),
        "bytes accessed": float(sum(r["mem_bytes"] for r in rows))}
    rec["hlo_bytes"] = int(sum(r["ops"] for r in rows))
    rec["hlo"] = {
        "flops_per_device": h["flops_per_device"],
        "mem_bytes_per_device": h["mem_bytes_per_device"],
        "collective_bytes": h["collective_bytes"],
        "collectives": h["collectives"],
    }
    # roofline terms (seconds)
    rec["roofline"] = {
        "compute_s": h["flops_per_device"] / PEAK_FLOPS,
        "memory_s": h["mem_bytes_per_device"] / HBM_BW,
        "collective_s": h["collective_time_s"],
    }
    terms = rec["roofline"]
    rec["bottleneck"] = max(terms, key=terms.get)

    detail = {"tag": tag, **{k: v for k, v in meta.items()
                             if k not in rec},
              "peak_device": str(top),
              "memory_by_device": {str(d): m for d, m in memory.items()},
              "per_device": rows, "outside": h["outside"],
              "backward_copies": trace.backward_copies,
              "ops_by_name": dict(sum((st.ops for st in
                                       trace.stats.values()), Counter()))}
    if out_dir:
        os.makedirs(os.path.join(out_dir, "detail"), exist_ok=True)
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        with open(os.path.join(out_dir, "detail", f"{tag}.json"), "w") as f:
            json.dump(detail, f, indent=1)
    return rec, detail


def dry_run(arch: str, shape_name: str, mesh, out_dir: str = ""):
    """Build and trace one cell (``arch`` ``hiperfact-closure`` for the
    closure cell) under a fresh ``ShapeMode`` -> (record, detail)."""
    with ShapeMode():
        t0 = time.perf_counter()
        if arch == "hiperfact-closure":
            fn, args, meta = build_closure_cell(mesh)
            tag = arch
        else:
            fn, args, meta = build_cell(arch, shape_name, mesh)
            tag = f"{arch}__{shape_name}"
        build_s = time.perf_counter() - t0
        return run_cell(fn, args, meta, mesh, out_dir, tag, build_s)


def production_mesh(multi_pod: bool):
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod,
                                devices=fake_devices(n))


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Trace every arch x shape cell on a mesh of fake "
        "devices (fake_devices(N)) and report per-device memory, FLOPs, "
        "bytes, collectives and an H100 roofline.  Touches no card and "
        "allocates nothing: every tensor is a shape.")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'hiperfact'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="out/dryrun")
    args = ap.parse_args()

    mesh = production_mesh(args.mesh == "multi")
    out_dir = os.path.join(args.out, args.mesh)

    cells: list[tuple[str, str]] = []
    arch_list = ARCH_NAMES if args.arch == "all" else (
        [] if args.arch == "hiperfact" else [args.arch])
    for a in arch_list:
        cfg = get_config(a)
        shapes = applicable_shapes(cfg) if args.shape == "all" \
            else [args.shape]
        for s in shapes:
            if s not in applicable_shapes(cfg):
                print(f"SKIP {a} x {s}: inapplicable "
                      "(full-attention arch at 500k — DESIGN.md §4)")
                continue
            cells.append((a, s))
    if args.arch in ("all", "hiperfact"):
        cells.append(("hiperfact-closure", ""))

    results = []
    for a, s in cells:
        tag = f"{a}__{s}" if s else a
        print(f"=== {tag} [{args.mesh}] ===", flush=True)
        try:
            rec, detail = dry_run(a, s, mesh, out_dir)
            print(f"  ok: build {rec['compile_s']}s  trace {rec['lower_s']}s"
                  f"  peak/dev "
                  f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB"
                  f"  bottleneck {rec['bottleneck']}"
                  + (f"  cache_len {detail['cache_len']}"
                     if "cache_len" in detail else ""), flush=True)
            results.append((tag, "ok"))
        except Exception as e:  # noqa: BLE001 — report, continue matrix
            traceback.print_exc()
            results.append((tag, f"FAIL {e}"))

    print("\n==== dry-run summary ====")
    fails = 0
    for tag, status in results:
        print(f"{status:6s} {tag}" if status == "ok" else f"{status}  {tag}")
        fails += status != "ok"
    print(f"{len(results) - fails}/{len(results)} cells passed")
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
