"""The port's dry run (``repro_torch.launch.dryrun``) on meshes of fake
devices (``fake_devices``), held against the reference's compiles on the CPU.

Smoke configs (``get_config(name, smoke=True)``) at small shapes: train
B 8 x S 64, prefill B 8 x S 64, decode B 8 against a 64-slot cache,
long_500k B 1 against 128 slots.  Each figure is held exactly (integer
FLOPs and bytes):

* **against XLA's count**: the reference's ``analyze_hlo`` on its own
  single-device compile of yi-6b's smoke prefill and train step, the
  port's products on a 1x1 mesh.  Products outside attention agree bucket
  for bucket.  Attention is compared by formula on each side: the
  reference's prefill runs ``chunked_attention``'s triangular scan, which
  charges every visited kv chunk whole (``qc x kc`` pairs a step), and
  the port runs the attention kernel, charged the tiles it visits
  (``flash_attention.visited_pairs``; at this smoke shape the two
  coincide).  In the train step both sides run the chunked scan; the port
  runs 11 products a kv step (forward, the block's and the query chunk's
  recomputes, the step's recompute and its four backward products), and
  XLA's compile one product a layer fewer (which one its optimizer drops
  is not identified here);
* **argument bytes** of every family's train, prefill and decode cell at
  1x1 against the reference's ``memory_analysis().argument_size_in_bytes``.
  One named difference: ``jax.jit`` drops arguments the computation never
  reads (``keep_unused=False``), and whisper's decode step reads no
  encoder weight and no cross-attention k/v projection (the cache holds
  their outputs); the port's decode step takes the whole params tree;
* **a balanced cell** on a 2x4 mesh: the FSDP+TP train step of a dense
  smoke config with as many KV heads as the model axis (with fewer, each
  KV head's projection runs on every device of its group): the per-device
  product FLOPs sum to the 1x1 count plus the down projections the mesh
  form's remat recomputes and the 1x1 form's does not (torch's checkpoint
  stops at the last activation the backward reads, in program order), each
  device's arguments are its master blocks, and the step all-gathers and
  all-reduces;
* **every arch** x applicable shape at smoke size on the 2x4 mesh, and the
  closure cell, yield a record with exactly the reference's keys; the
  closure's ``all-to-all`` bytes are its ``ClosureConfig``'s closed form;
* **each kernel's fake path**: outputs of the launch's shapes and dtypes,
  charged by formula (attention's visited tiles by brute force over the
  mask), under the dry run's ``ShapeMode`` and under torch's own
  ``FakeTensorMode``; a CPU tensor still runs the plain version, a real
  ``meta`` tensor still raises;
* ROADMAP C4: ``adamw_update`` over blocks on distinct devices and the
  microbatched step over a batch laid out on a mesh.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import (activation_hints,
                                              batch_shardings, shardings_for)
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                     probe_sorted_plain)
from repro_torch.kernels.sortmerge.sortmerge import (bitonic_sort,
                                                     bitonic_sort_kv,
                                                     bitonic_sort_kv_plain,
                                                     bitonic_sort_plain,
                                                     merge_ranks,
                                                     merge_ranks_plain)
from repro_torch.kernels.rglru_scan.scan import (linear_scan,
                                                 linear_scan_plain)
from repro_torch.kernels.ssd.ssd import ssd_intra, ssd_intra_plain
from repro_torch.kernels.uniquefilter.uniquefilter import (
    unique_mask_sorted, unique_mask_sorted_plain)
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch.fake import ShapeMode, is_fake
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import applicable_shapes, build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.train import OptimizerConfig, build_train_step
from repro_torch.train.optimizer import adamw_update, init_opt_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPES = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
          "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
FAMILIES = ("yi-6b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "recurrentgemma-9b", "whisper-tiny", "phi-3-vision-4.2b")

# the reference's single-device compiles: argument bytes and its dot
# FLOPs by size (loop-multiplied), one subprocess for all of them (the
# reference runs in 32-bit jax; a test process may have turned x64 on)
REFERENCE = r"""
import collections, json, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import build_model
from repro.models.config import ShapeConfig
from repro.models.model_api import (model_cache_spec, prefill_input_specs,
                                    train_input_specs)
from repro.models.params import is_leaf_spec
from repro.launch.hlo_analysis import HloModule
from repro.train.optimizer import OptimizerConfig
from repro.train.train_step import build_train_step

def abstract(spec, serve=False):
    def one(s):
        dt = "bfloat16" if serve and s.dtype in ("float32", "bfloat16") \
            else s.dtype
        return jax.ShapeDtypeStruct(s.shape, jnp.dtype(dt))
    return jax.tree.map(one, spec, is_leaf=is_leaf_spec)

SH = {"train": ShapeConfig("t", 64, 8, "train"),
      "prefill": ShapeConfig("p", 64, 8, "prefill"),
      "decode": ShapeConfig("d", 64, 8, "decode")}
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    for kind, shape in SH.items():
        if kind == "train":
            P = abstract(model.spec())
            state = {"params": P, "opt": {"m": P, "v": P, "step":
                     jax.ShapeDtypeStruct((), jnp.int32)}}
            fn = jax.jit(build_train_step(model, OptimizerConfig(), 1),
                         donate_argnums=(0,))
            args = (state, train_input_specs(cfg, shape))
        elif kind == "prefill":
            def fn(params, batch):
                fk = {k: v for k, v in batch.items() if k != "tokens"}
                return model.prefill_fn(params, batch["tokens"],
                                        shape.seq_len, **fk)
            fn = jax.jit(fn)
            args = (abstract(model.spec(), True),
                    prefill_input_specs(cfg, shape))
        else:
            fn = jax.jit(model.decode_fn, donate_argnums=(2,))
            args = (abstract(model.spec(), True),
                    jax.ShapeDtypeStruct((8,), jnp.int32),
                    abstract(model_cache_spec(cfg, 8, 64)))
        c = fn.lower(*args).compile()
        dots = collections.Counter()
        if arch == "yi-6b":
            mod = HloModule(c.as_text())
            mult, _ = mod.multipliers()
            for comp, ops in mod.comps.items():
                for op in ops:
                    if op.kind == "dot":
                        dots[mod.dot_flops(op)] += mult.get(comp, 0)
        out[f"{arch}/{kind}"] = {
            "argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
            "dots": {str(int(k)): v for k, v in dots.items()}}
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE,
                          ",".join(FAMILIES)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("REF")][-1]
    return json.loads(line[3:])


def fake_mesh(shape):
    return make_host_mesh(shape, devices=D.fake_devices(math.prod(shape)))


def cell(arch, shape_name, mesh, cfg=None):
    """(record, detail) of one smoke cell (``shape_name``'s kind at
    ``SHAPES``' sizes) on ``mesh``."""
    cfg = cfg or get_config(arch, smoke=True)
    with ShapeMode():
        fn, args, meta = D.build_cell(arch, shape_name, mesh, cfg=cfg,
                                      shape=SHAPES[shape_name])
        return D.run_cell(fn, args, meta, mesh, "", f"{arch}__{shape_name}")


@pytest.fixture(scope="module")
def one_by_one():
    mesh = fake_mesh((1, 1))
    return {f"{a}/{k}": cell(a, s, mesh) for a in FAMILIES
            for k, s in KINDS.items()}


# -- against XLA's count ------------------------------------------------------

def _attn_product(cfg, B, qc, kc):
    """FLOPs of one of chunked attention's products (QK^T, PV and their
    backward products all contract ``hd`` or ``kc`` over the same pairs)."""
    return 2 * B * cfg.q_heads() * qc * kc * cfg.head_dim


def _triangular_steps(S, qc, kc):
    """kv steps of the reference's triangular scan (causal, no window)."""
    nq, nk = -(-S // qc), -(-S // kc)
    return sum(min(nk, (i * qc + qc - 1) // kc + 1) for i in range(nq))


def _brute_pairs(route, Sq, Skv, G, hd, causal, window, offset):
    """(row, key) pairs a kernel computes, by brute force over the mask:
    whole tiles with any visible pair (``wgmma``: a 64-row warpgroup's
    128-key tiles, 64 at hd 256, for each of the ``G`` heads; at hd 64
    each warpgroup with rows computes every tile its 192-row block's rows
    see; ``simt``: a block of ``64 / G`` positions x ``G`` heads against
    32-key tiles)."""
    q = np.arange(Sq)[:, None] + offset
    k = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= q >= k
    if window:
        vis &= q - k < window
    if route == "wgmma":
        rows, bn, per = 64, (64 if hd > 128 else 128), G
        block = 192 if hd == 64 else rows
    else:
        rows, bn, per = 64 // G, 32, 1
        block = rows
    total = 0
    for r0 in range(0, Sq, rows):
        b0 = r0 - r0 % block   # the tiles the warpgroup's block sees
        for t0 in range(0, Skv, bn):
            if vis[b0:b0 + block, t0:t0 + bn].any():
                total += 64 * bn * per   # 64 rows a warpgroup, a block
    return total


def test_prefill_products_match_xla(reference, one_by_one):
    cfg = get_config("yi-6b", smoke=True)
    ref = {int(k): v for k, v in reference["yi-6b/prefill"]["dots"].items()}
    row = one_by_one["yi-6b/prefill"][1]["per_device"][0]
    got = {int(k): v for k, v in row["products"].items()}
    each = _attn_product(cfg, 8, cfg.q_chunk, cfg.kv_chunk)
    steps = _triangular_steps(64, cfg.q_chunk, cfg.kv_chunk)
    # outside attention: bucket for bucket
    assert {k: v for k, v in ref.items() if k != each} == got
    # the reference's attention: QK^T and PV at every visited kv chunk
    assert ref[each] == 2 * steps * cfg.n_layers
    # the port's: the kernel, charged the tiles it visits
    route = FA._route(torch.bfloat16, cfg.head_dim, cfg.q_heads(),
                      cfg.n_kv_heads)
    pairs = _brute_pairs(route, 64, 64, cfg.q_heads() // cfg.n_kv_heads,
                         cfg.head_dim, True, 0, 0)
    want = 4 * cfg.head_dim * pairs * 8 * cfg.n_kv_heads * cfg.n_layers
    assert row["kernel_flops"] == want
    assert row["kernels"] == {"flash_attention": cfg.n_layers}
    assert sum(k * v for k, v in got.items()) + row["kernel_flops"] \
        == sum(k * v for k, v in ref.items())   # they coincide here


def test_train_products_match_xla(reference, one_by_one):
    cfg = get_config("yi-6b", smoke=True)
    ref = {int(k): v for k, v in reference["yi-6b/train"]["dots"].items()}
    row = one_by_one["yi-6b/train"][1]["per_device"][0]
    got = {int(k): v for k, v in row["products"].items()}
    each = _attn_product(cfg, 8, cfg.q_chunk, cfg.kv_chunk)
    steps = _triangular_steps(64, cfg.q_chunk, cfg.kv_chunk)
    assert {k: v for k, v in ref.items() if k != each} \
        == {k: v for k, v in got.items() if k != each}
    assert got[each] == 11 * steps * cfg.n_layers
    assert ref[each] == (11 * steps - 1) * cfg.n_layers
    assert row["kernel_flops"] == 0   # the training route takes no kernel


# -- argument bytes -------------------------------------------------------------

def _unread_by_decode(cfg) -> int:
    """Bytes of whisper's serving leaves its decode step never reads."""
    from repro_torch.models.params import param_bytes
    spec = D._serve_spec(build_model(cfg, device="cpu").spec())
    xattn = spec["dec_blocks"]["xattn"]
    return (param_bytes(spec["enc_blocks"]) + param_bytes(spec["enc_norm"])
            + param_bytes(xattn["k"]) + param_bytes(xattn["v"]))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_match_reference(reference, one_by_one, arch, kind):
    got = one_by_one[f"{arch}/{kind}"][0]["memory"]["argument_bytes"]
    want = reference[f"{arch}/{kind}"]["argument_bytes"]
    if arch == "whisper-tiny" and kind == "decode":
        got -= _unread_by_decode(get_config(arch, smoke=True))
    assert got == want


# -- a balanced cell on 2x4 ---------------------------------------------------------

def test_balanced_cell_on_2x4():
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True), n_kv_heads=4)
    one = cell("yi-6b", "train_4k", fake_mesh((1, 1)), cfg)
    mesh = fake_mesh((2, 4))
    rec, det = cell("yi-6b", "train_4k", mesh, cfg)
    rows = det["per_device"]
    assert len(rows) == 8
    total = sum(r["product_flops"] for r in rows)
    # torch's checkpoint stops its recompute at the last activation the
    # backward reads, in program order: the 1x1 form skips the MLP's down
    # projection in every layer, the mesh form only the last device's
    # (each device's down projection comes before the next device's
    # gate), so it recomputes R * M - 1 more of them a layer
    R, M = 2, 4
    down = 2 * (8 // R) * 64 * (cfg.d_ff // M) * cfg.d_model
    assert total == one[1]["per_device"][0]["product_flops"] \
        + cfg.n_layers * (R * M - 1) * down
    # each device's arguments are the master blocks it holds
    spec = build_model(cfg, device="cpu").spec()
    held = {}
    for s, sh in zip(tree_leaves(spec, is_leaf=lambda x: hasattr(x, "axes")),
                     tree_leaves(shardings_for(spec, mesh),
                                 is_leaf=lambda x: hasattr(x, "mesh"))):
        masters = {}
        for _, dev, k in sh._holders(len(s.shape)):
            masters.setdefault(k, dev)
        b = sh.block_bytes(s.shape, 4)
        for dev in masters.values():   # params, m and v: float32 each
            held[dev] = held.get(dev, 0) + 3 * b
    inputs = {"tokens": (8, 64), "labels": (8, 64)}
    for name, shape in inputs.items():   # int32 rows over data
        for r in range(2):
            held[mesh.devices[r, 0]] = held[mesh.devices[r, 0]] \
                + shape[0] // 2 * shape[1] * 4
    held[mesh.devices[0, 0]] += 4   # AdamW's step
    got = {torch.device(d): m["argument_bytes"]
           for d, m in det["memory_by_device"].items()}
    assert got == held
    kinds = set(rec["hlo"]["collectives"])
    assert {"all-gather", "all-reduce"} <= kinds


# -- every arch, and the closure --------------------------------------------------

REF_SRC = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
# the reference's record (src/repro/launch/dryrun.py: build_cell's meta and
# run_cell's rec[...] assignments)
REF_KEYS = {"arch", "shape", "kind", "params", "active_params",
            *re.findall(r'rec\["([\w ]+)"\] =', REF_SRC)}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_bytes_per_device"}
REF_HLO = {"flops_per_device", "mem_bytes_per_device", "collective_bytes",
           "collectives"}
CELLS = [(a, s) for a in ARCH_NAMES
         for s in applicable_shapes(get_config(a))]


def _check_record(rec):
    assert set(rec) == REF_KEYS
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["hlo"]) == REF_HLO
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["bottleneck"] in rec["roofline"]
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    for c in rec["hlo"]["collectives"].values():
        assert set(c) == {"count", "bytes", "time_s"}
    m = rec["memory"]
    assert m["peak_bytes_per_device"] == (m["argument_bytes"]
                                          + m["temp_bytes"]
                                          + m["output_bytes"]
                                          - m["alias_bytes"])
    json.dumps(rec)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_every_cell_yields_the_reference_record(arch, shape):
    assert set(REF_KEYS) > {"mesh", "hlo", "roofline", "bottleneck"}
    rec, det = cell(arch, shape, fake_mesh((2, 4)))
    _check_record(rec)
    assert rec["mesh"] == {"shape": [2, 4], "axes": ["data", "model"],
                           "devices": 8}
    assert det["outside"] == {}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["hlo"]["mem_bytes_per_device"] > 0
    if SHAPES[shape].kind != "decode":
        assert rec["hlo"]["flops_per_device"] > 0


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-9b",
                                  "whisper-tiny"])
def test_prefill_cache_is_laid_out_as_decode_reads_it(arch):
    """The prefill's cache comes out in ``cache_shardings``' layout (the
    decode cell's), and an attention block's k/v in ``shardings_for``'s
    (the reference's ``out_shardings`` constraint)."""
    from repro_torch.models.model_api import model_cache_spec
    cfg = get_config(arch, smoke=True)
    mesh = fake_mesh((2, 4))
    with ShapeMode():
        fn, args, meta = D.build_cell(arch, "prefill_32k", mesh, cfg=cfg,
                                      shape=SHAPES["prefill_32k"])
        _, cache = fn(*args)
    cspec = model_cache_spec(cfg, 8, 64)
    hints = activation_hints(cfg, mesh, 8, "prefill")
    want = D.cache_shardings(cfg, cspec, mesh, hints)
    ref = shardings_for(cspec, mesh)
    leaf = lambda x: hasattr(x, "spec")   # noqa: E731
    got = [x.sharding.spec for x in tree_leaves(
        cache, is_leaf=lambda x: hasattr(x, "sharding"))]
    assert got == [sh.spec for sh in tree_leaves(want, is_leaf=leaf)]
    checked = 0
    for g, r, s in zip(got, tree_leaves(ref, is_leaf=leaf),
                       tree_leaves(cspec, is_leaf=lambda x: hasattr(
                           x, "axes"))):
        if "cache_seq" in s.axes and cfg.family != "encdec":
            assert tuple(g) == tuple(r.spec)
            checked += 1
    assert checked == (2 if arch == "yi-6b" else 0)


def test_closure_cell_all_to_all_closed_form(tmp_path):
    mesh = fake_mesh((2, 4))
    rec, det = D.dry_run("hiperfact-closure", "", mesh, str(tmp_path))
    _check_record(rec)
    assert json.load(open(tmp_path / "hiperfact-closure.json")) == rec
    ccfg = det["closure"]
    n = 8
    a2a = rec["hlo"]["collectives"]["all-to-all"]
    # two exchanges a step, each device receiving one slot from every
    # source: n * slot_cap int64 lanes
    assert a2a["count"] == 2
    assert a2a["bytes"] == 2 * n * ccfg["slot_cap"] * 8
    assert a2a["time_s"] == pytest.approx(
        a2a["bytes"] * (n - 1) / n / D.LINK_BW["nvlink"], rel=1e-12)
    assert rec["hlo"]["collectives"]["all-reduce"]["count"] == 2


def test_fake_devices_are_distinct_and_spans_follow_the_mesh():
    """512 distinct fake devices (torch keeps 8 bits of a device index:
    ``meta:256`` would be ``meta:0``); a board is 8 consecutive mesh
    positions."""
    devs = D.fake_devices(512)
    assert len(set(devs)) == 512
    assert devs[127] == torch.device("meta", 127)
    assert devs[255] == torch.device("meta") and devs[256] == torch.device(
        "cpu", 0)
    span = D.link_spans(devs)
    assert span([devs[0], devs[7]]) == "nvlink"
    assert span([devs[7], devs[8]]) == "network"
    assert span([devs[248], devs[255]]) == "nvlink"
    assert span(devs[240:256]) == "network"
    with pytest.raises(ValueError):
        D.fake_devices(513)


def test_multi_pod_closure_cell():
    """The 2x16x16 mesh's 512 devices trace the closure step: each
    receives its slot of every source's send buffer."""
    mesh = D.production_mesh(True)
    rec, det = D.dry_run("hiperfact-closure", "", mesh)
    _check_record(rec)
    assert rec["mesh"]["devices"] == 512 and len(det["per_device"]) == 512
    a2a = rec["hlo"]["collectives"]["all-to-all"]
    assert a2a["bytes"] == 2 * 512 * det["closure"]["slot_cap"] * 8


# -- the kernels' fake paths ------------------------------------------------------

def _lg(n):
    return max(1, (n - 1).bit_length())


def _sort_work(n, lane):
    p = 1 << _lg(n)
    lg = _lg(p)
    return p // 2 * lg * (lg + 1) // 2, 2 * lane * p


def _ssd_work(b, nc, Q, nh, hp, N):
    tri = Q * (Q + 1) // 2
    return (b * nc * (tri * N * 2 + nh * (tri * 2 + tri * hp * 2 + Q * hp
                                          + Q * hp * N * 2)),
            4 * (b * nc * Q * nh + 2 * b * nc * Q * nh * hp
                 + 2 * b * nc * Q * N + b * nc * nh * hp * N))


def _attn_case(route, causal, window, Sq=300, Skv=300, Hq=8, Hkv=2, hd=128):
    dtype = torch.bfloat16 if route == "wgmma" else torch.float32
    G = Hq // Hkv
    pairs = _brute_pairs(route, Sq, Skv, G, hd, causal, window, Skv - Sq)
    return ((lambda q, k, v: FA.flash_attention(q, k, v, causal=causal,
                                                window=window)),
            [((1, Sq, Hq, hd), dtype), ((1, Skv, Hkv, hd), dtype),
             ((1, Skv, Hkv, hd), dtype)],
            lambda q, k, v: FA.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window),
            (4 * hd * pairs * Hkv,
             dtype.itemsize * (2 * Sq * Hq * hd + 2 * Skv * Hkv * hd)),
            ("flash_attention",) + (("flash_attention_wgmma",)
                                    if route == "wgmma" else ()))


KERNELS = {
    "bitonic_sort": (bitonic_sort, [((1000,), torch.int64)],
                     bitonic_sort_plain, _sort_work(1000, 8),
                     ("bitonic_sort",)),
    "bitonic_sort_kv": (bitonic_sort_kv, [((1000,), torch.int64),
                                          ((1000,), torch.int32)],
                        bitonic_sort_kv_plain, _sort_work(1000, 12),
                        ("bitonic_sort_kv",)),
    "merge_ranks": (merge_ranks, [((700,), torch.int64),
                                  ((3000,), torch.int64)],
                    merge_ranks_plain, (700 * _lg(3000), 12 * 700 + 8 * 3000),
                    ("merge_ranks",)),
    "probe_sorted": (probe_sorted, [((700,), torch.int64),
                                    ((3000,), torch.int64)],
                     probe_sorted_plain,
                     (2 * 700 * _lg(3000), 8 * 700 + 8 * 3000 + 8 * 700),
                     ("probe_sorted",)),
    "unique_mask_sorted": (unique_mask_sorted, [((1000,), torch.int64)],
                           unique_mask_sorted_plain, (1000, 9 * 1000),
                           ("unique_mask_sorted",)),
    "flash_attention-wgmma-causal-window": _attn_case("wgmma", True, 100),
    "flash_attention-wgmma-ragged": _attn_case("wgmma", True, 0, Sq=77,
                                               Skv=200, Hq=12, Hkv=1,
                                               hd=64),
    "flash_attention-wgmma-hd256": _attn_case("wgmma", True, 0, Hq=4,
                                              Hkv=1, hd=256),
    "flash_attention-simt": _attn_case("simt", True, 0),
    "flash_attention-simt-noncausal": _attn_case("simt", False, 0, Sq=77,
                                                 Skv=200, Hq=12, Hkv=4,
                                                 hd=64),
    "ssd_intra": (ssd_intra, [((1, 2, 16, 4), torch.float32),
                              ((1, 2, 16, 4, 8), torch.float32),
                              ((1, 2, 16, 8), torch.float32),
                              ((1, 2, 16, 8), torch.float32)],
                  ssd_intra_plain, _ssd_work(1, 2, 16, 4, 8, 8),
                  ("ssd_intra",)),
    "linear_scan": (linear_scan, [((2, 300, 40), torch.float32),
                                  ((2, 300, 40), torch.float32)],
                    linear_scan_plain,
                    (2 * 2 * 300 * 40, 4 * 3 * 2 * 300 * 40),
                    ("linear_scan",)),
    "linear_scan-h0": (linear_scan, [((2, 300, 40), torch.float32),
                                     ((2, 300, 40), torch.float32),
                                     ((2, 40), torch.float32)],
                       linear_scan_plain,
                       (2 * 2 * 300 * 40, 4 * (3 * 2 * 300 * 40 + 2 * 40)),
                       ("linear_scan",)),
}


def _real(spec, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape, dt in spec:
        if dt.is_floating_point:
            out.append(torch.randn(shape, generator=g).to(dt))
        else:
            out.append(torch.sort(torch.randint(0, 500, shape,
                                                generator=g)).values.to(dt))
    return out


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_fake_path(name):
    fn, spec, plain, (ops, nbytes), names = KERNELS[name]
    real = _real(spec)
    want = plain(*real)
    want = want if isinstance(want, tuple) else (want,)
    before = dict(kernels.LAUNCHES)
    # the dry run's fake tensors: outputs of the launch's shapes, one
    # kernel record charged by formula, no launch counted
    with ShapeMode() as mode:
        args = [torch.empty(s, dtype=d, device="meta:3") for s, d in spec]
        rec = TH.Recorder()
        with rec.feeding(mode):
            got = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(g.shape), g.dtype) for g in got] \
        == [(tuple(w.shape), w.dtype) for w in want]
    assert all(is_fake(g) and g.device == torch.device("meta", 3)
               for g in got)
    st = rec.stats[torch.device("meta", 3)]
    assert dict(st.kernels) == {n: 1 for n in names}
    assert (st.kernel_flops, st.kernel_bytes) == (ops, nbytes)
    assert kernels.LAUNCHES == before
    # torch's own fake tensors take the fake path too
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = [torch.empty(s, dtype=d) for s, d in spec]
        got = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(g.shape), g.dtype) for g in got] \
        == [(tuple(w.shape), w.dtype) for w in want]
    assert kernels.LAUNCHES == before
    # a CPU tensor still runs the plain version
    out = fn(*real)
    out = out if isinstance(out, tuple) else (out,)
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    # a real meta tensor outside a fake mode still raises
    with pytest.raises((ValueError, RuntimeError)):
        fn(*[torch.empty(s, dtype=d, device="meta") for s, d in spec])


# (Sq, Skv, G, causal, window): ragged lengths, windows, groups; then
# whisper-tiny's encoder (1500 x 1500) and cross-attention (432 -> 1500),
# non-causal over one head of a group of 1
_PAIR_SHAPES = [(300, 300, 4, True, 100), (77, 200, 1, True, 0),
                (256, 256, 8, False, 0), (1000, 1000, 2, True, 300)]
_WHISPER_SHAPES = [(1500, 1500, 1, False, 0), (432, 1500, 1, False, 0)]


@pytest.mark.parametrize("route,hd,Sq,Skv,G,causal,window", [
    (route, hd, *shape) for route, hd in (("wgmma", 128), ("wgmma", 256),
                                          ("simt", 64), ("wgmma", 64))
    for shape in _PAIR_SHAPES] + [
    ("wgmma", 64, *shape) for shape in _WHISPER_SHAPES])
def test_visited_pairs_match_brute_force(route, hd, Sq, Skv, G, causal,
                                         window):
    got = FA.visited_pairs(route, Sq, Skv, G, hd, causal, window, Skv - Sq)
    assert got == _brute_pairs(route, Sq, Skv, G, hd, causal, window,
                               Skv - Sq)


# -- ROADMAP C4 -------------------------------------------------------------------

def test_adamw_over_blocks_on_distinct_devices():
    """``adamw_update``'s clip scale, bias corrections and learning rate
    reach each block on its own device (it raised on two devices)."""
    with ShapeMode():
        params = {"a": torch.empty(4, 4, device="meta:0"),
                  "b": torch.empty(4, 4, device="meta:1")}
        grads = tree_map(torch.empty_like, params)
        p, opt, met = adamw_update(params, grads, init_opt_state(params),
                                   OptimizerConfig())
        assert p["b"].device == opt["v"]["b"].device \
            == torch.device("meta", 1)
        assert met["lr"].device == torch.device("meta", 0)


def test_accumulated_step_over_a_laid_out_batch():
    """The microbatched step over a batch laid out on a 2x4 mesh equals
    the single device's, with half the rows mostly unlabelled so that
    which rows form a microbatch shows in the loss (each microbatch is
    rows ``i * B/n ..``, its blocks assembled where they live,
    ``ShardedTensor.rows``; the step took each replica's own rows)."""
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              dtype="float32")
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    m0 = build_model(cfg, device="cpu")
    m1 = build_model(cfg, activation_hints(cfg, mesh, 8, "train"),
                     device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 48), generator=g),
             "labels": torch.randint(0, cfg.vocab, (8, 48), generator=g)}
    batch["labels"][:4, 8:] = -1
    p0 = init_params(m0.spec(), 0, device="cpu")
    p1 = tree_map(lambda x, sh: sh.place(x), p0, shardings_for(m0.spec(),
                                                               mesh))
    p0 = tree_map(torch.clone, p0)
    laid = tree_map(lambda x, sh: sh.place(x), batch,
                    batch_shardings(batch, mesh, 8))
    s0, met0 = build_train_step(m0, OptimizerConfig(), 2)(
        {"params": p0, "opt": init_opt_state(p0)}, batch)
    s1, met1 = build_train_step(m1, OptimizerConfig(), 2)(
        {"params": p1, "opt": init_opt_state(p1)}, laid)
    assert abs(float(met0["loss"]) - float(met1["loss"])) <= 1e-5
    for a, b in zip(tree_leaves(s0["params"]), tree_leaves(
            tree_map(lambda x: x.gather("cpu"), s1["params"],
                     is_leaf=lambda x: hasattr(x, "gather")))):
        assert (a - b).abs().max() <= 3e-3   # AdamW's first step ~ lr
