"""The port's structural analyser (``repro_torch.launch.hlo_analysis``)
held against the reference's (``repro.launch.hlo_analysis``) on the CPU.

The reference parses HLO text; the port records the aten ops its eager
code dispatches (on ``launch.fake.ShapeTensor``s on ``meta:k`` devices,
or on real CPU tensors).  Each figure is held to the reference's on the
counterpart program, exactly (integer FLOPs and bytes; float seconds to
1e-12 relative):

* ``shape_bytes`` for every torch dtype: the reference's ``shape_bytes``
  on the HLO type where one exists (``HLO_TYPES``), else the itemsize;
* the reference's synthetic module (``test_hlo_analysis.SYNTH``: an 8x8
  product and an ``all-gather`` over a group of 4, in a loop of 5) against
  the same program in the port: a Python loop of 5 products and
  ``spmd.all_gather``s over 4 fake devices;
* the ring model: one collective of each kind over 4 devices, the port's
  ``time_s`` against the reference's on a one-op module;
* the traffic model: one op of each class against the reference's
  ``_op_traffic`` on its HLO counterpart.
"""

import math

import pytest
import torch

from repro.launch import hlo_analysis as RH
from repro_torch.distributed import spmd
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch.fake import ShapeMode
from test_hlo_analysis import SYNTH

DTYPES = sorted({v for v in vars(torch).values()
                 if isinstance(v, torch.dtype)}, key=str)
DEVS = [torch.device("meta", i) for i in range(4)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_shape_bytes(dtype):
    for shape in ((4, 8), (2, 3), (7,), ()):
        got = TH.shape_bytes(dtype, shape)
        hlo = TH.HLO_TYPES.get(dtype)
        if hlo is None:
            want = math.prod(shape) * dtype.itemsize
        else:
            want = RH.shape_bytes(f"{hlo}[{','.join(map(str, shape))}]")
        assert got == want, (dtype, shape)


def _synthetic(stacked: bool):
    """5 x (an 8x8 product on meta:0, an all-gather over 4 devices)."""
    with ShapeMode() as mode:
        x = torch.empty(8, 8, device=DEVS[0])
        rec = TH.Recorder(keep=True)
        ctx = rec if stacked else rec.feeding(mode)
        with ctx:
            for _ in range(5):
                x = x @ x
                parts = [torch.empty(2, 8, device=d) for d in DEVS]
                x = spmd.all_gather(parts, 0, DEVS)[0]
    return TH.analyze_trace(rec), rec


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["fed_by_shape_mode", "stacked_mode"])
def test_synthetic_program_matches_reference(stacked):
    ref = RH.HloModule(SYNTH).analyze()
    got, rec = _synthetic(stacked)
    # each op kept with its device, result and operand shapes and dtypes:
    # the products on meta:0, the all-gathers' inputs on each device
    mms = [op for op in rec.ops if op[0] == "mm"]
    assert len(mms) == 5 and all(
        op[1] == DEVS[0] and op[2] == [((8, 8), torch.float32)]
        and op[3] == [((8, 8), torch.float32)] * 2 for op in mms)
    assert sum(op[0] == "empty" for op in rec.ops) == 5 * 4
    assert got["flops_per_device"] == ref["flops_per_device"] == 5 * 1024
    for key in ("count", "bytes"):
        assert got["collectives"]["all-gather"][key] \
            == ref["collectives"]["all-gather"][key]
    assert ref["collectives"]["all-gather"]["count"] == 5
    assert got["collectives"]["all-gather"]["bytes"] == 5 * 256
    # each device of the group received the same
    per = [r["collectives"]["all-gather"]["bytes"]
           for r in got["per_device"]]
    assert per == [5 * 256] * 4


_ONE_OP = """
HloModule one

ENTRY %main (a: f32[{ishape}]) -> f32[8,8] {{
  %a = f32[{ishape}]{{1,0}} parameter(0)
  ROOT %c = f32[8,8]{{1,0}} {op}(f32[{ishape}]{{1,0}} %a), {attrs}
}}
"""

RING = {
    "all-reduce": ("8,8", "replica_groups={{0,1,2,3}}, to_apply=%sum",
                   lambda xs: spmd.psum(xs, DEVS)),
    "all-gather": ("2,8", "replica_groups={{0,1,2,3}}, dimensions={0}",
                   lambda xs: spmd.all_gather([x[:2] for x in xs], 0, DEVS)),
    "all-to-all": ("8,8", "replica_groups={{0,1,2,3}}, dimensions={0}",
                   lambda xs: spmd.all_to_all(xs, 0, 0, DEVS)),
    "collective-permute": (
        "8,8", "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}",
        lambda xs: spmd.ppermute(xs, [(0, 1), (1, 2), (2, 3), (3, 0)],
                                 DEVS)),
}


@pytest.mark.parametrize("kind", list(RING))
def test_ring_model_matches_reference(kind):
    ishape, attrs, run = RING[kind]
    ref = RH.analyze_hlo(_ONE_OP.format(ishape=ishape, op=kind,
                                        attrs=attrs), 50e9)
    with ShapeMode() as mode:
        xs = [torch.empty(8, 8, device=d) for d in DEVS]
        rec = TH.Recorder()
        with rec.feeding(mode):
            out = run(xs)
    assert [tuple(o.shape) for o in out] == [(8, 8)] * 4
    got = TH.analyze_trace(rec, 50e9)
    want = ref["collectives"][kind]
    assert got["collectives"][kind]["count"] == want["count"] == 1
    assert got["collectives"][kind]["bytes"] == want["bytes"] == 256
    assert got["collectives"][kind]["time_s"] == pytest.approx(
        want["time_s"], rel=1e-12)
    # a collective's own copies and sums are not counted as ops (the
    # all-gather's inputs are four slices, taken before it)
    assert sum(r["ops"] for r in got["per_device"]) == \
        (4 if kind == "all-gather" else 0)
    assert got["flops_per_device"] == 0


def _ref_traffic(params: dict, line: str) -> float:
    """The reference's ``_op_traffic`` of ``line`` over ``params``."""
    head = ", ".join(f"{k}: {v}" for k, v in params.items())
    body = "".join(f"  %{k} = {v} parameter({i})\n"
                   for i, (k, v) in enumerate(params.items()))
    mod = RH.HloModule(f"HloModule t\n\nENTRY %main ({head}) -> f32[] {{\n"
                       f"{body}  ROOT %r = {line}\n}}\n")
    (op,) = [o for o in mod.comps["main"] if o.name == "r"]
    return mod._op_traffic(op)


X = torch.ones(8, 8)
TRAFFIC = {
    # views are free, as HLO's bitcast is
    "view": ({"a": "f32[8,8]"}, "f32[64]{0} bitcast(f32[8,8]{1,0} %a)",
             lambda: (X,), lambda x: x.view(64)),
    # gathers and copying slices: 2x their result
    "gather": ({"a": "f32[8,8]", "i": "s32[4]"},
               "f32[4,8]{1,0} gather(f32[8,8]{1,0} %a, s32[4]{0} %i), "
               "offset_dims={1}, collapsed_slice_dims={0}, "
               "start_index_map={0}, index_vector_dim=1, "
               "slice_sizes={1,8}",
               lambda: (X, torch.arange(4)),
               lambda x, i: torch.index_select(x, 0, i)),
    # in-place updates: 2x the update
    "update": ({"a": "f32[8,8]", "u": "f32[2,8]", "i": "s32[]",
                "j": "s32[]"},
               "f32[8,8]{1,0} dynamic-update-slice(f32[8,8]{1,0} %a, "
               "f32[2,8]{1,0} %u, s32[] %i, s32[] %j)",
               lambda: (X.clone(), torch.ones(2, 8)),
               lambda x, u: x[2:4].copy_(u)),
    # copies: 2x their result
    "copy": ({"a": "f32[8,8]"}, "f32[8,8]{1,0} copy(f32[8,8]{1,0} %a)",
             lambda: (X,), lambda x: x.clone()),
    # a sort: its network's passes
    "sort": ({"a": "f32[1024]", "i": "s64[1024]"},
             "(f32[1024]{0}, s64[1024]{0}) sort(f32[1024]{0} %a, "
             "s64[1024]{0} %i), dimensions={0}, to_apply=%lt",
             lambda: (torch.ones(1024),), lambda x: torch.sort(x)),
    # everything else: operands + result
    "elementwise": ({"a": "f32[8,8]", "b": "f32[8,8]"},
                    "f32[8,8]{1,0} add(f32[8,8]{1,0} %a, f32[8,8]{1,0} %b)",
                    lambda: (X, X), lambda x, y: x + y),
}


@pytest.mark.parametrize("case", list(TRAFFIC))
def test_traffic_model_matches_reference(case):
    params, line, inputs, fn = TRAFFIC[case]
    want = _ref_traffic(params, line)
    args = inputs()
    rec = TH.Recorder()
    with rec:
        fn(*args)
    got = sum(st.mem_bytes for st in rec.stats.values())
    assert got == want, (case, got, want)
