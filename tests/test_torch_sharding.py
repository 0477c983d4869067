"""The port's sharding rules and layout (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) vs the reference (CPU).

* ``spec_for`` of every leaf of every config's params (real widths),
  ``activation_hints(...).specs`` for every config and step kind, and
  ``batch_shardings`` equal the reference's, as tuples, over the meshes
  ``{data 16 x model 16}``, ``{pod 2 x data 16 x model 16}``, ``{2x4}``,
  ``{1x8}`` and ``{data 8}``, duck-typed as the reference's own test
  does (specs need no devices);
* the layout over ``[cpu] * 8``: ``shard`` then ``gather`` round-trips
  bit for bit, each mesh device's block is the whole divided by its
  spec's shard count, a block replicated over an axis is one tensor on
  one physical device, and ``gather`` is differentiable into the
  blocks;
* ``make_host_mesh``/``make_production_mesh`` need that many CUDA
  devices unless given a list, which may repeat a device.

Exact equality throughout (specs are tuples, the layout moves bits).
"""

import math

import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_config
from repro.distributed import sharding as RSH
from repro.models import build_model as ref_build
from repro.models.params import LeafSpec as RefLeafSpec
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor, shardings_for)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.params import is_leaf_spec, tree_leaves, tree_map


class FakeMesh:
    """Duck-typed mesh: axis_names + shape mapping (spec_for needs both)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x8": {"data": 1, "model": 8},
    "data8": {"data": 8},
}
KINDS = ("train", "prefill", "decode")


def ref_leaves(arch):
    return jax_leaves(ref_build(ref_config(arch)).spec())


def jax_leaves(tree):
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, RefLeafSpec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_for_equals_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    got = [tuple(SH.spec_for(s.shape, s.axes, fake)) for s in tree_leaves(
        build_model(get_config(arch), device="cpu").spec(), is_leaf_spec)]
    want = [tuple(RSH.spec_for(s.shape, s.axes, fake))
            for s in ref_leaves(arch)]
    assert got == want
    assert any(any(e is not None for e in s) for s in got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_activation_hints_equal_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    for kind in KINDS:
        for batch in (1, 8, 32):
            got = SH.activation_hints(get_config(arch), fake, batch, kind)
            want = RSH.activation_hints(ref_config(arch), fake, batch, kind)
            assert got.kind == want.kind == kind
            assert got.mesh is fake
            assert ({k: tuple(v) for k, v in got.specs.items()}
                    == {k: tuple(v) for k, v in want.specs.items()})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_shardings_equal_reference(mesh, monkeypatch):
    """The reference's ``batch_shardings`` with its ``NamedSharding``
    standing in for the spec it wraps (a fake mesh has no devices)."""
    fake = FakeMesh(MESHES[mesh])
    monkeypatch.setattr(RSH, "NamedSharding", lambda m, spec: spec)
    for B in (1, 2, 8, 32, 64):
        tree = {"tokens": np.zeros((B, 16), np.int32),
                "labels": np.zeros((B, 16), np.int32),
                "patches": np.zeros((B, 4, 8), np.float32)}
        want = RSH.batch_shardings(tree, fake, B)
        got = SH.batch_shardings(tree, fake, B)
        for k in tree:
            assert tuple(got[k].spec) == tuple(want[k]), (k, B)


def test_no_hints_without_a_mesh():
    h = SH.activation_hints(get_config("yi-6b"), None, 8)
    assert h.specs == {} and h.mesh is None and not h.sharded


@pytest.fixture
def mesh24():
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


SPECS = [P(), P("data"), P("model"), P(("data",), "model"),
         P("model", ("data",)), P(None, ("data", "model")),
         P(("data", "model"))]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_shard_gather_roundtrip(spec, mesh24):
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 8, 4).astype(
        np.float32))
    sh = NamedSharding(mesh24, spec)
    blocks = sh.shard(x)
    assert len(blocks) == 8
    bs = sh.block_shape(x.shape)
    assert all(tuple(b.shape) == bs for b in blocks)
    assert torch.equal(sh.gather(blocks, "cpu"), x)
    st = sh.place(x)
    assert torch.equal(st.gather("cpu"), x)
    assert torch.equal(st.piece("cpu", [(3, 13), (1, 7)]), x[3:13, 1:7])
    # a block replicated over an axis is one tensor on the one device
    assert len({id(b) for b in blocks}) == len(st) == math.prod(
        sh.grid(x.ndim))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_device_bytes_are_whole_over_shard_count(spec, mesh24):
    shape, item = (16, 8, 4), 4
    sh = NamedSharding(mesh24, spec)
    count = math.prod(sh.grid(len(shape)))
    assert sh.block_bytes(shape, item) * count == math.prod(shape) * item
    # [cpu] * 8: the one physical device holds each block once
    assert sh.device_bytes(shape, item) == {torch.device("cpu"):
                                            math.prod(shape) * item}


def test_fully_replicated_leaf_is_one_tensor(mesh24):
    x = torch.arange(12.0).reshape(3, 4)
    st = NamedSharding(mesh24, P()).place(x)
    assert len(st) == 1
    blocks = st.blocks()
    assert all(b is blocks[0] for b in blocks)


def test_gather_is_differentiable_into_the_blocks(mesh24):
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    st = NamedSharding(mesh24, P("data", "model")).place(x)
    st = st._tree_new(b.requires_grad_() for b in st)
    w = torch.arange(64.0).reshape(8, 8)
    (st.gather("cpu") * w).sum().backward()
    got = NamedSharding(mesh24, P("data", "model")).gather(
        [b.grad for b in st], "cpu")
    assert torch.equal(got, w)


def test_tree_helpers_reach_the_blocks(mesh24):
    """The port's ``tree_map``/``tree_leaves`` see a ``ShardedTensor``'s
    masters as leaves and keep its layout."""
    st = NamedSharding(mesh24, P("model")).place(torch.arange(8.0))
    tree = {"a": st, "b": torch.zeros(2)}
    assert len(tree_leaves(tree)) == 5
    doubled = tree_map(lambda x: 2 * x, tree)
    assert isinstance(doubled["a"], ShardedTensor)
    assert doubled["a"].sharding == st.sharding
    assert torch.equal(doubled["a"].gather("cpu"), 2 * torch.arange(8.0))


def test_shardings_for_and_sharded_abstract_follow_spec_for(mesh24):
    spec = build_model(get_config("yi-6b", smoke=True), device="cpu").spec()
    sh = shardings_for(spec, mesh24)
    ab = SH.sharded_abstract(spec, mesh24)
    for s, n, (meta, n2) in zip(tree_leaves(spec, is_leaf_spec),
                                tree_leaves(sh, lambda x: isinstance(
                                    x, NamedSharding)),
                                tree_leaves(ab, lambda x: isinstance(
                                    x, tuple) and len(x) == 2
                                    and isinstance(x[1], NamedSharding))):
        assert tuple(n.spec) == tuple(SH.spec_for(s.shape, s.axes, mesh24))
        assert n2 == n
        assert meta.device.type == "meta" and tuple(meta.shape) == s.shape


def test_meshes_need_cuda_devices_unless_given_a_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_host_mesh((2, 4))
    with pytest.raises(ValueError, match="CUDA devices"):
        make_production_mesh()
    m = make_host_mesh((2, 4), devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.axis_devices("model", {"data": 1}) == [torch.device("cpu")] * 4
    p = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert p.axis_names == ("pod", "data", "model")
    assert tuple(p.devices.shape) == (2, 16, 16)
    with pytest.raises(ValueError, match="got 7"):
        make_host_mesh((2, 4), devices=["cpu"] * 7)


def test_compute_grid_rows_and_columns(mesh24):
    hints = SH.activation_hints(get_config("yi-6b", smoke=True), mesh24, 8)
    assert hints.dp() == ("data",)
    assert hints.head_tp() and hints.seq_parallel()
    assert hints.grid().shape == (2, 4)
    # a batch that does not split over data runs as one row
    h1 = SH.activation_hints(get_config("yi-6b", smoke=True), mesh24, 1)
    assert h1.dp() is None and h1.grid().shape == (1, 4)
