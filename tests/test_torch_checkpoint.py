"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's.

* the reference's round-trip, async-and-GC and uncommitted-dir tests,
  run against the port over trees of torch tensors;
* a checkpoint written by the reference restores in the port, and the
  port's in the reference, leaf for leaf (the same ``step_%09d/``
  layout, ``shard_00000.npz`` keys spelled as ``jax.tree_util.keystr``
  spells them, ``manifest.json``, ``COMMITTED``), also for a smoke
  model's whole train state;
* ``save_async`` followed by an in-place change of every leaf (what
  ``adamw_update`` does in the next step) still restores the values from
  before the change;
* ``restore(..., shardings=...)`` lays each leaf out on a mesh, and the
  reference's elastic test runs against the port: a tree saved under a
  ``data 8`` layout over ``[cpu] * 8`` restores under a ``2x4`` mesh with
  new shardings, every value equal and every block on its device; a
  sharded leaf is saved whole, as the reference's global arrays are.

This file imports nothing of ``repro.core`` or ``repro.kernels`` (they
turn on jax's x64 mode).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import tree_leaves


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,))},
            "opt": {"m": [torch.zeros((2,)), torch.ones((2,))],
                    "step": torch.tensor(7, dtype=torch.int32)}}


def ref_tree():
    # dtypes spelled out: a test file run earlier in this process may have
    # turned on jax's x64 mode (``repro.core``), where 12.0 is float64
    f32 = jnp.float32
    return {"params": {"w": jnp.arange(12.0, dtype=f32).reshape(3, 4),
                       "b": jnp.ones((4,), f32)},
            "opt": {"m": [jnp.zeros((2,), f32), jnp.ones((2,), f32)],
                    "step": jnp.asarray(7, jnp.int32)}}


def assert_same(port_tree, ref_tree_):
    a = tree_leaves(port_tree)
    b = jax.tree.leaves(ref_tree_)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = tree()
    cm.save(5, t)
    assert cm.list_steps() == [5]
    got = cm.restore(5, t)
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert b.device == a.device and b.shape == a.shape
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert got["opt"]["step"].dtype == torch.int32
    assert got["opt"]["step"].dim() == 0 and int(got["opt"]["step"]) == 7


def test_async_save_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        cm.save_async(s, t)
    cm.wait()
    assert cm.list_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_uncommitted_dirs_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree())
    # simulate a crash mid-save: committed marker missing
    crash = os.path.join(str(tmp_path), "step_000000002")
    shutil.copytree(os.path.join(str(tmp_path), "step_000000001"), crash)
    os.remove(os.path.join(crash, "COMMITTED"))
    assert cm.list_steps() == [1]
    assert cm.latest_step() == 1


def test_layout_keys_and_manifest_equal_reference(tmp_path):
    """Both packages write the same files, keys, manifest and arrays."""
    RefCheckpointManager(str(tmp_path / "ref")).save(3, ref_tree())
    CheckpointManager(str(tmp_path / "port")).save(3, tree())
    for side in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / side / "step_000000003")) == \
            ["COMMITTED", "manifest.json", "shard_00000.npz"]
    load = {side: np.load(tmp_path / side / "step_000000003" /
                          "shard_00000.npz") for side in ("ref", "port")}
    assert sorted(load["port"].files) == sorted(load["ref"].files) == [
        "['opt']['m'][0]", "['opt']['m'][1]", "['opt']['step']",
        "['params']['b']", "['params']['w']"]
    for k in load["ref"].files:
        assert load["port"][k].dtype == load["ref"][k].dtype
        np.testing.assert_array_equal(load["port"][k], load["ref"][k])
    manifests = [json.loads((tmp_path / side / "step_000000003" /
                             "manifest.json").read_text())
                 for side in ("ref", "port")]
    assert manifests[0] == manifests[1]


def test_reference_checkpoint_restores_in_port(tmp_path):
    RefCheckpointManager(str(tmp_path)).save(4, ref_tree())
    got = CheckpointManager(str(tmp_path)).restore(4, tree())
    assert_same(got, ref_tree())


def test_port_checkpoint_restores_in_reference(tmp_path):
    t = tree()
    t["params"]["w"].mul_(-1.5)
    CheckpointManager(str(tmp_path)).save(4, t)
    got = RefCheckpointManager(str(tmp_path)).restore(4, ref_tree())
    assert_same(t, got)


def _port_state():
    """A smoke model's whole train state, after one AdamW step so that
    the moments and ``step`` are not their initial values."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model, init_params
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)
    cfg = get_config("mamba2-1.3b", smoke=True)
    model = build_model(cfg, device="cpu")
    state = init_train_state(init_params(model.spec(), 3, device="cpu"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2, seed=3)).batch(0)
    step = build_train_step(model, OptimizerConfig(lr=1e-3))
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in data.items()})
    return state


def test_train_state_crosses_both_ways(tmp_path):
    state = _port_state()
    CheckpointManager(str(tmp_path / "port")).save(1, state)
    skeleton = jax.tree.map(lambda x: jnp.zeros(x.shape, x.numpy().dtype),
                            state)
    got = RefCheckpointManager(str(tmp_path / "port")).restore(1, skeleton)
    assert_same(state, got)
    ref_state = jax.tree.map(lambda x: jnp.asarray(x.numpy() * 2), state)
    RefCheckpointManager(str(tmp_path / "ref")).save(2, ref_state)
    back = CheckpointManager(str(tmp_path / "ref")).restore(2, state)
    assert_same(back, ref_state)


def test_save_async_snapshot_survives_in_place_update(tmp_path):
    """``save_async`` returns with a host copy of every leaf: changing
    every leaf in place right after (as the next AdamW step does) leaves
    the checkpoint with the values from before the change."""
    cm = CheckpointManager(str(tmp_path))
    t = tree()
    before = [x.clone() for x in tree_leaves(t)]
    cm.save_async(6, t)
    for x in tree_leaves(t):
        x.add_(100)
    cm.wait()
    got = cm.restore(6, t)
    for a, b in zip(before, tree_leaves(got)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_restore_checks_shapes_and_casts_to_skeleton(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree())
    skel = tree()
    skel["params"]["w"] = torch.zeros((3, 4), dtype=torch.float64)
    got = cm.restore(1, skel)
    assert got["params"]["w"].dtype == torch.float64
    torch.testing.assert_close(got["params"]["w"],
                               torch.arange(12.0).reshape(3, 4).double())
    skel["params"]["b"] = torch.zeros((5,))
    with pytest.raises(ValueError, match=r"\['params'\]\['b'\]"):
        cm.restore(1, skel)


def test_restore_shardings_waits_for_a11_5(tmp_path):
    """``shardings=`` (once a stub naming A11.5) lays the restored leaves
    out: a ``NamedSharding`` leaf gives a ``ShardedTensor`` of the saved
    values, the others keep the skeleton's device and dtype."""
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  ShardedTensor)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree())
    sh = {"params": {"w": NamedSharding(mesh, P(None, "model")), "b": None},
          "opt": {"m": [None, None], "step": None}}
    got = cm.restore(1, tree(), shardings=sh)
    w = got["params"]["w"]
    assert isinstance(w, ShardedTensor) and w.sharding == sh["params"]["w"]
    assert len(w) == 4 and all(tuple(b.shape) == (3, 1) for b in w)
    torch.testing.assert_close(w.gather("cpu"), tree()["params"]["w"])
    for a, b in zip(tree_leaves(got, lambda x: isinstance(x, ShardedTensor)
                                ), tree_leaves(tree())):
        if not isinstance(a, ShardedTensor):
            assert torch.equal(a, b) and a.dtype == b.dtype


def test_elastic_restore_resharding(tmp_path):
    """The reference's elastic test: saved under ``data 8``, restored under
    a ``2x4`` mesh with another layout."""
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  ShardedTensor)
    from repro_torch.launch.mesh import make_host_mesh
    t = {"w": torch.arange(64.0).reshape(8, 8)}
    mesh1 = make_host_mesh((8,), ("data",), devices=["cpu"] * 8)
    t1 = {"w": NamedSharding(mesh1, P("data")).place(t["w"])}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, t1)
    with np.load(tmp_path / "step_000000001" / "shard_00000.npz") as data:
        np.testing.assert_array_equal(data["['w']"], t["w"].numpy())
    mesh2 = make_host_mesh((2, 4), devices=["cpu"] * 8)
    sh = {"w": NamedSharding(mesh2, P("model", "data"))}
    got = cm.restore(1, t, shardings=sh)
    assert isinstance(got["w"], ShardedTensor)
    assert got["w"].sharding == sh["w"]
    np.testing.assert_array_equal(got["w"].gather("cpu").numpy(),
                                  t["w"].numpy())
    for coord, block in zip(np.ndindex(2, 4), got["w"].blocks()):
        assert block.device == mesh2.devices[coord]
        i, j = coord
        np.testing.assert_array_equal(block.numpy(),
                                      t["w"][2 * j:2 * j + 2,
                                             4 * i:4 * i + 4].numpy())
    # restoring onto the sharded skeleton keeps its layout
    again = cm.restore(1, t1)
    assert again["w"].sharding == t1["w"].sharding
    np.testing.assert_array_equal(again["w"].gather("cpu").numpy(),
                                  t["w"].numpy())


def test_async_write_error_raises_in_wait(tmp_path, monkeypatch):
    """A failed background write is not lost: ``wait`` raises it."""
    cm = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    cm.save_async(1, tree())
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.list_steps() == []
    cm.wait()   # raised once
