"""The port's ``Trainer`` and training launcher against the reference's
(CPU).

* the reference ``Trainer`` and the port's, on the same weights (the
  reference's initial params carried over by ``params_from_reference``)
  and the same ``SyntheticLM`` stream, for 6 steps of the qwen2-7b smoke
  config: in float32 the losses agree to ``F32_TOL`` of max(1, |loss|)
  (the reference's and the port's float32 sums reassociate: 1e-6 read),
  in the config's bf16 to ``BF16_TOL`` (bf16 rounding of the activations
  in either order: 4e-4 read);
* ``Trainer(mesh=...)`` over a 2x4 mesh of ``[cpu] * 8`` (yi-6b smoke,
  3 steps) against the single-device ``Trainer`` on the same seed and
  stream: losses within 2e-3 (the bf16 activations summed in another
  order); a crash and resume on the mesh repeats the uninterrupted
  losses exactly; ``--mesh 2x4 --devices cpu`` trains and resumes, and
  ``--mesh`` without ``--devices`` raises naming the flag;
* the launcher's ``main()`` on ``--device cpu --smoke --steps 4`` for both
  ``--data`` values, and a second run on its checkpoint directory that
  resumes.  ``--data facts`` builds its engine on ``torch-cpu``, whose
  plain sort network takes minutes at the default KG on the CPU, so the
  test builds a smaller KG.

This file imports nothing of ``repro.core`` or ``repro.kernels``, as
``test_torch_train.py``'s header explains.
"""

import dataclasses
import functools
import logging
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
from repro_torch.models.convert import params_from_reference
from repro_torch.train import (OptimizerConfig, Trainer, TrainerConfig,
                               init_train_state)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = 1e-5
BF16_TOL = 2e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       (None, BF16_TOL)],
                         ids=["float32", "bf16"])
def test_trainer_matches_reference(dtype, tol):
    cfg = get_config("qwen2-7b", smoke=True)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    data = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    ref = RefTrainer(cfg, RefSyntheticLM(RefDataConfig(**data)).batch,
                     RefOptimizerConfig(**OPT),
                     RefTrainerConfig(steps=6, log_every=100),
                     global_batch=4)
    state = ref.init_state()
    params = params_from_reference(jax.tree.map(np.asarray,
                                                state["params"]), cfg, "cpu")
    _, want = ref.run(state)   # donates state
    port = Trainer(cfg, ShardedLoader(SyntheticLM(DataConfig(**data))),
                   OptimizerConfig(**OPT),
                   TrainerConfig(steps=6, log_every=100), global_batch=4,
                   device="cpu")
    _, got = port.run(init_train_state(params))
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (i, a, b)
    assert got[-1] < got[0]


MESH_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def mesh_trainer(steps, mesh=None, ckpt_dir=None, loader=None):
    cfg = get_config("yi-6b", smoke=True)
    loader = loader or ShardedLoader(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=8)))
    return Trainer(cfg, loader, OptimizerConfig(**MESH_OPT),
                   TrainerConfig(steps=steps, log_every=100, ckpt_every=2,
                                 ckpt_dir=ckpt_dir),
                   mesh=mesh, global_batch=8, device="cpu")


def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


def test_trainer_mesh_waits_for_a11_5():
    """``Trainer(mesh=...)`` (once a stub naming A11.5) trains on the
    mesh: its params and AdamW moments are laid out by
    ``shardings_for``, and its losses follow the single-device
    trainer's."""
    from repro_torch.distributed.sharding import ShardedTensor
    _, want = mesh_trainer(3).run()
    t = mesh_trainer(3, host_mesh())
    state, got = t.run()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= 2e-3, (got, want)
    assert got[-1] < got[0]
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        assert isinstance(tree["blocks"]["b0"]["mlp"]["up"]["w"],
                          ShardedTensor)


def test_trainer_mesh_crash_and_resume(tmp_path):
    """On the mesh: a run that crashes at step 5 with step 4 committed,
    then a fresh trainer on the same directory, repeat the uninterrupted
    run's losses."""
    _, want = mesh_trainer(6, host_mesh()).run()
    cfg = get_config("yi-6b", smoke=True)
    src = ShardedLoader(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                               global_batch=8)))

    def crashing(step):
        if step == 5:
            raise RuntimeError("worker lost")
        return src(step)
    t = mesh_trainer(6, host_mesh(), str(tmp_path), crashing)
    with pytest.raises(RuntimeError, match="worker lost"):
        t.run()
    assert t.losses == want[:5]
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    _, resumed = mesh_trainer(6, host_mesh(), str(tmp_path)).run()
    assert resumed == want[4:]


def run_launcher(monkeypatch, capsys, *argv):
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    train.main()
    return capsys.readouterr().out


@pytest.fixture
def small_kg(monkeypatch):
    """The launcher's fact engine over a 40-entity KG (``torch-cpu``)."""
    from repro_torch.data import factsource
    monkeypatch.setattr(factsource, "corpus_engine", functools.partial(
        factsource.corpus_engine, n_entities=40, n_edges=120))


@pytest.mark.parametrize("data", ["synthetic", "facts"])
def test_launcher_trains_and_resumes_on_cpu(data, tmp_path, monkeypatch,
                                            capsys, caplog, small_kg):
    args = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4",
            "--data", data, "--ckpt-dir", str(tmp_path)]
    out = run_launcher(monkeypatch, capsys, *args, "--steps", "4")
    line = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    assert len(line) == 1, out
    final, start = (float(x) for x in line[0].replace(")", "").split()[2::2])
    assert np.isfinite([final, start]).all() and final < start
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        out = run_launcher(monkeypatch, capsys, *args, "--steps", "6")
    assert "restoring checkpoint step 4" in caplog.text
    assert "final loss" in out
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp_path)).list_steps() == [4, 6]


def test_launcher_mesh_waits_for_a11_5(monkeypatch, capsys, caplog,
                                       tmp_path):
    """``--mesh 2x4`` (once a stub naming A11.5) trains over ``--devices
    cpu`` (one entry, repeated), checkpoints and resumes."""
    args = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "8",
            "--mesh", "2x4", "--devices", "cpu", "--ckpt-dir",
            str(tmp_path)]
    out = run_launcher(monkeypatch, capsys, *args, "--steps", "3")
    line = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    final, start = (float(x) for x in line[0].replace(")", "").split()[2::2])
    assert np.isfinite([final, start]).all() and final < start
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        out = run_launcher(monkeypatch, capsys, *args, "--steps", "4")
    assert "restoring checkpoint step 3" in caplog.text
    assert "final loss" in out


def test_launcher_mesh_needs_devices(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="--devices"):
        run_launcher(monkeypatch, capsys, "--device", "cpu", "--smoke",
                     "--mesh", "2x4")
    with pytest.raises(ValueError, match="got 3 devices"):
        run_launcher(monkeypatch, capsys, "--device", "cpu", "--smoke",
                     "--mesh", "2x4", "--devices", "cpu,cpu,cpu")
