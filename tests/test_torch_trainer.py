"""The port's ``Trainer`` and training launcher against the reference's
(CPU).

* the reference ``Trainer`` and the port's, on the same weights (the
  reference's initial params carried over by ``params_from_reference``)
  and the same ``SyntheticLM`` stream, for 6 steps of the qwen2-7b smoke
  config: in float32 the losses agree to ``F32_TOL`` of max(1, |loss|)
  (the reference's and the port's float32 sums reassociate: 1e-6 read),
  in the config's bf16 to ``BF16_TOL`` (bf16 rounding of the activations
  in either order: 4e-4 read);
* ``Trainer(mesh=...)`` and ``--mesh`` raise naming A11.5;
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


def test_trainer_mesh_waits_for_a11_5():
    cfg = get_config("qwen2-7b", smoke=True)
    with pytest.raises(NotImplementedError, match="A11.5"):
        Trainer(cfg, lambda step: None, OptimizerConfig(), TrainerConfig(),
                mesh=object(), device="cpu")


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


def test_launcher_mesh_waits_for_a11_5(monkeypatch, capsys):
    with pytest.raises(NotImplementedError, match="A11.5"):
        run_launcher(monkeypatch, capsys, "--device", "cpu", "--smoke",
                     "--mesh", "2x4")
