"""The port stands alone: no JAX, no reference package, no silent CPU.

* importing every ``repro_torch`` module (in a fresh interpreter) loads
  no ``jax*`` module and nothing of ``repro``;
* no port source and not ``chip_smoke.py`` even names such an import;
* the ``torch`` backend, and the serving launcher that defaults to it,
  raise when torch sees no CUDA device instead of moving to the CPU, and
  so do the trainer, the fact-corpus source's own engine and the
  training launcher;
* ``chip_smoke.py`` exits non-zero, printing no ``"ok": true`` line, on
  a machine without a card and in a directory holding nothing else of
  the repository.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax_or_repro():
    res = subprocess.run([sys.executable, "-c", _CHECK], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", res.stdout


def test_walk_reaches_demand_serving_and_launcher():
    """The import check above walks the modules of the demand and
    serving slice too."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.demand", "repro_torch.serve",
            "repro_torch.serve.engine", "repro_torch.launch",
            "repro_torch.launch.serve"} <= names


def test_serve_launcher_refuses_to_run_without_cuda(monkeypatch):
    """``python -m repro_torch.launch.serve`` defaults to the card and
    raises without one; it never moves to the CPU."""
    import torch

    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--backend", "torch"]):
        monkeypatch.setattr(sys, "argv", ["serve", *argv, "--write-ops",
                                          "1", "--reads", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main()


def test_walk_reaches_the_sharded_slice():
    """The import check walks the sharded engine, its exchange and the
    Rete baseline too."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.core.sharded", "repro_torch.core.distributed",
            "repro_torch.core.rete_baseline", "repro_torch.distributed",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.sharding"} <= names


def test_sharded_engine_refuses_to_run_without_cuda(monkeypatch):
    """``shards=4`` on the default ``torch`` backend, through the engine
    and through the serving launcher, raises without a card; the
    exchange's own device list takes no CPU stand-in either."""
    import torch

    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.distributed.pipeline import FrontierExchange
    from repro_torch.distributed.sharding import fact_devices
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HiperfactEngine(EngineConfig(shards=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        HiperfactEngine(EngineConfig(backend="torch", shards=4,
                                     eval_mode="demand"))
    monkeypatch.setattr(sys, "argv", ["serve", "--shards", "4",
                                      "--write-ops", "1", "--reads", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()
    with pytest.raises(ValueError, match="CUDA devices"):
        fact_devices(4)
    # asked for the device path without a device list, the exchange
    # permutes on the host and says so in every log entry
    assert not FrontierExchange(4).device


def test_walk_reaches_the_training_infrastructure():
    """The import check walks the trainer, checkpoints, runtime monitor,
    data pipeline, fact-corpus source and training launcher too."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.train.trainer", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpoint", "repro_torch.runtime",
            "repro_torch.runtime.monitor", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.data.factsource",
            "repro_torch.launch.train"} <= names


def test_training_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """``Trainer`` (device ``cuda`` by default), ``FactCorpusSource``
    with its own engine and the training launcher raise without a card;
    none moves to the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.factsource import FactCorpusSource
    from repro_torch.launch import train
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-6b", smoke=True)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, lambda step: None, OptimizerConfig(),
                    TrainerConfig(), **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        FactCorpusSource(vocab=256, seq_len=16, global_batch=4)
    for argv in ([], ["--data", "facts"], ["--device", "cuda"]):
        monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--steps",
                                          "1", *argv])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main()


def test_walk_reaches_the_lm_sharding():
    """The import check walks the mesh builders and the collectives too,
    so the no-jax, no-``repro`` rule covers them."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.launch.mesh", "repro_torch.distributed.spmd",
            "repro_torch.distributed.sharding"} <= names


def test_meshes_refuse_to_fold_without_cuda(monkeypatch):
    """A mesh asked for without a device list needs that many CUDA
    devices: none fold onto the CPU, and a model on a mesh of CUDA
    devices raises without a card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activation_hints
    from repro_torch.launch import mesh as M
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (M.make_host_mesh, M.make_production_mesh):
        with pytest.raises(ValueError, match="CUDA devices"):
            make()
    cfg = get_config("yi-6b", smoke=True)
    mesh = M.make_host_mesh((2, 4), devices=["cuda:0"] * 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, activation_hints(cfg, mesh, 8, "train"))


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax_or_repro_import(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+repro(\.|\s|$)", src, re.M)


def test_torch_backend_refuses_to_run_without_cuda(monkeypatch):
    import torch

    from repro_torch.backend import fresh_backend
    from repro_torch.core import EngineConfig, HiperfactEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fresh_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        HiperfactEngine(EngineConfig(backend="torch"))


def test_cuda_wrappers_never_take_the_plain_path():
    """A CUDA tensor must reach the kernel or raise: no wrapper catches
    an error and falls back to its plain version."""
    for name in ("sortmerge/sortmerge.py", "mergejoin/mergejoin.py",
                 "uniquefilter/uniquefilter.py"):
        src = (PKG / "kernels" / name).read_text()
        assert "try:" not in src and "except" not in src


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
