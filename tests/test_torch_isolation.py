"""The port stands alone: no JAX, no reference package, no silent CPU.

* importing every ``repro_torch`` module (in a fresh interpreter) loads
  no ``jax*`` module and nothing of ``repro``;
* no port source and not ``chip_smoke.py`` even names such an import;
* the ``torch`` backend raises when torch sees no CUDA device instead of
  moving to the CPU;
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
