"""Execution backends of the port (see ``backend/torch_ops.py``).

``get_backend(name)`` resolves an ``EngineConfig.backend`` value to a
shared ``Ops`` instance:

* ``torch``     — ``TorchOps`` on the CUDA device (the default): every
                  kernel of the path is a hand-written Hopper kernel.
                  Raises when no CUDA device exists; it never moves to the
                  CPU on its own.
* ``numpy``     — host twins (always available; the parity oracle, as in
                  the reference package).
* ``torch-cpu`` — the same ``TorchOps`` on CPU tensors, where each kernel
                  wrapper runs its plain PyTorch version (the CPU test
                  mode, the counterpart of the reference's
                  ``jax-interpret``).

Instances are cached: the device-array cache and the kernel builds they
use are per-process resources, not per-engine ones.
"""

from __future__ import annotations

from repro_torch.backend.base import Ops, splitmix64
from repro_torch.backend.device_cache import DeviceArrayCache, TransferCounter
from repro_torch.backend.handles import DeviceCol, is_handle
from repro_torch.backend.numpy_ops import NumpyOps

BACKENDS = ("numpy", "torch", "torch-cpu")

_CACHE: dict[str, Ops] = {}


def fresh_backend(name: str = "torch",
                  compress: bool | None = None) -> Ops:
    """A new, uncached ``Ops`` instance.  ``compress=True`` raises on the
    torch backends: compressed resident columns are not ported yet
    (ROADMAP A6)."""
    if name == "numpy":
        return NumpyOps()
    if name in ("torch", "torch-cpu"):
        from repro_torch.backend.torch_ops import TorchOps
        if name == "torch-cpu":
            # small blocks: the CPU mode exercises the code paths, it
            # does not win benchmarks
            return TorchOps(device="cpu", block=256, compress=compress)
        return TorchOps(device="cuda", compress=compress)
    raise ValueError(
        f"unknown backend {name!r}; expected one of {BACKENDS}")


def get_backend(name: str = "torch",
                compress: bool | None = None) -> Ops:
    key = name if compress is None else f"{name}+c{int(compress)}"
    ops = _CACHE.get(key)
    if ops is None:
        ops = _CACHE[key] = fresh_backend(name, compress=compress)
    return ops


__all__ = ["BACKENDS", "DeviceArrayCache", "DeviceCol", "NumpyOps", "Ops",
           "TransferCounter", "fresh_backend", "get_backend", "is_handle",
           "splitmix64"]
