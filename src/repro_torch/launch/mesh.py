"""Device meshes (port of the reference ``launch/mesh.py``).

A ``Mesh`` is a named-axis array of ``torch.device``s driven by one
process: the counterpart of the reference's single-controller
``jax.make_mesh``.  The devices may repeat (``["cuda:0"] * 8`` on one
card, ``["cpu"] * 8`` in tests): the layout and every collective are the
same, and blocks that land on one physical device are held there once
(``distributed/sharding.py``).

Functions, not module-level constants: importing this module touches no
device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import device_list


class Mesh:
    """``devices``: an object array of ``torch.device`` whose dims are
    the named axes; ``shape``: {axis name: size}, in axis order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list[torch.device]:
        """The devices in mesh order (row-major over the axes)."""
        return list(self.devices.flat)

    def axis_devices(self, axis: str, coord: dict | None = None) -> list:
        """The devices along ``axis``, the other axes at ``coord``'s
        indices (0 where it names none)."""
        coord = coord or {}
        idx = tuple(slice(None) if a == axis else coord.get(a, 0)
                    for a in self.axis_names)
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def make_mesh(shape, axes, devices: Sequence | None = None,
              who: str = "make_mesh") -> Mesh:
    n = math.prod(shape)
    devs = np.empty(n, dtype=object)
    for i, d in enumerate(device_list(n, devices, who)):
        devs[i] = d
    return Mesh(devs.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> Mesh:
    """16x16 = 256 devices a pod; ``multi_pod`` adds a 2-pod axis (512).
    ``devices=None`` needs that many distinct CUDA devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices, "make_production_mesh")


def make_host_mesh(shape=(2, 4), axes=("data", "model"),
                   devices: Sequence | None = None) -> Mesh:
    """A small mesh for tests, the smoke and the launcher.  With
    ``devices=None`` it needs ``prod(shape)`` distinct CUDA devices and
    raises if there are fewer; an explicit list may repeat a device."""
    return make_mesh(shape, axes, devices, "make_host_mesh")
