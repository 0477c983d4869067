"""Weights carried over from the reference model into the port's tree
(the counterpart of ``core/convert.py`` for the LM substrate).

The reference's params arrive as plain data — the same nested dicts and
lists, each leaf a numpy array (``jax.tree.map(np.asarray, params)``) —
so this module needs nothing of the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       is_leaf_spec, tree_map)
from repro_torch.models.transformer import model_spec


def _leaf(spec: LeafSpec, arr, dev) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != spec.shape:
        raise ValueError(f"leaf shape {a.shape} != spec {spec.shape}")
    if str(a.dtype) != spec.dtype:
        raise ValueError(f"leaf dtype {a.dtype} != spec {spec.dtype}")
    return torch.tensor(a, dtype=DTYPES[spec.dtype], device=dev)


def params_from_reference(tree, cfg: ArchConfig, device="cuda"):
    """The reference's params ``tree`` (numpy leaves) as the port's params
    for ``cfg`` on ``device``.  Raises when the tree's layout, a leaf's
    shape or a leaf's dtype differs from the port's ``model_spec``."""
    dev = check_device(device)
    spec = model_spec(cfg)

    def check_keys(s, t, path="params"):
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(s) != set(t):
                raise ValueError(f"{path}: keys differ from the spec's "
                                 f"{sorted(s)}")
            for k in s:
                check_keys(s[k], t[k], f"{path}.{k}")
        elif isinstance(s, (list, tuple)):
            if not isinstance(t, (list, tuple)) or len(s) != len(t):
                raise ValueError(f"{path}: list layout differs from spec")
            for i, (a, b) in enumerate(zip(s, t)):
                check_keys(a, b, f"{path}[{i}]")

    check_keys(spec, tree)
    return tree_map(lambda s, a: _leaf(s, a, dev), spec, tree,
                    is_leaf=is_leaf_spec)
