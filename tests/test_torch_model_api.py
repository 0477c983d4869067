"""The port's meta-device stand-ins against the reference's
``ShapeDtypeStruct`` trees: ``abstract_params``, ``axes_tree``,
``input_specs`` (train, prefill and decode cells) and ``text_len``.

Every config at its full size, and each of its ``applicable_shapes``:
the trees must have the same layout (dict keys, list lengths), and each
leaf the same shape and dtype (or, for ``axes_tree``, the same logical
axes).  Every port leaf lies on the ``meta`` device, so nothing here
allocates a weight.  This file imports nothing of ``repro.core`` or
``repro.kernels`` (they turn on jax's x64 mode).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import abstract_params as ref_abstract
from repro.models import applicable_shapes as ref_applicable
from repro.models import axes_tree as ref_axes
from repro.models import build_model as ref_build
from repro.models import input_specs as ref_input_specs
from repro.models.model_api import text_len as ref_text_len
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (SHAPES, abstract_params, applicable_shapes,
                                axes_tree, build_model, input_specs)
from repro_torch.models.model_api import text_len


def walk(tree, path=""):
    """(path, leaf) in a fixed order; a tuple of axis names is a leaf."""
    if isinstance(tree, dict):
        assert all(isinstance(k, str) for k in tree)
        for k in sorted(tree):
            yield from walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def assert_same_specs(port, ref):
    p, r = list(walk(port)), list(walk(ref))
    assert [k for k, _ in p] == [k for k, _ in r]
    assert len(p) > 0
    for (path, a), (_, b) in zip(p, r):
        assert isinstance(a, torch.Tensor) and a.device.type == "meta", path
        assert isinstance(b, jax.ShapeDtypeStruct), path
        assert tuple(a.shape) == tuple(b.shape), path
        assert dtype_name(a) == dtype_name(b), path


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_and_axes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    spec = build_model(cfg, device="cpu").spec()
    rspec = ref_build(rcfg).spec()
    assert_same_specs(abstract_params(spec), ref_abstract(rspec))
    p, r = list(walk(axes_tree(spec))), list(walk(ref_axes(rspec)))
    assert p == r
    assert all(isinstance(a, tuple) for _, a in p)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shapes = applicable_shapes(cfg)
    assert shapes == ref_applicable(rcfg)
    kinds = set()
    for name in shapes:
        shape = SHAPES[name]
        kinds.add(shape.kind)
        assert_same_specs(input_specs(cfg, shape),
                          ref_input_specs(rcfg, shape))
        assert text_len(cfg, shape.seq_len) == ref_text_len(rcfg,
                                                            shape.seq_len)
    assert kinds == {"train", "prefill", "decode"}


def test_vlm_text_len_leaves_room_for_patches():
    cfg = get_config("phi-3-vision-4.2b")
    shape = SHAPES["train_4k"]
    specs = input_specs(cfg, shape)
    assert specs["tokens"].shape[1] + cfg.n_patches == shape.seq_len
    assert tuple(specs["patches"].shape) == (shape.global_batch,
                                             cfg.n_patches, cfg.d_model)
