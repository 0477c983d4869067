"""LM substrate of the port: configs, layers, and every family's model:
the dense, MoE, SSM, hybrid (RG-LRU + local attention) and VLM decoders
(``models/transformer.py``) and the enc-dec model (``models/encdec.py``),
each serving and training on one device or on a mesh (``Hints``)."""

from repro_torch.models.config import (ArchConfig, BlockKind, SHAPES,
                                       ShapeConfig, applicable_shapes)
from repro_torch.models.model_api import (build_model, input_specs,
                                          model_cache_spec)
from repro_torch.models.params import (abstract_params, axes_tree,
                                       init_params, param_bytes, param_count)

__all__ = [
    "ArchConfig", "BlockKind", "SHAPES", "ShapeConfig", "abstract_params",
    "applicable_shapes", "axes_tree", "build_model", "init_params",
    "input_specs", "model_cache_spec", "param_bytes", "param_count",
]
