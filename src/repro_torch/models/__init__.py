"""LM substrate of the port: configs, layers, and the dense and SSM
decoder families (the serving path; ROADMAP A11 lists what waits)."""

from repro_torch.models.config import (ArchConfig, BlockKind, SHAPES,
                                       ShapeConfig, applicable_shapes)
from repro_torch.models.model_api import build_model, model_cache_spec
from repro_torch.models.params import init_params, param_bytes, param_count

__all__ = [
    "ArchConfig", "BlockKind", "SHAPES", "ShapeConfig", "applicable_shapes",
    "build_model", "init_params", "model_cache_spec", "param_bytes",
    "param_count",
]
