"""Unified model API (port of the reference ``models/model_api.py``).

``build_model(cfg, hints)`` returns an object exposing ``spec() / prefill_fn /
decode_fn``: ``EncDecLM`` (``models/encdec.py``) for the ``encdec``
family, whose prefill takes ``frames``, and ``DecoderLM`` for the
``dense``, ``moe``, ``ssm``, ``hybrid`` and ``vlm`` families (the VLM's
``hidden``/``prefill_fn`` take ``patches``).  ``input_specs(cfg,
shape)`` gives the inputs of a (config, shape) cell as ``meta`` tensors,
the stand-ins of the reference's ``ShapeDtypeStruct`` trees: the same
shapes and dtypes, no allocation.  Modality frontends are stubs: VLM
cells get precomputed patch embeddings, audio cells precomputed frames.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.encdec import EncDecLM, encdec_cache_spec
from repro_torch.models.layers import NO_HINTS, Hints
from repro_torch.models.params import DTYPES, abstract_params
from repro_torch.models.transformer import DecoderLM, cache_spec

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) has no model: the port "
            f"builds {', '.join(FAMILIES)}")


def build_model(cfg: ArchConfig, hints: Hints = NO_HINTS,
                device="cuda") -> DecoderLM | EncDecLM:
    """The config's model; ``hints`` (``activation_hints`` over a mesh)
    make it run its mesh forms, as the reference's ``build_model(cfg,
    hints)``."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg, hints, device)
    return DecoderLM(cfg, hints, device)


def model_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_cache_spec(cfg, batch, max_len)
    return cache_spec(cfg, batch, max_len)


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=DTYPES[dtype], device="meta")


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """VLM cells: patches occupy the front of the assigned sequence length."""
    if cfg.family == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def _frontend_specs(cfg: ArchConfig, B: int) -> dict:
    if cfg.family == "vlm":
        return {"patches": _meta((B, cfg.n_patches, cfg.d_model),
                                 "float32")}
    if cfg.family == "encdec":
        return {"frames": _meta((B, cfg.enc_seq, cfg.d_model), "float32")}
    return {}


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, St = shape.global_batch, text_len(cfg, shape.seq_len)
    return {"tokens": _meta((B, St), "int32"),
            "labels": _meta((B, St), "int32"), **_frontend_specs(cfg, B)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, St = shape.global_batch, text_len(cfg, shape.seq_len)
    return {"tokens": _meta((B, St), "int32"), **_frontend_specs(cfg, B)}


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """decode shapes lower ``serve_step``: one new token + a cache of
    seq_len capacity (per the assignment)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tok": _meta((B,), "int32"),
            "cache": abstract_params(model_cache_spec(cfg, B, S))}


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
