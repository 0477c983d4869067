"""Unified model API (port of the reference ``models/model_api.py``).

``build_model(cfg)`` returns an object exposing ``spec() / prefill_fn /
decode_fn``: ``EncDecLM`` (``models/encdec.py``) for the ``encdec``
family, whose prefill takes ``frames``, and ``DecoderLM`` for the
``dense``, ``moe``, ``ssm``, ``hybrid`` and ``vlm`` families (the VLM's
``hidden``/``prefill_fn`` take ``patches``).  The reference's
``input_specs`` (``ShapeDtypeStruct`` stand-ins for its dry-run) has no
counterpart (ROADMAP A11.6).
"""

from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import EncDecLM, encdec_cache_spec
from repro_torch.models.transformer import DecoderLM, cache_spec

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) has no model: the port "
            f"builds {', '.join(FAMILIES)}")


def build_model(cfg: ArchConfig, device="cuda") -> DecoderLM | EncDecLM:
    _check_family(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)


def model_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_cache_spec(cfg, batch, max_len)
    return cache_spec(cfg, batch, max_len)
