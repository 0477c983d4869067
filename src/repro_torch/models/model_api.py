"""Unified model API (port of the reference ``models/model_api.py``).

``build_model(cfg)`` returns an object exposing ``spec() / hidden /
prefill_fn / decode_fn`` for the ``dense``, ``moe``, ``ssm`` and
``hybrid`` families; ``encdec`` and ``vlm`` raise
``NotImplementedError`` (ROADMAP A11.3).  The reference's
``input_specs`` (``ShapeDtypeStruct`` stand-ins for its dry-run) has no
counterpart.
"""

from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import DecoderLM, cache_spec

FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the ROADMAP item each family still waits for
WAITS_FOR = {"encdec": "A11.3", "vlm": "A11.3"}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP {WAITS_FOR.get(cfg.family, 'A11')}): the port builds "
            f"{', '.join(FAMILIES)}")


def build_model(cfg: ArchConfig, device="cuda") -> DecoderLM:
    _check_family(cfg)
    return DecoderLM(cfg, device)


def model_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    _check_family(cfg)
    return cache_spec(cfg, batch, max_len)
