"""Config registry: the 10 architectures of the LM substrate.

``get_config(name)`` returns the full config; ``get_config(name,
smoke=True)`` returns the reduced same-family variant the CPU tests use
(small layers/width, few experts, tiny vocab).  Plain data, copied from
the reference ``configs/`` with the same names; the port builds a model
for every family (``models.build_model``).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2-7b": "qwen2_7b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-6b": "yi_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-1.3b": "mamba2_1_3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke() if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ArchConfig]:
    return {n: get_config(n, smoke) for n in ARCH_NAMES}
