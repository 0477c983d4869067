"""Data layer: deterministic sharded pipelines + Hiperfact fact corpus
(``data/factsource.py``, imported on its own: it builds a fact engine)."""

from repro_torch.data.pipeline import DataConfig, ShardedLoader, SyntheticLM

__all__ = ["DataConfig", "ShardedLoader", "SyntheticLM"]
