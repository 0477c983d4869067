"""Hiperfact core on PyTorch: the paper's engine (see the reference
package's DESIGN notes, §1-2).

Unlike the reference package, importing this one changes no global
setting: torch int64 tensors are genuine 64-bit lanes without any flag.
"""

from repro_torch.core.conditions import (AddAction, Condition, DeleteAction,
                                         ExternalAction, JoinTest, Rule, Var,
                                         cond, term)
from repro_torch.core.engine import EngineConfig, HiperfactEngine, InferStats
from repro_torch.core.facts import Fact, StringDictionary, ValueType

__all__ = [
    "AddAction", "Condition", "DeleteAction", "EngineConfig", "ExternalAction",
    "Fact", "HiperfactEngine", "InferStats", "JoinTest", "Rule",
    "StringDictionary", "ValueType", "Var", "cond", "term",
]
