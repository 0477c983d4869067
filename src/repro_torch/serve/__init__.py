"""Serving tier: snapshot-isolated concurrent fact serving."""

from repro_torch.serve.engine import FactServer, ServedResult, project_token

__all__ = ["FactServer", "ServedResult", "project_token"]
