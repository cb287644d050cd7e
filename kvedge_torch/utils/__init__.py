"""Shared utilities."""

from kvedge_torch.utils.gojson import go_json

__all__ = ["go_json"]
