"""The chart's values (:mod:`kvedge_torch.config.values`). The opaque
runtime TOML they carry is parsed by
:mod:`kvedge_torch.runtime.config`."""

from kvedge_torch.config.values import ChartValues, DEFAULT_VALUES

__all__ = ["ChartValues", "DEFAULT_VALUES"]
