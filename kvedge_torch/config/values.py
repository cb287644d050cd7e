"""The GPU chart's entire user-facing config surface: eight values.

The port's copy of ``kvedge_tpu/config/values.py``. Seven field names,
their defaults but one, ``parse_set_flag`` and ``parse_set_file_flag``
are the same, so one values file and one ``--set`` line without the
eighth drive both packages' renders. What is TPU-specific changes:

====================================  =========================================
kvedge-tpu                            kvedge-torch
====================================  =========================================
``tpuAccelerator``                    the value of the node label that
  (GKE TPU accelerator type,            NVIDIA's GPU feature discovery sets,
  ``tpu-v5-lite-podslice``)             ``nvidia.com/gpu.product``; default
                                        ``NVIDIA-H100-80GB-HBM3``. Checked by
                                        Kubernetes' label-value rule (it has
                                        capitals, which the TPU check refuses)
``tpuNumHosts`` (N > 1 renders a      the same: N > 1 renders a StatefulSet
  StatefulSet over a slice)             of N pods
the chips a host, fixed by            ``gpusPerHost`` (default 1): the
  ``tpuAccelerator``'s machine type     ``nvidia.com/gpu`` cards each pod asks
                                        for, one local rank each
====================================  =========================================

``gpusPerHost`` is the port's own value: the JAX package's parser
refuses unknown keys, so a values file that sets it drives only the
port's chart. The config TOML's ``[mesh]`` must resolve over
``tpuNumHosts x gpusPerHost`` cards, or the render fails.

``jaxRuntimeConfig`` keeps its name: it carries the runtime TOML, which
the port's ``RuntimeConfig`` parses.
"""

from __future__ import annotations

import dataclasses
import re

_DISK_SIZE_RE = re.compile(r"^[1-9][0-9]*(Ei|Pi|Ti|Gi|Mi|Ki|E|P|T|G|M|K)?$")
# Resource-name prefixes are lowercase RFC 1123 labels.
_NAME_RE = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?$")
# Kubernetes label values: at most 63 characters, alphanumerics at both
# ends, '-', '_' and '.' between.
_LABEL_VALUE_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9_.-]{0,61}[A-Za-z0-9])?$")

@dataclasses.dataclass(frozen=True)
class ChartValues:
    """The chart values (see the module docstring for what differs from
    the JAX package's)."""

    # State PVC size (reference: aziotEdgeVmDiskSize, values.yaml:2).
    tpuRuntimeDiskSize: str = "4Gi"
    # Create a LoadBalancer service for external SSH/status access
    # (reference: aziotEdgeVmEnableExternalSsh, values.yaml:5).
    tpuRuntimeEnableExternalSsh: bool = True
    # Resource-name prefix; empty falls back to the chart name, and
    # either way it is truncated to 40 characters (reference:
    # nameOverride, values.yaml:8).
    nameOverride: str = ""
    # SSH public key authorized inside the runtime pod
    # (reference: publicSshKey, values.yaml:11).
    publicSshKey: str = ""
    # Opaque runtime config TOML, usually passed via --set-file
    # (reference: azIotEdgeConfig, values.yaml:14).
    jaxRuntimeConfig: str = ""
    # Stable hardware identity: the GPU product the runtime pod is pinned
    # to, as the nvidia.com/gpu.product node label names it
    # (reference: macAddress, values.yaml:17).
    tpuAccelerator: str = "NVIDIA-H100-80GB-HBM3"
    # Hosts: 1 renders the Deployment, N > 1 a StatefulSet of N pods
    # (reference: the JAX chart's tpuNumHosts).
    tpuNumHosts: int = 1
    # Cards each pod asks for, one local rank each (the port's own value:
    # the reference's chip count a host is its machine type's).
    gpusPerHost: int = 1

    def validate(self) -> None:
        # Resource names must be RFC 1123 labels after the prefix is applied;
        # empty means "fall back to the chart name" (the helper's `default`).
        if self.nameOverride and not _NAME_RE.match(self.nameOverride):
            raise ValueError(
                f"nameOverride {self.nameOverride!r} is not a valid Kubernetes "
                "resource-name prefix (lowercase RFC 1123)"
            )
        if not _DISK_SIZE_RE.match(self.tpuRuntimeDiskSize):
            raise ValueError(
                f"tpuRuntimeDiskSize {self.tpuRuntimeDiskSize!r} is not a "
                "valid Kubernetes quantity (e.g. 4Gi)"
            )
        if not isinstance(self.tpuRuntimeEnableExternalSsh, bool):
            raise ValueError("tpuRuntimeEnableExternalSsh must be a bool")
        if not (isinstance(self.tpuAccelerator, str)
                and _LABEL_VALUE_RE.match(self.tpuAccelerator)):
            raise ValueError(
                f"tpuAccelerator {self.tpuAccelerator!r} is not a valid "
                "node-label value (nvidia.com/gpu.product, e.g. "
                "NVIDIA-H100-80GB-HBM3)"
            )
        if not isinstance(self.tpuNumHosts, int) or isinstance(
            self.tpuNumHosts, bool
        ) or self.tpuNumHosts < 1:
            raise ValueError(
                f"tpuNumHosts must be a positive integer, got "
                f"{self.tpuNumHosts!r}"
            )
        if not isinstance(self.gpusPerHost, int) or isinstance(
            self.gpusPerHost, bool
        ) or self.gpusPerHost < 1:
            raise ValueError(
                f"gpusPerHost must be a positive integer, got "
                f"{self.gpusPerHost!r}"
            )

    def replace(self, **kwargs) -> "ChartValues":
        values = dataclasses.replace(self, **kwargs)
        values.validate()
        return values


DEFAULT_VALUES = ChartValues()

_BOOL_VALUES = {"true": True, "false": False}


def parse_set_flag(values: ChartValues, assignment: str) -> ChartValues:
    """Apply one ``--set key=value`` assignment, helm-style.

    Mirrors the install interface of ``helm install --set ...``
    (reference ``README.md:60``). Booleans accept ``true``/``false``.
    """
    key, sep, raw = assignment.partition("=")
    if not sep:
        raise ValueError(f"--set expects key=value, got {assignment!r}")
    if key not in {f.name for f in dataclasses.fields(ChartValues)}:
        raise ValueError(f"unknown value {key!r}")
    current = getattr(values, key)
    if isinstance(current, bool):
        if raw.lower() not in _BOOL_VALUES:
            raise ValueError(f"{key} expects true or false, got {raw!r}")
        parsed: object = _BOOL_VALUES[raw.lower()]
    elif isinstance(current, int):
        try:
            parsed = int(raw)
        except ValueError:
            raise ValueError(f"{key} expects an integer, got {raw!r}") from None
    else:
        parsed = raw
    return values.replace(**{key: parsed})


def parse_set_file_flag(values: ChartValues, assignment: str) -> ChartValues:
    """Apply one ``--set-file key=path`` assignment, helm-style.

    The reference passes the opaque IoT Edge config this way:
    ``--set-file azIotEdgeConfig=config.toml`` (``README.md:60``).
    """
    key, sep, path = assignment.partition("=")
    if not sep:
        raise ValueError(f"--set-file expects key=path, got {assignment!r}")
    with open(path, "r", encoding="utf-8") as fh:
        content = fh.read()
    if key not in {f.name for f in dataclasses.fields(ChartValues)}:
        raise ValueError(f"unknown value {key!r}")
    if isinstance(getattr(values, key), bool):
        raise ValueError(f"{key} cannot be set from a file")
    return values.replace(**{key: content})
