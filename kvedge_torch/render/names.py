"""Naming and label helpers — the `_helper.tpl` analogue (the port's copy
of ``kvedge_tpu/render/names.py``, over the port's chart name).

Reference: ``deployment/helm/templates/_helper.tpl``:

* ``aziotedgevm.name`` (:6-8): ``default .Chart.Name .Values.nameOverride |
  trunc 40 | trimSuffix "-"`` — the name prefix for every resource.
* ``aziotedgevm.labels`` (:20-26): app version + managed-by labels (the
  chart-name label at :21 is commented out in the reference and therefore
  intentionally absent here too).

One deliberate divergence, documented per SURVEY.md §7 hard-part (d): the
reference references its cloud-init Secret by raw ``.Values.nameOverride``
(``aziot-edge-vm.yaml:57``, with a live TODO) so an unset ``nameOverride``
would render a Secret name the VM never finds. kvedge-tpu closes that TODO
at both layers: every resource name routes through :func:`resource_name`
(so empty always falls back to the chart name), and the shipped default is
``nameOverride: ""`` — the unset path is what every default install and
render actually runs, not an untested corner. ``tests/test_names.py`` pins
the unset-default rendering.
"""

from __future__ import annotations

from kvedge_torch.version import APP_VERSION, CHART_NAME

NAME_TRUNC = 40  # reference: `trunc 40` (_helper.tpl:7)

# Label keys. `kvedge.dev/domain` is the service-selector label, the analogue
# of `kubevirt.io/domain` (aziot-edge-vm.yaml:14, aziot-edge-vm-service.yaml:11);
# `kvedge.dev/os` mirrors the VM's `kubevirt.io/os: linux` (aziot-edge-vm.yaml:6).
DOMAIN_LABEL = "kvedge.dev/domain"
OS_LABEL = "kvedge.dev/os"


def resource_name(name_override: str = "", chart_name: str = CHART_NAME) -> str:
    """Resource-name prefix: ``default chartName nameOverride | trunc 40 | trimSuffix '-'``.

    ``trimSuffix "-"`` strips at most ONE trailing dash (sprig semantics),
    so this must not ``rstrip`` — the Helm chart consistency check depends
    on byte-identical behavior.
    """
    name = (name_override or chart_name)[:NAME_TRUNC]
    return name[:-1] if name.endswith("-") else name


def common_labels(
    app_version: str = APP_VERSION, managed_by: str = "Helm"
) -> dict[str, str]:
    """Common labels (reference `_helper.tpl:20-26`)."""
    return {
        "app.kubernetes.io/version": app_version,
        "app.kubernetes.io/managed-by": managed_by,
    }
