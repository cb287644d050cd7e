"""Manifest rendering for the port's GPU deployment: values -> Kubernetes
objects.

The port's copy of ``kvedge_tpu/render``: the same manifests, rendered
natively in Python for one NVIDIA GPU, and an equivalent Helm chart under
``deployment/gpu/helm`` kept identical to this renderer by a consistency
test.
"""

from kvedge_torch.render.names import resource_name, common_labels
from kvedge_torch.render.manifests import render_all, RenderedChart
from kvedge_torch.render.emit import to_yaml, to_multidoc_yaml

__all__ = [
    "resource_name",
    "common_labels",
    "render_all",
    "RenderedChart",
    "to_yaml",
    "to_multidoc_yaml",
]
