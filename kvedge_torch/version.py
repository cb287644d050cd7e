"""Chart and application version of the port's GPU deployment.

The port's copy of ``kvedge_tpu/version.py``: the same versions, and the
chart's own name, description and keywords. The chart
(``deployment/gpu/helm/Chart.yaml``) carries the same four values.
"""

__version__ = "0.1.0"

CHART_NAME = "kvedge-torch"
CHART_VERSION = __version__
APP_VERSION = __version__
CHART_DESCRIPTION = (
    "A Helm chart for deploying a resilient PyTorch runtime on one NVIDIA "
    "GPU on K8s as a PVC-backed single-replica Deployment."
)
CHART_KEYWORDS = ("pytorch", "cuda", "gpu", "kvedge")
