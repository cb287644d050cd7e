"""Build the GPU chart's Kubernetes manifests as plain dicts.

The port's copy of ``kvedge_tpu/render/manifests.py``. Each function
mirrors one reference template; the rendered set is the JAX package's
single-host set under ``torch-gpu-*`` keys:

==============================================  ================================
kvedge-torch manifest                           reference template
==============================================  ================================
``torch-gpu-runtime.yaml`` (Deployment)         ``aziot-edge-vm.yaml`` (VM)
``torch-gpu-state-volume.yaml`` (PVC)           ``aziot-edge-data-volume-container.yaml``
``torch-gpu-state-volume-prepopulated.yaml``    ``aziot-edge-data-volume-disk.yaml``
  (dead alternative, excluded by .helmignore)     (dead alternative, excluded)
``torch-gpu-runtime-config-secret.yaml``        ``aziot-edge-runtime-config-secret.yaml``
``torch-gpu-boot-config-secret.yaml``           ``aziot-edge-vm-cloud-init-secret.yaml``
``torch-gpu-runtime-service.yaml``              ``aziot-edge-vm-service.yaml``
  (conditional)
``torch-gpu-healthz-test.yaml``                 — (the reference verifies by
  (conditional ``helm test`` hook Pod)            hand, its ``NOTES.txt:8-12``)
==============================================  ================================

With ``tpuNumHosts`` N > 1 the JAX package's multi-host set renders in
the same way: ``torch-gpu-runtime-multihost.yaml`` (a StatefulSet of N
pods) and ``torch-gpu-hosts-service.yaml`` (its headless service)
replace the Deployment and its PVC, and
``torch-gpu-healthz-test-multihost.yaml`` targets pod 0; the config
TOML's ``[distributed] num_processes`` must equal N, or the render
fails. Each pod asks for ``gpusPerHost`` G cards (the reference's chips
a host are fixed by its machine type), runs one local rank a card
(``parallel/launch.py``) and, above one card, states G to the runtime as
``KVEDGE_EXPECTED_CARDS``; the TOML's ``[mesh]`` must resolve over
N x G cards, or the render fails.

What is TPU-specific changes, and nothing else: the image
(:data:`RUNTIME_IMAGE`, built by ``deployment/gpu/Dockerfile``), the node
selector (``nvidia.com/gpu.product``, the label NVIDIA's GPU feature
discovery sets), the device request (G ``nvidia.com/gpu``), the pod's
memory request (:func:`pod_memory`, per local rank), the cards' env,
and the modules the containers run (``kvedge_torch.bootstrap.entrypoint``,
``kvedge_torch.runtime.healthcheck``).

The KubeVirt VM becomes a ``Deployment`` with ``replicas: 1`` and
``strategy: Recreate`` holding a ReadWriteOnce state PVC: on node failure the
controller reschedules the pod and the PVC re-attaches — the same resilience
story (and the same node-bound-PVC caveat) as the reference's VM + DataVolume
(``README.md:88-89``). ``Recreate`` guarantees at most one pod holds the RWO
volume, as only one VM held the reference's boot disk.
"""

from __future__ import annotations

import base64
import dataclasses

from kvedge_torch.config.values import ChartValues
from kvedge_torch.render import bootconfig
from kvedge_torch.render.names import (
    DOMAIN_LABEL,
    OS_LABEL,
    common_labels,
    resource_name,
)
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_torch.runtime.heartbeat import INIT_EVENTS_FILE
from kvedge_torch.version import APP_VERSION, CHART_NAME

# The prebuilt GPU runtime image: PyTorch for CUDA, the port and its
# kernels built for sm_90a. Built by deployment/gpu/Dockerfile.
RUNTIME_IMAGE = f"kvedgedev/torch-gpu-runtime:{APP_VERSION}"

# GPU node-selector key (NVIDIA GPU feature discovery's product label);
# the value comes from values.tpuAccelerator.
GPU_PRODUCT_SELECTOR = "nvidia.com/gpu.product"

# Hardcoded pod resources, mirroring the reference's fixed VM size:
# 4 cores (aziot-edge-vm.yaml:18); the cards are gpusPerHost. The memory
# request is per local rank, since every rank imports torch: one rank's
# covers the serve payload's peak resident set at the flagship's full
# width, 6.35 GiB (the largest VmRSS sampled, 6,820,671,488 B) on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, in chip_smoke.py's boot
# phase, which gates it; 8Gi leaves ~26% above it.
POD_CPU = "4"
POD_MEMORY_PER_RANK_GI = 8
GPU_RESOURCE = "nvidia.com/gpu"


def pod_memory(values: ChartValues) -> str:
    """The pod's memory request: :data:`POD_MEMORY_PER_RANK_GI` a local
    rank, one rank a card."""
    return f"{POD_MEMORY_PER_RANK_GI * values.gpusPerHost}Gi"

STATE_MOUNT = "/var/lib/kvedge/state"
# Native PID-1 supervisor (native/kvedge-init.cc), built into the image.
# Its event log lives on the state volume so supervision history survives
# rescheduling; the status server surfaces it at /status. The filename is
# owned by the runtime module that reads it back.
INIT_BIN = "/opt/kvedge/bin/kvedge-init"
INIT_EVENTS_PATH = f"{STATE_MOUNT}/{INIT_EVENTS_FILE}"
SSH_PORT = 22
# Default status port is owned by RuntimeConfig; the rendered containerPort /
# Service / NOTES follow the operator's [status] port when a runtime config
# is provided (see status_port()), so the two can't drift.
STATUS_PORT = RuntimeConfig.status_port


def parsed_runtime_config(values: ChartValues) -> RuntimeConfig:
    """The runtime config the opaque TOML value declares (defaults if empty).

    Parsing it at render time also validates it: a config the port's
    runtime would refuse fails the render, not the booted pod.
    """
    if not values.jaxRuntimeConfig:
        return RuntimeConfig()
    return RuntimeConfig.parse(values.jaxRuntimeConfig)


def status_port(values: ChartValues) -> int:
    """The status port the manifests must expose."""
    port = parsed_runtime_config(values).status_port
    if port == 0:
        raise ValueError(
            "[status] port 0 (ephemeral) is only valid for local runs; "
            "manifests need a concrete port to expose"
        )
    return port


def _b64(text: str) -> str:
    return base64.b64encode(text.encode("utf-8")).decode("ascii")


def state_volume(values: ChartValues) -> dict:
    """State PVC — the DataVolume analogue.

    Reference: ``aziot-edge-data-volume-container.yaml``. Pods boot from
    the OCI image instead of a disk, so the PVC holds only durable runtime
    *state* (heartbeats, checkpoints, the prefix registry); it is
    dynamically provisioned from the cluster's default storage class.
    """
    name = resource_name(values.nameOverride)
    return {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {
            "name": f"{name}-runtime-dv",
            "labels": common_labels(),
        },
        "spec": {
            "accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": values.tpuRuntimeDiskSize}},
        },
    }


def state_volume_prepopulated(values: ChartValues) -> dict:
    """Dead alternative to :func:`state_volume` — excluded from packaging.

    Reference: ``aziot-edge-data-volume-disk.yaml``, excluded by its
    ``.helmignore:24``. The analogue: a PVC of the same name prepopulated
    from a volume snapshot, likewise excluded by
    ``deployment/gpu/helm/.helmignore`` and by :func:`render_all`.
    """
    doc = state_volume(values)
    doc["spec"]["dataSourceRef"] = {
        "apiGroup": "snapshot.storage.k8s.io",
        "kind": "VolumeSnapshot",
        "name": "torch-gpu-runtime-state-seed",
    }
    return doc


def runtime_config_secret(values: ChartValues) -> dict:
    """Opaque runtime-config Secret.

    Reference: ``aziot-edge-runtime-config-secret.yaml`` — the user's
    config.toml base64'd under the key ``userdata``.
    """
    name = resource_name(values.nameOverride)
    return {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": {"name": f"{name}-runtime-jaxconfig"},
        "data": {"userdata": _b64(values.jaxRuntimeConfig)},
    }


def boot_config_secret(values: ChartValues) -> dict:
    """Boot-config Secret — the cloud-init Secret analogue.

    Reference: ``aziot-edge-vm-cloud-init-secret.yaml``, named through the
    name helper (see :mod:`kvedge_torch.render.names`).
    """
    name = resource_name(values.nameOverride)
    return {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": {"name": f"{name}-runtime-bootconfig"},
        "data": {"userdata": _b64(bootconfig.boot_config_document(values))},
    }


def cards_env(values: ChartValues) -> list[dict]:
    """The pod's cards re-stated to the runtime, which holds them to the
    cards it sees (``KVEDGE_EXPECTED_CARDS``); none at one card, so a
    default render is the reference's."""
    if values.gpusPerHost == 1:
        return []
    return [{"name": "KVEDGE_EXPECTED_CARDS",
             "value": str(values.gpusPerHost)}]


def runtime_deployment(values: ChartValues) -> dict:
    """The core resource: the GPU runtime Deployment — the VM analogue.

    Reference: ``aziot-edge-vm.yaml``. Correspondences:

    * ``running: true`` (:9) -> ``replicas: 1`` + ``strategy: Recreate``;
    * 4 cores / q35 (:18,:37) -> cpu 4 requests, the memory the serve
      payload peaks at for each local rank, and ``gpusPerHost`` GPUs;
    * bootdisk -> DataVolume (:46-48) -> the state PVC mount;
    * serial-tagged config disk -> Secret (:25-28,:49-51) -> the config
      Secret mounted under ``/mnt/disks/<serial>``;
    * cloudInitNoCloud cdrom (:29-31,:52-57) -> the boot-config Secret
      mounted at ``/mnt/boot-secret``, consumed by the entrypoint;
    * masquerade NIC + static MAC (:32-35) -> GPU-product node selector
      (the stable hardware identity) + pod networking;
    * ``kubevirt.io/domain`` label (:14) -> ``kvedge.dev/domain``.
    """
    name = resource_name(values.nameOverride)
    port = status_port(values)
    pod_labels = dict(common_labels())
    pod_labels[DOMAIN_LABEL] = f"{name}-runtime"
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "labels": {OS_LABEL: "linux"},
            "name": f"{name}-runtime",
        },
        "spec": {
            "replicas": 1,
            "strategy": {"type": "Recreate"},
            "selector": {"matchLabels": {DOMAIN_LABEL: f"{name}-runtime"}},
            "template": {
                "metadata": {"labels": pod_labels},
                "spec": {
                    "hostname": bootconfig.RUNTIME_HOSTNAME,
                    "nodeSelector": {
                        GPU_PRODUCT_SELECTOR: values.tpuAccelerator
                    },
                    "containers": [
                        {
                            "name": "runtime",
                            "image": RUNTIME_IMAGE,
                            "command": [
                                INIT_BIN,
                                "--events",
                                INIT_EVENTS_PATH,
                                "--",
                                "python",
                                "-m",
                                "kvedge_torch.bootstrap.entrypoint",
                                "--boot-config",
                                f"{bootconfig.BOOT_SECRET_MOUNT}/userdata",
                            ],
                            "ports": [
                                {"containerPort": SSH_PORT, "name": "ssh"},
                                {"containerPort": port, "name": "status"},
                            ],
                            # Single-host topology, re-stated to the
                            # runtime so boot refuses a TOML declaring
                            # [distributed] num_processes > 1.
                            "env": [
                                {
                                    "name": "KVEDGE_EXPECTED_PROCESSES",
                                    "value": "1",
                                },
                            ] + cards_env(values),
                            "resources": {
                                "requests": {
                                    "cpu": POD_CPU,
                                    "memory": pod_memory(values),
                                },
                                "limits": {GPU_RESOURCE: values.gpusPerHost},
                            },
                            # Probes target /version (server-alive), NOT
                            # /healthz: a degraded runtime must stay
                            # reachable for debugging, so kubelet must
                            # neither kill it nor pull it from the service
                            # endpoints. /healthz (503 when degraded) is
                            # for external monitors.
                            "livenessProbe": {
                                "httpGet": {
                                    "path": "/version",
                                    "port": "status",
                                },
                                # A cold pod's first graph captures are
                                # slow.
                                "initialDelaySeconds": 120,
                                "periodSeconds": 10,
                            },
                            "readinessProbe": {
                                "httpGet": {
                                    "path": "/version",
                                    "port": "status",
                                },
                                "initialDelaySeconds": 5,
                                "periodSeconds": 10,
                            },
                            "volumeMounts": [
                                {
                                    "name": "statedisk",
                                    "mountPath": STATE_MOUNT,
                                },
                                {
                                    "name": "jaxconfigdisk",
                                    "mountPath": (
                                        f"{bootconfig.DISKS_ROOT}/"
                                        f"{bootconfig.CONFIG_SERIAL}"
                                    ),
                                    "readOnly": True,
                                },
                                {
                                    "name": "bootconfigdisk",
                                    "mountPath": bootconfig.BOOT_SECRET_MOUNT,
                                    "readOnly": True,
                                },
                            ],
                        }
                    ],
                    "volumes": [
                        {
                            "name": "statedisk",
                            "persistentVolumeClaim": {
                                "claimName": f"{name}-runtime-dv"
                            },
                        },
                        {
                            "name": "jaxconfigdisk",
                            "secret": {
                                "secretName": f"{name}-runtime-jaxconfig"
                            },
                        },
                        {
                            "name": "bootconfigdisk",
                            "secret": {
                                "secretName": f"{name}-runtime-bootconfig"
                            },
                        },
                    ],
                },
            },
        },
    }


def hosts_service(values: ChartValues) -> dict:
    """Headless Service giving the multi-host pods stable per-ordinal DNS
    (the reference's): pod N is ``<name>-runtime-N.<name>-runtime-hosts``
    before readiness, so the coordinator (pod 0) resolves while every
    pod is still blocked joining the process group, hence
    ``publishNotReadyAddresses: true``. The port follows the config's
    ``[distributed] coordinator_port`` (the Helm chart pins the
    default)."""
    name = resource_name(values.nameOverride)
    coordinator_port = parsed_runtime_config(values).coordinator_port
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "labels": common_labels(),
            "name": f"{name}-runtime-hosts",
        },
        "spec": {
            "clusterIP": "None",
            "publishNotReadyAddresses": True,
            "selector": {DOMAIN_LABEL: f"{name}-runtime"},
            "ports": [
                {
                    "name": "coordinator",
                    "protocol": "TCP",
                    "port": coordinator_port,
                }
            ],
        },
    }


def runtime_statefulset(values: ChartValues) -> dict:
    """Multi-host variant of the runtime: one pod, ``gpusPerHost`` GPUs,
    per host.

    The pod template of :func:`runtime_deployment` with the reference's
    multi-host deltas:

    * ``kind: StatefulSet`` with ``replicas = tpuNumHosts`` and
      ``podManagementPolicy: Parallel``: ``init_process_group`` blocks
      until every rank joins, so the pods start together;
    * no ``hostname:`` override: the pods' hostnames
      ``<name>-runtime-<ordinal>`` are the identity
      ``parallel/distributed.py`` infers the process id from;
    * ``KVEDGE_COORDINATOR`` pointing at pod 0's stable headless-DNS name
      (the runtime appends ``[distributed] coordinator_port``) and
      ``KVEDGE_EXPECTED_PROCESSES`` the chart's topology, which boot holds
      the TOML to;
    * per-host state PVCs from ``volumeClaimTemplates`` (a ReadWriteOnce
      volume cannot span hosts); checkpoints a multi-process ``serve``
      restores go to a ``checkpoint_dir`` on shared storage.
    """
    name = resource_name(values.nameOverride)
    doc = runtime_deployment(values)
    doc["kind"] = "StatefulSet"
    # No strategy (a Deployment concept: each ordinal owns its claim); the
    # keys in the chart template's order, so both emit the same bytes.
    dep = doc["spec"]
    spec = doc["spec"] = {
        "replicas": values.tpuNumHosts,
        "serviceName": f"{name}-runtime-hosts",
        "podManagementPolicy": "Parallel",
        "selector": dep["selector"],
        "template": dep["template"],
    }
    pod = spec["template"]["spec"]
    del pod["hostname"]
    pod["containers"][0]["env"] = [
        {
            "name": "KVEDGE_COORDINATOR",
            "value": f"{name}-runtime-0.{name}-runtime-hosts",
        },
        {
            "name": "KVEDGE_EXPECTED_PROCESSES",
            "value": str(values.tpuNumHosts),
        },
    ] + cards_env(values)
    pod["volumes"] = [v for v in pod["volumes"] if v["name"] != "statedisk"]
    spec["volumeClaimTemplates"] = [
        {
            "metadata": {"name": "statedisk"},
            "spec": {
                "accessModes": ["ReadWriteOnce"],
                "resources": {
                    "requests": {"storage": values.tpuRuntimeDiskSize}
                },
            },
        }
    ]
    return doc


def access_service(values: ChartValues) -> dict | None:
    """Conditional LoadBalancer for external SSH + status access.

    Reference: ``aziot-edge-vm-service.yaml`` — rendered only when the
    enable flag is true (:1), LoadBalancer on TCP 22 (:13-17), selecting the
    runtime pod by domain label (:10-11), ``externalTrafficPolicy: Cluster``
    (:9). The status port rides alongside SSH.
    """
    if not values.tpuRuntimeEnableExternalSsh:
        return None
    name = resource_name(values.nameOverride)
    port = status_port(values)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "labels": common_labels(),
            "name": f"{name}-runtime-ssh-service",
        },
        "spec": {
            "externalTrafficPolicy": "Cluster",
            "selector": {DOMAIN_LABEL: f"{name}-runtime"},
            "ports": [
                {
                    "name": "ssh",
                    "protocol": "TCP",
                    "port": SSH_PORT,
                    "targetPort": SSH_PORT,
                },
                {
                    "name": "status",
                    "protocol": "TCP",
                    "port": port,
                    "targetPort": port,
                },
            ],
            "type": "LoadBalancer",
        },
    }


def healthz_test_pod(values: ChartValues) -> dict | None:
    """``helm test`` hook Pod: polls the runtime's /healthz in-cluster.

    Runs the image's :mod:`kvedge_torch.runtime.healthcheck` against the
    runtime's stable in-cluster DNS name: pod 0's headless name when
    ``tpuNumHosts > 1``, the access Service's otherwise. A single-host
    install with the Service disabled has no stable DNS target, so no
    hook renders (``helm test`` then reports no tests, the reference's
    "verify by hand" posture).
    """
    name = resource_name(values.nameOverride)
    port = status_port(values)
    if values.tpuNumHosts > 1:
        host = f"{name}-runtime-0.{name}-runtime-hosts"
    elif values.tpuRuntimeEnableExternalSsh:
        host = f"{name}-runtime-ssh-service"
    else:
        return None
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "labels": common_labels(),
            "annotations": {
                "helm.sh/hook": "test",
                "helm.sh/hook-delete-policy":
                    "before-hook-creation,hook-succeeded",
            },
            "name": f"{name}-runtime-healthz-test",
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [
                {
                    "name": "healthz",
                    "image": RUNTIME_IMAGE,
                    "command": [
                        "python",
                        "-m",
                        "kvedge_torch.runtime.healthcheck",
                        f"http://{host}:{port}/healthz",
                        "--deadline",
                        "240",
                    ],
                }
            ],
        },
    }


@dataclasses.dataclass(frozen=True)
class RenderedChart:
    """The rendered manifest set, keyed by output filename."""

    manifests: dict[str, dict]
    notes: str

    def ordered(self) -> list[tuple[str, dict]]:
        return sorted(self.manifests.items())


def render_notes(values: ChartValues) -> str:
    """Post-install usage text (reference: ``templates/NOTES.txt``)."""
    name = resource_name(values.nameOverride)
    workload = "deployment" if values.tpuNumHosts == 1 else "statefulset"
    return (
        f"You have installed release {APP_VERSION} of {CHART_NAME}.\n"
        "\n"
        "To check the status of the newly created PyTorch GPU runtime, "
        "try:\n"
        f"kubectl get {workload} {name}-runtime\n"
    ) + (
        f"Each pod runs one rank on each of its {values.gpusPerHost} GPUs; "
        "the config TOML's [mesh] spans tpuNumHosts x gpusPerHost = "
        f"{values.tpuNumHosts * values.gpusPerHost} GPUs.\n"
        if values.gpusPerHost != 1 else ""
    ) + (
        "\n"
        "To query the runtime status endpoint (once the pod is running):\n"
        f"curl http://$(kubectl get service {name}-runtime-ssh-service "
        "--output jsonpath='{.status.loadBalancer.ingress[0].ip}')"
        f":{status_port(values)}/status\n"
        "\n"
        "To connect to the runtime pod over SSH:\n"
        f"ssh kvedge@$(kubectl get service {name}-runtime-ssh-service "
        "--output jsonpath='{.status.loadBalancer.ingress[0].ip}')\n"
    ) + (
        "\n"
        "To verify the runtime from inside the cluster:\n"
        "helm test <release-name>\n"
        if healthz_test_pod(values) is not None else ""
    )


def _check_multihost_consistency(values: ChartValues) -> None:
    """Fail the render when the chart's shape and the TOML's topology
    disagree (the reference's check and messages, and the port's own of
    the mesh over the pods' cards): the runtime would find out only at
    boot, its pods blocking in the join or degraded."""
    procs = parsed_runtime_config(values).num_processes
    if values.tpuNumHosts > 1 and procs != values.tpuNumHosts:
        raise ValueError(
            f"tpuNumHosts={values.tpuNumHosts} but the runtime config "
            f"declares [distributed] num_processes={procs}; the "
            "StatefulSet replica count and the process group must match "
            "(set num_processes in the config TOML)")
    if values.tpuNumHosts == 1 and procs > 1:
        raise ValueError(
            f"runtime config declares [distributed] num_processes={procs} "
            f"but tpuNumHosts=1; set --set tpuNumHosts={procs} to render "
            "the multi-host StatefulSet")
    cards = values.tpuNumHosts * values.gpusPerHost
    mesh = parsed_runtime_config(values).mesh
    try:
        mesh.resolved_shape(cards)
    except ValueError as e:
        raise ValueError(
            f"tpuNumHosts={values.tpuNumHosts} x gpusPerHost="
            f"{values.gpusPerHost} = {cards} cards but the runtime config "
            f"declares [mesh] axes = {dict(mesh.axes)} ({e}); the pods' "
            "cards and the mesh must match (set gpusPerHost, or [mesh] "
            "axes in the config TOML)") from None


def render_all(values: ChartValues, include_dead: bool = False) -> RenderedChart:
    """Render the full manifest set.

    ``include_dead=False`` mirrors the packaging exclusion of the
    prepopulated-volume alternative (reference ``.helmignore:23-24``): the
    dead template exists in the chart source but is never rendered; if it
    were, its name would collide with the live state volume.
    """
    values.validate()
    _check_multihost_consistency(values)
    manifests: dict[str, dict] = {
        "torch-gpu-runtime-config-secret.yaml": runtime_config_secret(values),
        "torch-gpu-boot-config-secret.yaml": boot_config_secret(values),
    }
    if values.tpuNumHosts == 1:
        manifests["torch-gpu-runtime.yaml"] = runtime_deployment(values)
        manifests["torch-gpu-state-volume.yaml"] = state_volume(values)
    else:
        manifests["torch-gpu-runtime-multihost.yaml"] = (
            runtime_statefulset(values))
        manifests["torch-gpu-hosts-service.yaml"] = hosts_service(values)
    if include_dead:
        manifests["torch-gpu-state-volume-prepopulated.yaml"] = (
            state_volume_prepopulated(values)
        )
    service = access_service(values)
    if service is not None:
        manifests["torch-gpu-runtime-service.yaml"] = service
    test_pod = healthz_test_pod(values)
    if test_pod is not None:
        key = ("torch-gpu-healthz-test.yaml" if values.tpuNumHosts == 1
               else "torch-gpu-healthz-test-multihost.yaml")
        manifests[key] = test_pod
    return RenderedChart(manifests=manifests, notes=render_notes(values))
