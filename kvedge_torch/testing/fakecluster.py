"""A deterministic fake Kubernetes for testing the GPU chart's control flow.

The port's copy of ``kvedge_tpu/testing/fakecluster.py``: the same
controllers over the port's manifests, the multi-host chart's
StatefulSet included. ``boot_pod`` runs the ``kvedge_torch`` entrypoint,
on the CPU.

Simulates exactly the controller behavior the rendered manifests rely on
(SURVEY.md §3.1 steps 3-5, translated from KubeVirt/CDI to pods/PVCs):

* **PVC binder** — WaitForFirstConsumer-style: a PVC binds to the node of
  the first pod that mounts it. By default the volume is then *node-bound*
  (the reference's documented failure mode: rescheduling can fail to
  re-attach, ``README.md:89``); ``resilient_storage=True`` models a
  detachable storage class (the ``README.md:88`` StorageOS mitigation).
* **Deployment controller** — keeps one pod existing per single-replica
  Recreate Deployment; never runs two pods concurrently.
* **StatefulSet controller** — the multi-host chart variant: ``replicas``
  pods with STABLE ordinal names (``<name>-<ordinal>``, the identity
  ``parallel/distributed.py`` infers the process id from), each owning a
  per-ordinal PVC stamped from ``volumeClaimTemplates``
  (``<template>-<pod>``, the K8s naming rule). A killed pod is recreated
  under the same name and re-attaches the SAME per-ordinal claim —
  per-host state identity across generations, which is the property the
  StatefulSet exists for.
* **Scheduler** — places pending pods on nodes matching ``nodeSelector``
  with the mounted PVC attachable there; otherwise the pod stays Pending
  with a reason.
* **Service endpoints** — label-selector resolution.
* **Failure injection** — ``kill_node`` terminates a node and its pods.

``boot_pod`` optionally *executes the real container entrypoint* against a
scratch pod filesystem whose state mount is the PVC's persistent backing
directory — so resilience tests observe genuine state survival (heartbeat
``boot_count`` increments across rescheduling) rather than a mock of it.
"""

from __future__ import annotations

import base64
import dataclasses
import itertools
import json
import os
import time


@dataclasses.dataclass
class FakeNode:
    name: str
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    alive: bool = True


@dataclasses.dataclass
class FakePod:
    name: str
    spec: dict
    owner: str  # deployment / statefulset name
    node: str | None = None
    phase: str = "Pending"  # Pending | Running | Terminated
    reason: str = ""
    # Incremented each time the controller recreates this (stable-named)
    # pod — StatefulSet generations share a name, unlike Deployment pods.
    generation: int = 1


@dataclasses.dataclass
class FakePVC:
    name: str
    spec: dict
    bound_node: str | None = None


class FakeClusterError(RuntimeError):
    pass


class FakeCluster:
    def __init__(self, nodes: list[FakeNode], *, resilient_storage: bool = False,
                 state_root: str | None = None):
        self.nodes = {n.name: n for n in nodes}
        self.resilient_storage = resilient_storage
        self.state_root = state_root
        self.secrets: dict[str, dict] = {}
        self.pvcs: dict[str, FakePVC] = {}
        self.deployments: dict[str, dict] = {}
        self.statefulsets: dict[str, dict] = {}
        self.services: dict[str, dict] = {}
        self.pods: dict[str, FakePod] = {}
        # helm-hook manifests (the chart's `helm test` healthz Pod): real
        # helm holds these back from install and runs them on demand; the
        # fake cluster records them without scheduling anything.
        self.hooks: dict[str, dict] = {}
        self._pod_seq = itertools.count(1)

    # ---- admission -------------------------------------------------------

    def apply(self, manifests: dict[str, dict] | list[dict]) -> None:
        docs = list(
            manifests.values() if isinstance(manifests, dict) else manifests
        )
        # Duplicate detection is per apply batch (two docs colliding on one
        # name, the .helmignore hazard) — re-applying an existing resource
        # is a normal upgrade and overwrites, like `kubectl apply`.
        seen: set[tuple[str, str]] = set()
        for doc in docs:
            key = (doc["kind"], doc["metadata"]["name"])
            if key in seen:
                raise FakeClusterError(
                    f"{key[0]} {key[1]!r} already exists in this batch "
                    "(duplicate resource name)"
                )
            seen.add(key)
        for doc in docs:
            kind = doc["kind"]
            name = doc["metadata"]["name"]
            if "helm.sh/hook" in doc["metadata"].get("annotations", {}):
                # Checked before kind dispatch: helm holds back ANY
                # hook-annotated resource from install, whatever its kind.
                self.hooks[name] = doc
            elif kind == "Secret":
                self.secrets[name] = doc
            elif kind == "PersistentVolumeClaim":
                if name not in self.pvcs:  # keep binding across upgrades
                    self.pvcs[name] = FakePVC(name=name, spec=doc["spec"])
            elif kind == "Deployment":
                self.deployments[name] = doc
            elif kind == "StatefulSet":
                self.statefulsets[name] = doc
            elif kind == "Service":
                self.services[name] = doc
            else:
                raise FakeClusterError(f"unsupported kind {kind!r}")

    # ---- controllers -----------------------------------------------------

    def step(self) -> None:
        """One reconcile pass of every controller. Deterministic."""
        self._reconcile_deployments()
        self._reconcile_statefulsets()
        self._schedule_pods()

    def converge(self, max_steps: int = 10) -> None:
        for _ in range(max_steps):
            before = self._state_fingerprint()
            self.step()
            if self._state_fingerprint() == before:
                return
        raise FakeClusterError("cluster did not converge")

    def _state_fingerprint(self):
        return tuple(
            (p.name, p.node, p.phase) for p in sorted(
                self.pods.values(), key=lambda p: p.name
            )
        ) + tuple(
            (c.name, c.bound_node) for c in sorted(
                self.pvcs.values(), key=lambda c: c.name
            )
        )

    def _reconcile_deployments(self) -> None:
        for name, dep in self.deployments.items():
            live = [
                p for p in self.pods.values()
                if p.owner == name and p.phase != "Terminated"
            ]
            replicas = dep["spec"].get("replicas", 1)
            strategy = dep["spec"].get("strategy", {}).get("type")
            if len(live) < replicas:
                # Recreate: never start a replacement while an old pod is
                # still non-terminated (there is none here by construction).
                if strategy == "Recreate" and any(
                    p.phase == "Running" for p in live
                ):
                    continue
                pod_spec = dep["spec"]["template"]["spec"]
                self._validate_pod_refs(pod_spec)
                pod = FakePod(
                    name=f"{name}-{next(self._pod_seq)}",
                    spec=dep["spec"]["template"],
                    owner=name,
                )
                self.pods[pod.name] = pod

    def _reconcile_statefulsets(self) -> None:
        for name, sts in self.statefulsets.items():
            spec = sts["spec"]
            replicas = spec.get("replicas", 1)
            templates = spec.get("volumeClaimTemplates", [])
            for ordinal in range(replicas):
                pod_name = f"{name}-{ordinal}"
                existing = self.pods.get(pod_name)
                if existing is not None and existing.phase != "Terminated":
                    continue
                # Stamp the per-ordinal claims (K8s names them
                # <template>-<pod>); they persist across pod generations —
                # that persistence IS the StatefulSet contract under test.
                pod_template = json.loads(json.dumps(spec["template"]))
                pod_spec = pod_template["spec"]
                for tpl in templates:
                    claim = f"{tpl['metadata']['name']}-{pod_name}"
                    if claim not in self.pvcs:
                        self.pvcs[claim] = FakePVC(
                            name=claim, spec=tpl["spec"]
                        )
                    pod_spec.setdefault("volumes", []).append({
                        "name": tpl["metadata"]["name"],
                        "persistentVolumeClaim": {"claimName": claim},
                    })
                self._validate_pod_refs(pod_spec)
                self.pods[pod_name] = FakePod(
                    name=pod_name,
                    spec=pod_template,
                    owner=name,
                    generation=(existing.generation + 1) if existing else 1,
                )

    def _validate_pod_refs(self, pod_spec: dict) -> None:
        for vol in pod_spec.get("volumes", []):
            if "secret" in vol:
                ref = vol["secret"]["secretName"]
                if ref not in self.secrets:
                    raise FakeClusterError(
                        f"pod references missing Secret {ref!r} — the "
                        "name-mismatch class of bug the reference carried "
                        "(aziot-edge-vm.yaml:57)"
                    )
            if "persistentVolumeClaim" in vol:
                ref = vol["persistentVolumeClaim"]["claimName"]
                if ref not in self.pvcs:
                    raise FakeClusterError(
                        f"pod references missing PVC {ref!r}"
                    )

    def _pod_pvcs(self, pod: FakePod) -> list[FakePVC]:
        return [
            self.pvcs[v["persistentVolumeClaim"]["claimName"]]
            for v in pod.spec["spec"].get("volumes", [])
            if "persistentVolumeClaim" in v
        ]

    def pod_state_path(self, pod: FakePod, relpath: str) -> str:
        """Path of a file on the pod's PVC backing dir (mount-path free).

        The persistent backing directory under ``state_root`` is keyed by
        PVC name, so this resolves the same file across pod generations —
        the public way to inspect persisted state (heartbeats etc.)
        without hardcoding the chart's mountPath.
        """
        if self.state_root is None:
            raise FakeClusterError("state_root required for pod_state_path")
        (pvc,) = self._pod_pvcs(pod)
        return os.path.join(self.state_root, pvc.name, relpath)

    def _schedulable_node(self, pod: FakePod) -> tuple[str | None, str]:
        selector = pod.spec["spec"].get("nodeSelector", {})
        candidates = [
            n for n in self.nodes.values()
            if n.alive and all(n.labels.get(k) == v for k, v in selector.items())
        ]
        if not candidates:
            return None, f"no alive node matches nodeSelector {selector}"
        for pvc in self._pod_pvcs(pod):
            if pvc.bound_node is not None and not self.resilient_storage:
                # Node-bound volume: only its node is eligible
                # (the README.md:89 failure mode).
                candidates = [n for n in candidates if n.name == pvc.bound_node]
                if not candidates:
                    return None, (
                        f"PVC {pvc.name} is bound to node {pvc.bound_node} "
                        "which is not schedulable (node-bound volume; see "
                        "reference README.md:89)"
                    )
        return candidates[0].name, ""

    def _schedule_pods(self) -> None:
        for pod in self.pods.values():
            if pod.phase != "Pending":
                continue
            node, reason = self._schedulable_node(pod)
            if node is None:
                pod.reason = reason
                continue
            pod.node = node
            pod.phase = "Running"
            pod.reason = ""
            for pvc in self._pod_pvcs(pod):
                if pvc.bound_node is None or self.resilient_storage:
                    pvc.bound_node = node

    # ---- failure injection ----------------------------------------------

    def kill_node(self, name: str) -> None:
        self.nodes[name].alive = False
        for pod in self.pods.values():
            if pod.node == name and pod.phase == "Running":
                pod.phase = "Terminated"
                pod.reason = f"node {name} failed"

    def revive_node(self, name: str) -> None:
        self.nodes[name].alive = True

    # ---- observation -----------------------------------------------------

    def running_pod(self, deployment: str) -> FakePod | None:
        for pod in self.pods.values():
            if pod.owner == deployment and pod.phase == "Running":
                return pod
        return None

    def pending_pods(self, deployment: str) -> list[FakePod]:
        return [
            p for p in self.pods.values()
            if p.owner == deployment and p.phase == "Pending"
        ]

    def sts_pods(self, statefulset: str) -> list[FakePod]:
        """The StatefulSet's pods, by ordinal."""
        replicas = self.statefulsets[statefulset]["spec"].get("replicas", 1)
        return [
            self.pods[f"{statefulset}-{i}"]
            for i in range(replicas)
            if f"{statefulset}-{i}" in self.pods
        ]

    def service_endpoints(self, service: str) -> list[str]:
        svc = self.services[service]
        selector = svc["spec"]["selector"]
        return sorted(
            p.name for p in self.pods.values()
            if p.phase == "Running" and all(
                p.spec["metadata"]["labels"].get(k) == v
                for k, v in selector.items()
            )
        )

    # ---- real-entrypoint execution ---------------------------------------

    def boot_pod(self, pod: FakePod, scratch_dir: str) -> int:
        """Run the pod's real container entrypoint against a scratch root.

        Projects the referenced Secrets to their mount paths (what kubelet
        does) and maps each PVC mount onto a persistent per-PVC directory
        under ``state_root`` — the same directory across pod generations,
        which is what makes the PVC a PVC.
        """
        from kvedge_torch.bootstrap.commands import rebase
        from kvedge_torch.bootstrap.entrypoint import main as entrypoint_main

        if self.state_root is None:
            raise FakeClusterError("state_root required for boot_pod")
        if pod.phase != "Running":
            raise FakeClusterError(f"pod {pod.name} is {pod.phase}, not Running")
        spec = pod.spec["spec"]
        container = spec["containers"][0]
        secret_by_vol = {
            v["name"]: v["secret"]["secretName"]
            for v in spec.get("volumes", []) if "secret" in v
        }
        pvc_by_vol = {
            v["name"]: v["persistentVolumeClaim"]["claimName"]
            for v in spec.get("volumes", []) if "persistentVolumeClaim" in v
        }
        for vm in container.get("volumeMounts", []):
            target = rebase(vm["mountPath"], scratch_dir)
            if vm["name"] in secret_by_vol:
                os.makedirs(target, exist_ok=True)
                secret = self.secrets[secret_by_vol[vm["name"]]]
                for key, b64 in secret.get("data", {}).items():
                    with open(os.path.join(target, key), "wb") as fh:
                        fh.write(base64.b64decode(b64))
            elif vm["name"] in pvc_by_vol:
                backing = os.path.join(
                    self.state_root, pvc_by_vol[vm["name"]]
                )
                os.makedirs(backing, exist_ok=True)
                os.makedirs(os.path.dirname(target), exist_ok=True)
                if not os.path.islink(target):
                    os.symlink(backing, target)
        command = container["command"]
        if command and command[0].endswith("/kvedge-init"):
            # The pod command wraps the entrypoint with the native PID-1
            # supervisor (native/kvedge-init.cc). The fake cluster boots
            # pods in-process, so it unwraps to the supervised child — but
            # first records a supervisor-start event to the rebased events
            # path, preserving the observable contract that a booted pod's
            # /status carries init_events from its state volume.
            if "--" not in command:
                raise FakeClusterError(
                    f"kvedge-init command without '--': {command}"
                )
            sep = command.index("--")
            wrapper, command = command[1:sep], command[sep + 1:]
            if "--events" in wrapper:
                events_path = rebase(
                    wrapper[wrapper.index("--events") + 1], scratch_dir
                )
                os.makedirs(os.path.dirname(events_path), exist_ok=True)
                with open(events_path, "a", encoding="utf-8") as fh:
                    fh.write(
                        json.dumps({
                            "ts": time.time(),
                            "event": "supervisor-start",
                            "fake": True,
                            "pod": pod.name,
                        }) + "\n"
                    )
        if command[:3] != ["python", "-m", "kvedge_torch.bootstrap.entrypoint"]:
            raise FakeClusterError(f"unexpected container command {command}")
        boot_config = command[command.index("--boot-config") + 1]
        boot_path = rebase(boot_config, scratch_dir)
        # Tests must not block in the heartbeat loop, and have no GPU: run
        # the boot sequence with --once --device cpu on the final runcmd
        # (a rendered pod names no device and runs on its GPU).
        with open(boot_path, "r", encoding="utf-8") as fh:
            doc = fh.read()
        patched = doc.replace("kvedge-runtime boot ",
                              "kvedge-runtime boot --once --device cpu ")
        if patched == doc:
            raise FakeClusterError(
                "rendered runcmd wording changed; --once --device cpu "
                "patch did not apply"
            )
        with open(boot_path, "w", encoding="utf-8") as fh:
            fh.write(patched)
        return entrypoint_main(
            ["--boot-config", boot_path, "--root", scratch_dir]
        )
