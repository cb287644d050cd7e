"""Randomized fault injection for the fake cluster.

The port's copy of ``kvedge_tpu/testing/faults.py``, over the port's
fake cluster (whose pods boot the ``kvedge_torch`` entrypoint).

The reference has **no fault-injection tooling** (SURVEY.md §5); its
resilience story is verified by one manual end-to-end run. This harness is
the missing piece the build adds: a seeded random walk of node
kills/revivals driven against the rendered manifests, with the cluster's
resilience invariants checked after every event. Deterministic per seed —
a failing schedule replays exactly from its seed + trace.

Invariants enforced after every converge (derived from the reference's own
documented guarantees and failure modes):

* **Single-writer**: a single-replica Recreate deployment never has two
  Running pods (the property ``strategy: Recreate`` exists to provide —
  two concurrent writers would corrupt the state volume).
* **Node-bound storage honesty** (reference ``README.md:89``): once a PVC
  binds, a pod only ever runs on the bound node; when that node is dead the
  replacement stays Pending *with a stated reason* — degraded must be
  explained, not silent.
* **Resilient storage liveness** (reference ``README.md:88``): with
  detachable storage, whenever any schedulable node is alive the runtime
  converges back to Running.
* **State monotonicity**: each real boot of a pod generation increments the
  persisted heartbeat ``boot_count`` by exactly one and never loses
  heartbeat sequence — state survival is observed, not assumed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random

from kvedge_torch.testing.fakecluster import FakeCluster


class InvariantViolation(AssertionError):
    """An invariant failed; ``trace`` replays the schedule that broke it."""

    def __init__(self, message: str, trace: list[str]):
        super().__init__(
            message + "\nschedule trace:\n  " + "\n  ".join(trace)
        )
        self.trace = trace


@dataclasses.dataclass
class FaultScheduleResult:
    events: int
    kills: int
    revivals: int
    boots: int
    reschedules: int
    trace: list[str]


class FaultSchedule:
    """A seeded random walk of node failures against one deployment.

    ``boot_root`` enables real-entrypoint boots: whenever a converge leaves
    a *new* pod generation Running, the pod is actually booted against a
    fresh scratch filesystem (PVC backing persists inside the cluster's
    ``state_root``) and the persisted heartbeat is checked.
    """

    def __init__(self, cluster: FakeCluster, deployment: str, *,
                 seed: int, boot_root: str | None = None):
        self.cluster = cluster
        self.deployment = deployment
        self.rng = random.Random(seed)
        self.boot_root = boot_root
        self.trace: list[str] = []
        self.kills = 0
        self.revivals = 0
        self.boots = 0
        self.reschedules = 0
        self._booted_pods: set[str] = set()
        self._expected_boot_count = 0
        self._last_seq = 0
        self._last_running: str | None = None

    # ---- schedule -------------------------------------------------------

    def run(self, n_events: int) -> FaultScheduleResult:
        self.cluster.converge()
        self._check_invariants("initial converge")
        self._maybe_boot()
        for i in range(n_events):
            self._one_event(i)
        # End on a healed cluster so terminal liveness is always exercised.
        for node in list(self.cluster.nodes):
            if not self.cluster.nodes[node].alive:
                self._revive(node)
        self.cluster.converge()
        self._check_invariants("final heal")
        self._maybe_boot()
        return FaultScheduleResult(
            events=n_events, kills=self.kills, revivals=self.revivals,
            boots=self.boots, reschedules=self.reschedules, trace=self.trace,
        )

    def _one_event(self, i: int) -> None:
        alive = [n for n, node in self.cluster.nodes.items() if node.alive]
        dead = [n for n, node in self.cluster.nodes.items() if not node.alive]
        # Kill with p=0.5 when possible, else revive; always converge+check.
        if alive and (not dead or self.rng.random() < 0.5):
            victim = self.rng.choice(alive)
            self.cluster.kill_node(victim)
            self.kills += 1
            self.trace.append(f"[{i}] kill {victim}")
        elif dead:
            self._revive(self.rng.choice(dead), index=i)
        self.cluster.converge()
        self._check_invariants(self.trace[-1])
        self._maybe_boot()

    def _revive(self, node: str, index: int | None = None) -> None:
        self.cluster.revive_node(node)
        self.revivals += 1
        prefix = f"[{index}] " if index is not None else "[heal] "
        self.trace.append(f"{prefix}revive {node}")

    # ---- invariants -----------------------------------------------------

    def _fail(self, message: str, context: str) -> None:
        raise InvariantViolation(f"{message} (after {context})", self.trace)

    def _check_invariants(self, context: str) -> None:
        cluster, dep = self.cluster, self.deployment
        running = [
            p for p in cluster.pods.values()
            if p.owner == dep and p.phase == "Running"
        ]
        if len(running) > 1:
            self._fail(
                f"single-writer violated: {len(running)} Running pods "
                f"({[p.name for p in running]})", context,
            )

        for pod in running:
            if not cluster.nodes[pod.node].alive:
                self._fail(
                    f"pod {pod.name} Running on dead node {pod.node}", context
                )
            for pvc in cluster._pod_pvcs(pod):
                if (pvc.bound_node != pod.node
                        and not cluster.resilient_storage):
                    self._fail(
                        f"pod {pod.name} on {pod.node} but node-bound PVC "
                        f"{pvc.name} is bound to {pvc.bound_node}", context,
                    )

        for pod in cluster.pending_pods(dep):
            if not pod.reason:
                self._fail(
                    f"pod {pod.name} Pending without a stated reason", context
                )

        # Liveness: under resilient storage, any alive selector-matching
        # node must be enough to get back to Running.
        if cluster.resilient_storage and not running:
            alive = [n for n in cluster.nodes.values() if n.alive]
            schedulable = [
                n for n in alive
                if any(
                    self.cluster._schedulable_node(p)[0] == n.name
                    for p in cluster.pending_pods(dep)
                )
            ]
            if schedulable:
                self._fail(
                    "liveness violated: schedulable node(s) "
                    f"{[n.name for n in schedulable]} alive but no Running "
                    "pod after converge", context,
                )

        if running:
            pod = running[0]
            if pod.name != self._last_running:
                if self._last_running is not None:
                    self.reschedules += 1
                self._last_running = pod.name

    # ---- real boots -----------------------------------------------------

    def _maybe_boot(self) -> None:
        if self.boot_root is None:
            return
        pod = self.cluster.running_pod(self.deployment)
        if pod is None or pod.name in self._booted_pods:
            return
        scratch = os.path.join(self.boot_root, f"podfs-{pod.name}")
        rc = self.cluster.boot_pod(pod, scratch)
        if rc != 0:
            self._fail(f"entrypoint boot of {pod.name} exited {rc}",
                       f"boot {pod.name}")
        self._booted_pods.add(pod.name)
        self.boots += 1
        self._expected_boot_count += 1
        self.trace.append(f"[boot] {pod.name}")
        beat = self._read_heartbeat()
        if beat.get("boot_count") != self._expected_boot_count:
            self._fail(
                f"boot_count {beat.get('boot_count')} != expected "
                f"{self._expected_boot_count} — state loss or double-count",
                f"boot {pod.name}",
            )
        seq = beat.get("seq", 0)
        if seq <= self._last_seq:
            self._fail(
                f"heartbeat seq went backwards ({self._last_seq} -> {seq})",
                f"boot {pod.name}",
            )
        self._last_seq = seq

    def _read_heartbeat(self) -> dict:
        pod = self.cluster.running_pod(self.deployment)
        path = self.cluster.pod_state_path(pod, "heartbeat.json")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return json.load(fh)
        except FileNotFoundError:
            self._fail(f"no persisted heartbeat at {path}", f"boot {pod.name}")
