"""The port's GPU deployment on the CPU: the CLI's ``render``, ``notes``,
``version`` and ``package``; the fake cluster and ``FaultSchedule`` over
the port's manifests; a node kill whose next pod generation boots the
real ``kvedge_torch`` entrypoint (``--device cpu``) on the same PVC
backing, with ``boot_count`` 1 -> 2 and a port-written prefix registry
re-pinned by both generations; and the GPU image file against the tree
and the render.
"""

import dataclasses
import json
import pathlib
import re
import shutil
import socket
import tarfile

import numpy as np
import pytest
import torch
import yaml

from kvedge_torch.cli import main
from kvedge_torch.config.values import DEFAULT_VALUES
from kvedge_torch.render import render_all, to_yaml
from kvedge_torch.render.manifests import RUNTIME_IMAGE
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.serve import ServeRuntime
from kvedge_torch.testing import (
    FakeCluster,
    FakeNode,
    FaultSchedule,
    InvariantViolation,
)
from kvedge_torch.testing.fakecluster import FakeClusterError

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GPU_LABEL = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
DEP = "kvedge-torch-runtime"


# ---- the CLI ---------------------------------------------------------------


def test_render_stdout_and_output_dir(tmp_path, capsys):
    config = tmp_path / "config.toml"
    config.write_text('[tpu]\nplatform = "gpu"\n[status]\nport = 9100\n')
    argv = ["--set", "publicSshKey=ssh-ed25519 K me@host", "--set-file",
            f"jaxRuntimeConfig={config}"]
    values = DEFAULT_VALUES.replace(publicSshKey="ssh-ed25519 K me@host",
                                    jaxRuntimeConfig=config.read_text())
    chart = render_all(values)
    assert main(["render", *argv]) == 0
    out = capsys.readouterr()
    docs = list(yaml.safe_load_all(out.out))
    assert docs == [doc for _, doc in chart.ordered()]
    assert chart.notes in out.err and ":9100/status" in out.err
    assert main(["render", *argv, "--output-dir", str(tmp_path / "o")]) == 0
    written = sorted(p.name for p in (tmp_path / "o").iterdir())
    assert written == sorted(chart.manifests)
    for name, doc in chart.manifests.items():
        assert (tmp_path / "o" / name).read_text() == to_yaml(doc)
    assert "wrote 6 manifests" in capsys.readouterr().err


def test_notes_version_and_errors(capsys):
    assert main(["notes", "--set", "nameOverride=edge-a"]) == 0
    assert capsys.readouterr().out == render_all(
        DEFAULT_VALUES.replace(nameOverride="edge-a")).notes
    assert main(["version"]) == 0
    assert capsys.readouterr().out == "kvedge-torch 0.1.0\n"
    assert main(["render", "--set", "tpuNumHosts=2"]) == 1
    assert ("tpuNumHosts=2 but the runtime config declares [distributed] "
            "num_processes=1") in capsys.readouterr().err
    assert main(["notes", "--set", "nope=1"]) == 1
    assert "unknown value 'nope'" in capsys.readouterr().err


def test_package_is_reproducible_and_honours_helmignore(tmp_path, capsys):
    assert main(["package", "--out-dir", str(tmp_path)]) == 0
    out = tmp_path / "kvedge-torch-0.1.0.tgz"
    with tarfile.open(out) as tar:
        names = tar.getnames()
        chart_yaml = tar.extractfile("kvedge-torch/Chart.yaml").read()
    assert chart_yaml == (REPO / "deployment/gpu/helm/Chart.yaml").read_bytes()
    assert "kvedge-torch/templates/torch-gpu-runtime.yaml" in names
    assert "kvedge-torch/values.yaml" in names
    assert "kvedge-torch/.helmignore" in names
    assert not any("prepopulated" in n for n in names)
    first = out.read_bytes()
    assert main(["package", "--out-dir", str(tmp_path)]) == 0
    assert out.read_bytes() == first
    # A copy of the chart with files .helmignore names: they stay out.
    chart = tmp_path / "chart"
    shutil.copytree(REPO / "deployment/gpu/helm", chart)
    (chart / "values.yaml.bak").write_text("x")
    (chart / ".vscode").mkdir()
    (chart / ".vscode" / "settings.json").write_text("{}")
    assert main(["package", "--chart-dir", str(chart), "--out-dir",
                 str(tmp_path / "copy")]) == 0
    copy = (tmp_path / "copy" / "kvedge-torch-0.1.0.tgz").read_bytes()
    assert copy == first
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["package", "--chart-dir", str(empty)]) == 1
    assert "Chart.yaml" in capsys.readouterr().err


# ---- the fake cluster and its fault schedules -----------------------------


def _cluster(tmp_path=None, n_nodes=3, cpu_node=False, **kwargs):
    nodes = [FakeNode(f"gpu-node-{i}", labels=dict(GPU_LABEL))
             for i in range(1, n_nodes + 1)]
    if cpu_node:
        nodes.insert(0, FakeNode("cpu-node-1"))
    state_root = str(tmp_path / "pvc-backing") if tmp_path else None
    return FakeCluster(nodes, state_root=state_root, **kwargs)


def test_install_schedules_onto_a_gpu_node():
    cluster = _cluster(cpu_node=True)
    cluster.apply(render_all(DEFAULT_VALUES).manifests)
    cluster.converge()
    pod = cluster.running_pod(DEP)
    assert pod is not None and pod.node.startswith("gpu-node-")
    assert cluster.pvcs[f"{DEP}-dv"].bound_node == pod.node
    assert cluster.service_endpoints(f"{DEP}-ssh-service") == [pod.name]
    assert f"{DEP}-healthz-test" in cluster.hooks


def test_no_gpu_node_leaves_the_pod_pending_with_a_reason():
    cluster = FakeCluster([FakeNode("cpu-only"), FakeNode(
        "other-gpu", labels={"nvidia.com/gpu.product": "Tesla-T4"})])
    cluster.apply(render_all(DEFAULT_VALUES).manifests)
    cluster.converge()
    assert cluster.running_pod(DEP) is None
    (pending,) = cluster.pending_pods(DEP)
    assert "nodeSelector" in pending.reason


def test_missing_secret_duplicate_pvc_and_unsupported_kinds():
    cluster = _cluster()
    manifests = dict(render_all(DEFAULT_VALUES).manifests)
    del manifests["torch-gpu-boot-config-secret.yaml"]
    cluster.apply(manifests)
    with pytest.raises(FakeClusterError, match="missing Secret"):
        cluster.converge()
    with pytest.raises(FakeClusterError, match="already exists"):
        _cluster().apply(
            render_all(DEFAULT_VALUES, include_dead=True).manifests)
    with pytest.raises(FakeClusterError, match="unsupported kind"):
        _cluster().apply([{"kind": "DaemonSet",
                           "metadata": {"name": "x"}}])


def test_ssh_gate_and_reapply_as_an_upgrade():
    cluster = _cluster()
    cluster.apply(render_all(DEFAULT_VALUES.replace(
        tpuRuntimeEnableExternalSsh=False)).manifests)
    cluster.converge()
    assert f"{DEP}-ssh-service" not in cluster.services
    assert not cluster.hooks
    pod = cluster.running_pod(DEP)
    cluster.apply(render_all(DEFAULT_VALUES).manifests)
    cluster.converge()
    assert cluster.pvcs[f"{DEP}-dv"].bound_node == pod.node
    assert cluster.running_pod(DEP) is pod


@pytest.mark.parametrize("resilient", [False, True],
                         ids=["node-bound", "resilient"])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_schedules_hold_their_invariants(tmp_path, seed, resilient):
    cluster = _cluster(tmp_path, resilient_storage=resilient)
    cluster.apply(render_all(DEFAULT_VALUES).manifests)
    result = FaultSchedule(cluster, DEP, seed=seed).run(40)
    assert result.kills > 0
    if resilient:
        assert cluster.running_pod(DEP) is not None


def test_the_harness_catches_a_seeded_bug_and_replays(tmp_path):
    cluster = _cluster(tmp_path)
    cluster.apply(render_all(DEFAULT_VALUES).manifests)
    cluster.converge()
    pod = cluster.running_pod(DEP)
    clone = dataclasses.replace(pod, name=pod.name + "-evil")
    cluster.pods[clone.name] = clone
    with pytest.raises(InvariantViolation, match="single-writer"):
        FaultSchedule(cluster, DEP, seed=0).run(1)
    traces = []
    for _ in range(2):
        cluster = _cluster(tmp_path)
        cluster.apply(render_all(DEFAULT_VALUES).manifests)
        traces.append(FaultSchedule(cluster, DEP, seed=42).run(30).trace)
    assert traces[0] == traces[1]


# ---- real boots across a node kill ----------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_toml(port) -> str:
    """The serve payload at a tiny width, its state on the chart's PVC
    mount (a concrete status port: the manifests expose it)."""
    return (
        '[runtime]\nname = "deploy-edge"\n'
        'state_dir = "/var/lib/kvedge/state"\n'
        '[tpu]\nplatform = "cpu"\n'
        '[model]\npreset = "probe"\nn_layers = 1\n'
        '[payload]\nkind = "serve"\nserving = "paged"\nseq = 64\n'
        "serving_slots = 2\nserving_page_size = 4\n"
        "serving_prefill_chunk = 8\n"
        f'[status]\nport = {port}\nbind = "127.0.0.1"\n')


def _registry(backing: pathlib.Path) -> set:
    """The token paths of the prefix registry dumped on the backing."""
    with np.load(backing / "prefix-cache.npz") as data:
        doc = json.loads(bytes(data["doc"]).decode())
    return {tuple(e["tokens"]) for e in doc["entries"]}


def _seed_registry(backing: pathlib.Path, toml: str) -> set:
    """Write a ``prefix-cache.npz`` into the PVC backing as the port's
    serve payload does at close (same config, same dtype), without a
    heartbeat; returns its token paths."""
    cfg = dataclasses.replace(ServeConfig.parse(toml),
                              state_dir=str(backing), status_port=0)
    rt = ServeRuntime(cfg, device="cpu", dtype="bfloat16")
    try:
        rt.serve_fn({"tokens": [[7, 3, 9, 1, 5, 5, 2, 8, 11, 12]],
                     "n_new": 4})
    finally:
        rt.close()
    assert not (backing / "heartbeat.json").exists()
    return _registry(backing)


def test_node_kill_reboots_the_real_entrypoint_on_the_same_pvc(
        tmp_path, capsys):
    toml = _serve_toml(_free_port())
    chart = render_all(DEFAULT_VALUES.replace(jaxRuntimeConfig=toml))
    claim = chart.manifests["torch-gpu-state-volume.yaml"]["metadata"]["name"]
    backing = tmp_path / "pvc-backing" / claim
    backing.mkdir(parents=True)
    seeded = _seed_registry(backing, toml)
    assert seeded
    cluster = _cluster(tmp_path, n_nodes=2, resilient_storage=True)
    cluster.apply(chart.manifests)
    cluster.converge()
    first = cluster.running_pod(DEP)
    capsys.readouterr()
    assert cluster.boot_pod(first, str(tmp_path / "gen1")) == 0
    out = capsys.readouterr().out
    assert "payload=serve ok=True" in out and "boot_count=1" in out
    assert f"re-pinned {len(seeded)} prefix-cache entries" in out
    beat = json.loads((backing / "heartbeat.json").read_text())
    assert beat["boot_count"] == 1 and beat["check"]["platform"] == "cpu"
    # Its shutdown dumped the registry back: the seeded entries, and the
    # boot probe's.
    kept = _registry(backing)
    assert seeded <= kept

    cluster.kill_node(first.node)
    cluster.converge()
    second = cluster.running_pod(DEP)
    assert second is not None and second.node != first.node
    assert cluster.boot_pod(second, str(tmp_path / "gen2")) == 0
    out = capsys.readouterr().out
    assert "boot_count=2" in out
    assert f"re-pinned {len(kept)} prefix-cache entries" in out
    beat = json.loads((backing / "heartbeat.json").read_text())
    assert beat["boot_count"] == 2 and beat["ok"]
    # kvedge-init's events, recorded by each boot on the same volume.
    events = (backing / "init-events.jsonl").read_text().splitlines()
    assert [json.loads(e)["pod"] for e in events] == [first.name,
                                                      second.name]
    # The pod's document ran the port's runtime boot, on the CPU only
    # because the fake cluster asked for it.
    doc = (tmp_path / "gen2" / "mnt" / "boot-secret" / "userdata").read_text()
    assert "kvedge-runtime boot --once --device cpu --config" in doc


def test_a_schedule_with_real_boots_tracks_boot_count(tmp_path):
    toml = ('[runtime]\nname = "faults-edge"\n[tpu]\nplatform = "cpu"\n'
            f'[status]\nport = {_free_port()}\nbind = "127.0.0.1"\n')
    cluster = _cluster(tmp_path, n_nodes=2, resilient_storage=True)
    cluster.apply(render_all(
        DEFAULT_VALUES.replace(jaxRuntimeConfig=toml)).manifests)
    result = FaultSchedule(cluster, DEP, seed=7,
                           boot_root=str(tmp_path / "boots")).run(6)
    assert result.boots >= 2 and result.reschedules >= 1


def test_boot_pod_refuses_other_commands(tmp_path):
    cluster = _cluster(tmp_path)
    manifests = render_all(DEFAULT_VALUES).manifests
    dep = manifests["torch-gpu-runtime.yaml"]
    ctr = dep["spec"]["template"]["spec"]["containers"][0]
    ctr["command"] = [c.replace("kvedge_torch.", "kvedge_tpu.")
                      for c in ctr["command"]]
    cluster.apply(manifests)
    cluster.converge()
    with pytest.raises(FakeClusterError, match="unexpected container"):
        cluster.boot_pod(cluster.running_pod(DEP), str(tmp_path / "x"))


# ---- the GPU image file ----------------------------------------------------

DOCKERFILE = REPO / "deployment" / "gpu" / "Dockerfile"


def _instructions():
    """(instruction, argument) pairs of the Dockerfile, continuation
    lines joined and comments dropped."""
    text = re.sub(r"\\\n", " ", DOCKERFILE.read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def test_dockerfile_sources_entrypoint_and_tag():
    steps = _instructions()
    copies = [arg.split() for word, arg in steps if word == "COPY"]
    local = [c for c in copies if not c[0].startswith("--from")]
    assert {c[0] for c in local} == {"native", "kvedge_torch"}
    for src, _ in local:
        assert (REPO / src).exists(), src
    assert (REPO / "native" / "kvedge-init.cc").exists()
    assert (REPO / "kvedge_torch" / "ops" / "csrc").is_dir()
    (entry,) = [json.loads(arg) for word, arg in steps
                if word == "ENTRYPOINT"]
    rendered = render_all(DEFAULT_VALUES).manifests["torch-gpu-runtime.yaml"]
    command = rendered["spec"]["template"]["spec"]["containers"][0]["command"]
    assert entry == command
    module = entry[entry.index("-m") + 1]
    assert (REPO / (module.replace(".", "/") + ".py")).is_file()
    (tag,) = re.findall(r"docker build -f deployment/gpu/Dockerfile -t (\S+)",
                        DOCKERFILE.read_text())
    assert tag == RUNTIME_IMAGE
    # Every kernel source is built into the image.
    (build,) = [arg for word, arg in steps
                if word == "RUN" and "_build.build" in arg]
    sources = {p.stem for p in (REPO / "kvedge_torch/ops/csrc").glob("*.cu")}
    assert set(re.findall(r"'(\w+)'", build)) == sources
    # Both stages on one CUDA-devel base (nvcc for the kernels, and the
    # supervisor linked against the runtime's own libc); no JAX in it.
    (base,) = [arg for word, arg in steps if word == "ARG"]
    assert base.startswith("BASE=") and base.endswith("-devel")
    assert [arg for word, arg in steps if word == "FROM"] == [
        "${BASE} AS native-build", "${BASE}"]
    assert "jax" not in DOCKERFILE.read_text().lower()


# ---- the multi-host StatefulSet (tests/test_resilience.py's cases) -------
#
# Stable ordinal pods, per-ordinal claims from the claim templates, the
# coordinator pod's death, a follower's death with a node-bound claim, and
# real entrypoint boots that keep each ordinal's boot_count on its own
# volume. A world cannot form inside one test process, so the join is
# stubbed here; the real joins are tests/test_torch_slice_world.py's.

STS = "kvedge-torch-runtime"


def _multihost_values():
    toml = ('[runtime]\nname = "resilience-slice"\n[tpu]\nplatform = "cpu"\n'
            "[distributed]\nnum_processes = 4\n"
            f'[status]\nport = {_free_port()}\nbind = "127.0.0.1"\n')
    return DEFAULT_VALUES.replace(tpuNumHosts=4, jaxRuntimeConfig=toml)


def _stub_join(monkeypatch):
    from kvedge_torch.parallel.distributed import DistributedState
    from kvedge_torch.runtime import boot as boot_mod

    monkeypatch.setattr(
        boot_mod, "maybe_initialize",
        lambda spec, **kw: DistributedState(
            active=True, num_processes=spec.num_processes, process_id=0,
            coordinator="stubbed:0"))


def test_statefulset_creates_ordinal_pods_with_own_claims(tmp_path):
    cluster = _cluster(tmp_path)
    cluster.apply(render_all(_multihost_values()).manifests)
    cluster.converge()
    pods = cluster.sts_pods(STS)
    assert [p.name for p in pods] == [f"{STS}-{i}" for i in range(4)]
    assert all(p.phase == "Running" for p in pods)
    for i in range(4):
        claim = f"statedisk-{STS}-{i}"
        assert cluster.pvcs[claim].bound_node is not None
    assert len(cluster.service_endpoints(f"{STS}-hosts")) == 4


def test_coordinator_pod_death_keeps_ordinal_state(tmp_path, monkeypatch):
    """The node of pod 0 (the coordinator) dies: the pod comes back under
    the same name on the same claim, its boot_count goes to 2, a
    follower's stays at 1."""
    _stub_join(monkeypatch)
    cluster = _cluster(tmp_path, resilient_storage=True)
    cluster.apply(render_all(_multihost_values()).manifests)
    cluster.converge()
    coord, follower = cluster.pods[f"{STS}-0"], cluster.pods[f"{STS}-1"]
    assert cluster.boot_pod(coord, str(tmp_path / "fs-coord-1")) == 0
    assert cluster.boot_pod(follower, str(tmp_path / "fs-follower-1")) == 0
    backing = tmp_path / "pvc-backing"

    def beat(i):
        return json.loads(
            (backing / f"statedisk-{STS}-{i}" / "heartbeat.json").read_text())

    assert beat(0)["boot_count"] == 1
    cluster.kill_node(coord.node)
    cluster.converge()
    coord2 = cluster.pods[f"{STS}-0"]
    assert coord2.generation == coord.generation + 1
    assert coord2.phase == "Running" and coord2.node != coord.node
    assert cluster.boot_pod(coord2, str(tmp_path / "fs-coord-2")) == 0
    assert beat(0)["boot_count"] == 2
    assert beat(1)["boot_count"] == 1


def test_follower_death_with_node_bound_claim_blocks_like_reference(
        tmp_path):
    """A follower's node-bound claim keeps its replacement Pending until
    the node returns; the pods on other nodes keep running."""
    cluster = _cluster(tmp_path)
    cluster.apply(render_all(_multihost_values()).manifests)
    cluster.converge()
    dead_node = cluster.pods[f"{STS}-2"].node
    survivors = [p.name for p in cluster.sts_pods(STS)
                 if p.node != dead_node]
    cluster.kill_node(dead_node)
    cluster.converge()
    replacement = cluster.pods[f"{STS}-2"]
    assert replacement.phase == "Pending"
    assert "bound to node" in replacement.reason
    for name in survivors:
        assert cluster.pods[name].phase == "Running"
    cluster.revive_node(dead_node)
    cluster.converge()
    assert cluster.pods[f"{STS}-2"].phase == "Running"
    assert cluster.pods[f"{STS}-2"].node == dead_node
