"""Several cards in one pod (``kvedge_torch/parallel/launch.py``): local
worlds of CPU ranks over gloo, held to the JAX package's runs of the
same TOMLs on conftest's 8 virtual CPU devices, at fp32 and small size.

* One pod, four cards (``KVEDGE_EXPECTED_CARDS=4``, ``[mesh] axes =
  { data = 0, model = 2 }``, no ``[distributed]``): ``start_runtime``
  starts three local ranks, trains two steps and writes one checkpoint,
  with ``/status`` reporting 4 devices on a [2, 2] mesh and one
  heartbeat. Its losses sit within the reference's 2e-4 of the JAX
  package's ``run_train_payload`` of the same TOML (data 4 x model 2
  there), started from the same numpy-seeded weights; then a paged
  ``serve`` booted on the same state dir serves greedy tokens equal to
  the JAX ``run_serve_payload``'s from that checkpoint (converted with
  ``tools/orbax_torch.py``).
* Two pods of two cards: one world of 4, global rank ``process_id x 2 +
  local_rank``; each pod's ``/status`` reports the world's mesh and the
  reference's ``DistributedState``.
* A local rank that exits before the join degrades the boot at once,
  naming its rank and code, and one that exits after it degrades the
  running runtime; no process is left.
* The pure parts: the layout's arithmetic, the cards a process on the
  CPU, the device binding, ``KVEDGE_EXPECTED_CARDS`` at boot and a mesh
  over more cards than are visible (``torch.cuda.device_count`` patched
  to 2 and 8), with the reference's messages.
"""

import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvedge_tpu.models.training as jtraining
from kvedge_tpu.config.runtime_config import MeshSpec as JaxMeshSpec
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.models import TransformerConfig as JaxTransformerConfig
from kvedge_tpu.parallel.distributed import DistributedState as JaxState
from kvedge_tpu.runtime.workload import run_serve_payload, run_train_payload
from kvedge_torch.data.feeder import write_corpus
from kvedge_torch.models.transformer import init_params
from kvedge_torch.parallel import distributed, launch
from kvedge_torch.runtime import boot
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.runtime.config import fewest_cards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[5, 9, 2, 7, 1], [11, 12, 13, 14, 15, 16, 17, 18, 19]]
N_NEW = 6

# Boots each TOML of argv through start_runtime on the CPU at fp32, as a
# pod's process does, and prints what /status, the payload, the served
# requests and the local ranks showed.
_POD = textwrap.dedent("""
    import json, os, sys, urllib.request
    import torch
    torch.set_num_threads(1)
    from kvedge_torch.runtime import heartbeat
    from kvedge_torch.runtime.boot import start_runtime
    from kvedge_torch.runtime.config import RuntimeConfig

    prompts, n_new = json.loads(sys.argv[1])
    docs = []
    for path in sys.argv[2:]:
        cfg = RuntimeConfig.parse(open(path).read())
        handle = start_runtime(cfg, device="cpu", dtype="float32")
        base = f"http://127.0.0.1:{handle.status_port}"
        with urllib.request.urlopen(base + "/status", timeout=60) as r:
            status = json.loads(r.read())
        doc = {"ok": handle.check.ok, "error": handle.check.error,
               "status": status,
               "losses": getattr(handle.result, "losses", None),
               "heartbeat": heartbeat.read_heartbeat(cfg.state_dir)}
        if cfg.payload == "serve" and handle.check.ok:
            doc["tokens"] = []
            for p in prompts:
                req = urllib.request.Request(
                    base + "/generate", data=json.dumps(
                        {"tokens": [p], "n_new": n_new}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = json.loads(r.read())
                doc["tokens"].append(out["tokens"][0])
                doc["restored_step"] = out["restored_step"]
        local = handle.local
        handle.shutdown()
        doc["rank_codes"] = ([p.returncode for p in local.ranks.procs]
                             if local is not None else None)
        docs.append(doc)
    print("POD " + json.dumps(docs), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toml(state_dir, corpus, kind, axes="{ data = 0, model = 2 }",
          extra=""):
    return (
        "[runtime]\n"
        f'state_dir = "{state_dir}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[mesh]\n"
        f"axes = {axes}\n"
        + extra +
        "[model]\n"
        "vocab = 128\nd_model = 32\nn_heads = 4\nn_kv_heads = 2\n"
        "n_layers = 2\nd_ff = 64\n"
        "[status]\n"
        "port = 0\n"
        'bind = "127.0.0.1"\n'
        "[payload]\n"
        f'kind = "{kind}"\n'
        'serving = "paged"\n'
        "seq = 64\n"
        "serving_slots = 3\n"
        "serving_page_size = 4\n"
        "serving_window = 4\n"
        "serving_prefix_persist = false\n"
        f'corpus = "{corpus}"\n'
        "steps = 2\nbatch = 8\ncheckpoint_every = 2\n"
    )


def _spawn_pod(tmp, paths, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", _POD, json.dumps([PROMPTS, N_NEW]),
         *map(str, paths)],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)


def _pod_docs(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("POD ")]
    assert line, (out[-2000:], err[-4000:])
    return json.loads(line[0][4:])


def _orbax_tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_torch", os.path.join(REPO, "tools", "orbax_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pod_of_four(tmp_path_factory):
    """The port's pod of four CPU ranks, trained then served (in a
    process of its own, while the JAX package trains the same TOML
    here), and the JAX package's serve of the port's checkpoint."""
    tmp = tmp_path_factory.mktemp("pod4")
    corpus = tmp / "corpus.kvfeed"
    write_corpus(corpus, np.random.default_rng(3).integers(
        0, 128, size=4000, dtype=np.int32))
    paths = []
    for kind in ("train", "serve"):
        paths.append(tmp / f"{kind}.toml")
        paths[-1].write_text(_toml(tmp / "pod", corpus, kind))
    start = time.monotonic()
    proc = _spawn_pod(tmp, paths, {launch.CARDS_ENV: "4"})
    try:
        jax_text = _toml(tmp / "jax", corpus, "train")
        tcfg = RuntimeConfig.parse(jax_text).model_config("float32", "cpu")
        with pytest.MonkeyPatch.context() as mp:
            # The reference at fp32, from the port's numpy-seeded weights.
            mp.setattr(JaxTransformerConfig, "dtype", "float32")
            mp.setattr(jtraining, "init_params", lambda key, cfg: {
                k: jnp.asarray(v) for k, v in init_params(0, tcfg).items()})
            jax_train = run_train_payload(JaxConfig.parse(jax_text))
            docs = _pod_docs(proc)
            serve_text = _toml(tmp / "jax-serve", corpus, "serve")
            assert _orbax_tool().torch_to_orbax(
                serve_text, str(tmp / "pod" / "checkpoints"),
                str(tmp / "jax-serve" / "checkpoints")) == 2
            check, serve_fn = run_serve_payload(JaxConfig.parse(serve_text))
            assert check.ok, check.error
            try:
                jax_tokens = [serve_fn({"tokens": [p], "n_new": N_NEW})[
                    "tokens"][0] for p in PROMPTS]
            finally:
                serve_fn.close()
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"tmp": tmp, "train": docs[0], "serve": docs[1],
            "jax_train": jax_train, "jax_tokens": jax_tokens,
            "seconds": time.monotonic() - start}


def test_one_pod_of_four_cards_trains_as_the_jax_package(pod_of_four):
    doc, jax_train = pod_of_four["train"], pod_of_four["jax_train"]
    assert doc["ok"], doc["error"]
    assert jax_train.ok, jax_train.error
    assert tuple(jax_train.mesh_shape) == (4, 2)
    assert len(doc["losses"]) == 2
    assert abs(doc["losses"][-1] - jax_train.probe_checksum) < 2e-4
    check = doc["status"]["check"]
    assert (check["device_count"], check["mesh_shape"]) == (4, [2, 2])
    assert check["mesh_axes"] == ["data", "model"]
    assert doc["status"]["distributed"]["active"] is True
    assert doc["status"]["distributed"]["num_processes"] == 1
    # One checkpoint, written by global rank 0 into the pod's state dir
    # (no checkpoint_dir: the local ranks share it).
    pod = pod_of_four["tmp"] / "pod"
    assert sorted(os.listdir(pod / "checkpoints")) == ["2"]
    assert json.loads((pod / "train-progress.json").read_text())["step"] == 2
    # Only local rank 0 beats: one writer, this boot's count.
    assert doc["heartbeat"]["boot_count"] == 1
    assert [n for n in os.listdir(pod) if "heartbeat" in n] == [
        "heartbeat.json"]
    assert doc["rank_codes"] == [0, 0, 0]
    for k in (1, 2, 3):
        log = (pod / launch.LOCAL_DIR / f"rank{k}.log").read_text()
        assert f"local rank {k}: global rank {k} of 4 on cpu" in log


def test_the_pod_serves_its_checkpoint_as_the_jax_package(pod_of_four):
    """The counterpart of ``tests/test_serve.py``'s
    ``test_tp_mesh_checkpoint_serves_sharded``: the paged slice over the
    pod's four ranks against the reference's paged serve of the same
    checkpoint on its [4, 2] mesh."""
    doc = pod_of_four["serve"]
    assert doc["ok"], doc["error"]
    assert doc["restored_step"] == 2
    assert doc["tokens"] == pod_of_four["jax_tokens"]
    assert doc["status"]["serving"]["backend"] == "multihost-paged"
    assert doc["heartbeat"]["boot_count"] == 2
    # The followers left at the leader's STOP.
    assert doc["rank_codes"] == [0, 0, 0]


def test_two_pods_of_two_cards_form_one_world(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        path = tmp_path / f"pod{pid}.toml"
        path.write_text(_toml(
            tmp_path / f"pvc-{pid}", tmp_path / "none", "devicecheck",
            axes="{ data = 2, model = 2 }",
            extra=("[distributed]\nnum_processes = 2\n"
                   f'coordinator_address = "127.0.0.1:{port}"\n'
                   f"process_id = {pid}\n")))
        procs.append(_spawn_pod(tmp_path, [path]))
    docs = [_pod_docs(p, timeout=120)[0] for p in procs]
    for pid, doc in enumerate(docs):
        assert doc["ok"], doc["error"]
        assert doc["status"]["distributed"] == JaxState(
            active=True, num_processes=2, process_id=pid,
            coordinator=f"127.0.0.1:{port}").to_dict()
        check = doc["status"]["check"]
        assert (check["device_count"], check["mesh_shape"]) == (4, [2, 2])
        assert doc["rank_codes"] == [0]
        log = (tmp_path / f"pvc-{pid}" / launch.LOCAL_DIR /
               "rank1.log").read_text()
        assert f"local rank 1: global rank {pid * 2 + 1} of 4 on cpu" in log


def _healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cpu_cfg(tmp_path, **kw):
    return RuntimeConfig(name="pod", state_dir=str(tmp_path / "state"),
                         expected_platform="cpu", status_port=0,
                         status_bind="127.0.0.1", **kw)


@pytest.fixture
def spawned(monkeypatch):
    """Every local-rank set the launcher starts."""
    made = []

    class Recorded(launch.Ranks):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(launch, "Ranks", Recorded)
    return made


def test_a_local_rank_that_dies_before_the_join_degrades_the_boot(
        tmp_path, monkeypatch, spawned):
    """Its exit code 7 fails the join within a poll, not after the join's
    timeout: the reason names local rank 1 and the code, /healthz is
    503, and no process is left."""
    monkeypatch.setattr(distributed, "JOIN_TIMEOUT_S", 3.0)
    monkeypatch.setattr(launch, "child_command", lambda *a: [
        sys.executable, "-c", "import sys; print('dying'); sys.exit(7)"])
    start = time.monotonic()
    handle = boot.start_runtime(
        _cpu_cfg(tmp_path, mesh_axes=(("data", 2),)), device="cpu")
    try:
        assert time.monotonic() - start < 20
        assert not handle.check.ok
        assert handle.check.error.startswith(
            "local rank 1 (global rank 1) exited with code 7: dying")
        assert _healthz(handle.status_port) == (
            503, {"status": "degraded", "reason": handle.check.error})
        assert handle.local is None and not handle.distributed.active
    finally:
        handle.shutdown()
    assert len(spawned) == 1
    assert all(p.poll() is not None for p in spawned[0].procs)


def test_a_local_rank_that_dies_after_the_join_degrades_the_runtime(
        tmp_path, monkeypatch, spawned):
    """A rank that joined and ran its payload, then exited 7: the parent's
    watch turns /healthz to 503 naming it; shutdown reaps it."""
    real = launch.child_command

    def exits_7(*a):
        return real(*a)[:1] + [
            "-c", "import sys; from kvedge_torch.parallel.launch import "
            "main; main(sys.argv[1:]); sys.exit(7)"] + real(*a)[3:]

    monkeypatch.setattr(launch, "child_command", exits_7)
    handle = boot.start_runtime(
        _cpu_cfg(tmp_path, mesh_axes=(("data", 2),)), device="cpu")
    try:
        deadline = time.monotonic() + 20
        while handle.check.ok and time.monotonic() < deadline:
            time.sleep(0.05)
        assert handle.distributed.active
        assert handle.check.error.startswith(
            "local rank 1 (global rank 1) exited with code 7: ")
        assert "payload 'devicecheck' ok=True" in handle.check.error
        assert _healthz(handle.status_port)[0] == 503
    finally:
        handle.shutdown()
    assert all(p.poll() is not None for p in spawned[0].procs)


# ---- the pure parts ------------------------------------------------------


@pytest.mark.parametrize("num_processes,process_id,cards", [
    (1, 0, 4), (2, 1, 2), (4, 3, 8)])
def test_the_layout_places_a_rank_a_card(num_processes, process_id, cards):
    layout = distributed.WorldLayout(num_processes, process_id, cards,
                                     "file:///x")
    assert layout.world_size == num_processes * cards
    assert [layout.rank(k) for k in range(cards)] == list(range(
        process_id * cards, (process_id + 1) * cards))
    with pytest.raises(ValueError, match="local rank"):
        layout.rank(cards)
    assert layout.state().to_dict().keys() == JaxState(
        active=True).to_dict().keys()
    assert distributed.WorldLayout(1, 0, 1, "").state() == \
        distributed.DistributedState(active=False)


def test_resolve_layout_meets_on_a_file_in_one_pod_and_tcp_across():
    spec = RuntimeConfig().distributed
    one = distributed.resolve_layout(spec, 4, {}, "x", "/s/local-world")
    assert one == distributed.WorldLayout(
        1, 0, 4, "file:///s/local-world/store")
    two = distributed.resolve_layout(
        dataclasses.replace(spec, num_processes=2),
        2, {"KVEDGE_COORDINATOR": "c0:9", "KVEDGE_PROCESS_ID": "1"}, "x")
    assert two == distributed.WorldLayout(2, 1, 2, "c0:9")


@pytest.mark.parametrize("axes,num_processes,cards", [
    ((("data", 0), ("model", 1)), 1, 1),
    ((("data", 0), ("model", 2)), 1, 2),
    ((("data", 2), ("model", 2)), 1, 4),
    ((("data", 2), ("model", 2)), 2, 2),
    ((("data", 0), ("seq", 2)), 4, 1),
    ((("data", 0), ("model", 3)), 2, 3),
    ((("data", 4),), 4, 1)])
def test_the_cards_a_process_on_the_cpu(axes, num_processes, cards):
    """The fixed product over the processes (an axis of 0 as 1) where it
    divides, else the least count the mesh resolves on; the chart's
    ``KVEDGE_EXPECTED_CARDS`` when set."""
    assert fewest_cards(axes, num_processes) == cards
    JaxMeshSpec(axes=axes).resolved_shape(num_processes * cards)
    cfg = RuntimeConfig(mesh_axes=axes, num_processes=num_processes)
    assert launch.visible_cards(cfg, "cpu", {}) == cards
    assert launch.visible_cards(cfg, "cpu", {launch.CARDS_ENV: "8"}) == 8
    with pytest.raises(RuntimeConfigError, match="is not an integer"):
        launch.visible_cards(cfg, "cpu", {launch.CARDS_ENV: "four"})
    with pytest.raises(RuntimeConfigError, match="cannot hold"):
        fewest_cards((("data", 3),), 2)


def test_a_local_rank_is_bound_to_its_card(monkeypatch):
    assert distributed.local_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for k in (0, 1, 7):
        assert distributed.local_device(None, k) == torch.device("cuda", k)
        assert distributed.local_device("cuda", k) == torch.device("cuda",
                                                                   k)


@pytest.fixture(params=[2, 8])
def cards_seen(request, monkeypatch):
    """A card count the CUDA runtime reports, with no card to run on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: request.param)
    return request.param


def test_the_chart_cards_are_held_to_the_cards_seen(monkeypatch, cards_seen):
    cfg = RuntimeConfig()
    assert boot._topology_mismatch(cfg, "cuda") == ""
    monkeypatch.setenv(launch.CARDS_ENV, str(cards_seen))
    assert boot._topology_mismatch(cfg, "cuda") == ""
    monkeypatch.setenv(launch.CARDS_ENV, "4")
    assert boot._topology_mismatch(cfg, "cuda") == (
        "topology mismatch: the chart was rendered for 4 cards a host "
        f"(KVEDGE_EXPECTED_CARDS) but this pod sees {cards_seen}; fix "
        "gpusPerHost or the pod's cards")
    monkeypatch.setenv(launch.CARDS_ENV, "four")
    assert boot._topology_mismatch(cfg, "cuda") == (
        "KVEDGE_EXPECTED_CARDS='four' is not an integer")
    # On the CPU the chart's count is the count.
    monkeypatch.setenv(launch.CARDS_ENV, "4")
    assert boot._topology_mismatch(cfg, "cpu") == ""


@pytest.mark.parametrize("axes", [(("data", 4),), (("data", 0), ("model", 3))],
                         ids=["data4", "model3"])
def test_a_mesh_over_other_cards_than_seen_degrades_with_no_rank(
        tmp_path, spawned, cards_seen, axes):
    """Resolved over the cards the pod sees, with the reference's
    "mesh resolution failed: ..." (its device check's words), before any
    local rank starts."""
    handle = boot.start_runtime(RuntimeConfig(
        state_dir=str(tmp_path), status_port=0, status_bind="127.0.0.1",
        mesh_axes=axes), device="cuda")
    try:
        with pytest.raises(ValueError) as want:
            JaxMeshSpec(axes=axes).resolved_shape(cards_seen)
        assert handle.check.error == f"mesh resolution failed: {want.value}"
        assert _healthz(handle.status_port) == (
            503, {"status": "degraded", "reason": handle.check.error})
    finally:
        handle.shutdown()
    assert spawned == [] and handle.local is None


def test_a_mesh_over_several_cards_parses_without_distributed():
    """The lifted refusal: the mesh waits for the cards boot finds; the
    reference parses the same TOML to the same axes."""
    text = "[mesh]\naxes = { data = 2, model = 2 }\n"
    cfg = RuntimeConfig.parse(text)
    assert cfg.mesh_axes == JaxConfig.parse(text).mesh.axes
    assert cfg.axis_sizes() == {"data": 2, "model": 2}
    assert cfg.check_world(4) == (2, 2)
    with pytest.raises(RuntimeConfigError, match="mesh resolution failed: "
                       r"mesh \{'data': 2, 'model': 2\} wants 4 devices, "
                       "have 1"):
        cfg.check_world(1)
    assert RuntimeConfig.parse(cfg.to_toml()) == cfg
    # An axis of 0 the parse resolves to 1 is refused at boot once the
    # cards make it 2.
    serve = RuntimeConfig.parse('[mesh]\naxes = { data = 1, seq = 0 }\n'
                                '[payload]\nkind = "serve"\n')
    assert serve.check_world(1) == (1, 1)
    with pytest.raises(RuntimeConfigError,
                       match="kind = 'serve' over a 'seq' axis of 2"):
        serve.check_world(2)
