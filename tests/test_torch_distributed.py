"""Joining the world (``kvedge_torch/parallel/distributed.py``), the
``[distributed]`` and ``[mesh]`` config, the boot's join, and a killed
two-process training run, against the JAX package's
``tests/test_distributed.py``.

* The identity resolvers and the config parse and ``to_toml`` are held to
  the reference's functions case by case (results and messages).
* A boot whose join fails degrades with the reference's message; one
  whose identity cannot be resolved degrades with the resolver's; two
  booted processes join one world and report it in ``/status``.
* The device check, the transformer probe and the eval payload in a
  world of two ranks (``data``, ``model`` and ``seq`` meshes) equal the
  port in one process within 1e-5 at fp32, the one-process eval
  restoring the checkpoint a tensor-parallel world wrote.
* The model derived from the mesh and the feed geometry are the
  reference's, refusals and messages included.
* The reference's kill test, ported: a single-process train payload,
  then a 2-process one (``[distributed]`` through ``maybe_initialize``,
  gloo, a shared ``checkpoint_dir``) killed once the shared checkpoint
  holds step >= 4, then restarted. The two processes report the same
  final loss, and it equals the single run's within 1e-3 (the
  reference's tolerance: the layouts reduce in different orders).
"""

import dataclasses
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
import json

import numpy as np
import pytest

from kvedge_torch.parallel import distributed as ours
from kvedge_torch.runtime.config import DistributedSpec, RuntimeConfig
from kvedge_torch.runtime.config import RuntimeConfigError
from kvedge_tpu.config.runtime_config import DistributedSpec as JaxSpec
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.parallel import distributed as theirs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (spec fields, environ, hostname)
PROCESS_ID_CASES = {
    "explicit": (dict(num_processes=4, process_id=3), {"TPU_WORKER_ID": "1"},
                 "host-0"),
    "kvedge-env": (dict(num_processes=4), {"KVEDGE_PROCESS_ID": "2"}, "x"),
    "tpu-env": (dict(num_processes=4), {"TPU_WORKER_ID": "1"}, "x"),
    "both-env": (dict(num_processes=4),
                 {"KVEDGE_PROCESS_ID": "3", "TPU_WORKER_ID": "1"}, "x"),
    "hostname": (dict(num_processes=4), {}, "kvedge-tpu-runtime-2"),
    "unresolvable": (dict(num_processes=4), {}, "no-ordinal-here-x"),
    "out-of-range": (dict(num_processes=4), {"TPU_WORKER_ID": "7"}, "x"),
    "not-an-int": (dict(num_processes=4), {"TPU_WORKER_ID": "abc"}, "x"),
}
# (spec fields, environ)
COORDINATOR_CASES = {
    "explicit-port-default": (dict(num_processes=2,
                                   coordinator_address="c0",
                                   coordinator_port=9999), {}),
    "explicit-with-port": (dict(num_processes=2,
                                coordinator_address="c0:1234"), {}),
    "kvedge-env": (dict(num_processes=4), {"KVEDGE_COORDINATOR": "coord:1"}),
    "hostnames-env": (dict(num_processes=4),
                      {"TPU_WORKER_HOSTNAMES": "h0,h1,h2,h3"}),
    "unresolvable": (dict(num_processes=4), {}),
}
CONFIG_TEXTS = {
    "defaults": "",
    "full-section": ("[distributed]\nnum_processes = 4\n"
                     'coordinator_address = "worker-0.kvedge"\n'
                     "coordinator_port = 9000\nprocess_id = 2\n"),
    "two": '[distributed]\nnum_processes = 2\ncoordinator_address = "c:1"\n',
    "bad-zero": "[distributed]\nnum_processes = 0\n",
    "bad-pid": "[distributed]\nnum_processes = 2\nprocess_id = 2\n",
    "bad-port": "[distributed]\ncoordinator_port = 0\n",
}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # compare the message, whatever the class
        return ("error", str(e))


@pytest.mark.parametrize("name", PROCESS_ID_CASES)
def test_process_id_resolves_as_the_reference(name):
    fields, environ, hostname = PROCESS_ID_CASES[name]
    got = _outcome(ours.resolve_process_id, DistributedSpec(**fields),
                   environ, hostname)
    want = _outcome(theirs.resolve_process_id, JaxSpec(**fields), environ,
                    hostname)
    assert got == want


@pytest.mark.parametrize("name", COORDINATOR_CASES)
def test_coordinator_resolves_as_the_reference(name):
    fields, environ = COORDINATOR_CASES[name]
    got = _outcome(ours.resolve_coordinator, DistributedSpec(**fields),
                   environ)
    want = _outcome(theirs.resolve_coordinator, JaxSpec(**fields), environ)
    assert got == want


@pytest.mark.parametrize("name", CONFIG_TEXTS)
def test_distributed_section_parses_as_the_reference(name):
    text = CONFIG_TEXTS[name]
    try:
        want = JaxConfig.parse(text).distributed
    except Exception as e:
        with pytest.raises(RuntimeConfigError) as got:
            RuntimeConfig.parse(text)
        assert str(got.value) == str(e)
        return
    cfg = RuntimeConfig.parse(text)
    assert cfg.distributed.__dict__ == want.__dict__
    again = RuntimeConfig.parse(cfg.to_toml())
    assert again == cfg
    assert JaxConfig.parse(cfg.to_toml()).distributed == want


def test_single_process_is_a_noop():
    state = ours.maybe_initialize(DistributedSpec(), environ={},
                                  hostname="x")
    assert state == ours.DistributedState(active=False)
    assert state.to_dict() == theirs.DistributedState(active=False).to_dict()
    assert ours.world_size() == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _healthz(port):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _boot(tmp_path, **fields):
    from kvedge_torch.runtime.boot import start_runtime

    cfg = RuntimeConfig(name="mh", state_dir=str(tmp_path / "state"),
                        expected_platform="cpu", status_port=0,
                        status_bind="127.0.0.1", payload="devicecheck",
                        **fields)
    return start_runtime(cfg, device="cpu")


def test_a_boot_whose_join_fails_degrades(tmp_path, monkeypatch):
    """Nobody hosts the coordinator: the rendezvous times out and the
    runtime degrades with the reference's message, ``/status`` still
    answering and reporting no world."""
    monkeypatch.setattr(ours, "JOIN_TIMEOUT_S", 1.0)
    handle = _boot(tmp_path, num_processes=2, process_id=1,
                   coordinator_address=f"127.0.0.1:{_free_port()}")
    try:
        assert not handle.check.ok
        assert handle.check.error.startswith(
            "multi-host join failed (num_processes=2): ")
        assert _healthz(handle.status_port) == (
            503, {"status": "degraded", "reason": handle.check.error})
        assert handle.snapshot()["distributed"]["active"] is False
    finally:
        handle.shutdown()


def test_a_boot_that_cannot_resolve_its_identity_degrades(tmp_path,
                                                          monkeypatch):
    for var in ("KVEDGE_PROCESS_ID", "TPU_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(ours.socket, "gethostname", lambda: "no-ordinal-x")
    handle = _boot(tmp_path, num_processes=2,
                   coordinator_address="127.0.0.1:1")
    try:
        with pytest.raises(Exception) as want:
            theirs.resolve_process_id(JaxSpec(num_processes=2), {},
                                      "no-ordinal-x")
        assert handle.check.error == (
            "multi-host join failed (num_processes=2): "
            f"{type(want.value).__name__}({str(want.value)!r})")
    finally:
        handle.shutdown()


_TRAIN_WORKER = textwrap.dedent("""
    import os, sys
    import torch
    torch.set_num_threads(1)
    from kvedge_torch.parallel.distributed import maybe_initialize
    from kvedge_torch.runtime.config import RuntimeConfig
    from kvedge_torch.runtime.train import run_train_payload

    cfg = RuntimeConfig.parse(open(os.environ["KVEDGE_TRAIN_TOML"]).read())
    maybe_initialize(cfg.distributed, environ=os.environ,
                     hostname=os.environ["FAKE_POD_NAME"], device="cpu")
    result = run_train_payload(cfg, device="cpu")
    print(f"TRAIN ok={result.ok} loss={result.loss:.6f} "
          f"err={result.error!r}", flush=True)
    sys.exit(0 if result.ok else 1)
""")


def _train_toml(tmp_path, *, num_processes, steps, state_dir, port):
    corpus = tmp_path / "corpus.kvfeed"
    if not corpus.exists():
        from kvedge_torch.data.feeder import write_corpus

        rng = np.random.default_rng(7)
        write_corpus(corpus, rng.integers(0, 512, size=6000, dtype=np.int32))
    return (
        "[runtime]\n"
        'name = "mh-train"\n'
        f'state_dir = "{state_dir}"\n'
        f'checkpoint_dir = "{tmp_path / "shared-ckpt"}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[mesh]\n"
        "axes = { data = 0 }\n"
        "[distributed]\n"
        f"num_processes = {num_processes}\n"
        f'coordinator_address = "127.0.0.1:{port}"\n'
        "[status]\n"
        "port = 0\n"
        "[payload]\n"
        'kind = "train"\n'
        f'corpus = "{corpus}"\n'
        f"steps = {steps}\n"
        "batch = 8\n"
        "seq = 32\n"
        "checkpoint_every = 2\n"
    )


def _spawn_train_workers(tmp_path, num_processes, steps, port):
    procs = []
    for pid in range(num_processes):
        toml_path = tmp_path / f"train-{pid}.toml"
        toml_path.write_text(_train_toml(
            tmp_path, num_processes=num_processes, steps=steps,
            state_dir=tmp_path / f"pvc-{pid}", port=port))
        env = dict(os.environ, FAKE_POD_NAME=f"kvedge-tpu-runtime-{pid}",
                   KVEDGE_TRAIN_TOML=str(toml_path), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TRAIN_WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp_path))
    return procs


def _finish(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"train worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [line for out in outs for line in out.splitlines()
            if line.startswith("TRAIN")]


def test_two_process_train_survives_kill_and_matches_single(tmp_path):
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    lines = _finish(_spawn_train_workers(single_dir, 1, 10, _free_port()))
    single_loss = float(re.search(r"loss=([-\d.]+)", lines[0]).group(1))

    # Phase 1: a 2-process run toward the same 10 steps, killed once the
    # shared checkpoint holds step >= 4.
    procs = _spawn_train_workers(tmp_path, 2, 10, _free_port())
    ckpt_root = tmp_path / "shared-ckpt"
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            steps_done = [int(p.name) for p in ckpt_root.glob("[0-9]*")
                          if p.name.isdigit()]
            if any(s >= 4 for s in steps_done):
                break
            if all(p.poll() is not None for p in procs):
                break  # finished before the kill: still a valid resume test
            time.sleep(0.05)
        else:
            raise AssertionError("no checkpoint appeared before the deadline")
    finally:
        killed = False
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                killed = True
        for p in procs:
            p.communicate(timeout=60)

    # Phase 2: a fresh generation on the same volumes and shared storage.
    lines = _finish(_spawn_train_workers(tmp_path, 2, 10, _free_port()))
    assert len(lines) == 2
    losses = {float(re.search(r"loss=([-\d.]+)", ln).group(1))
              for ln in lines}
    assert len(losses) == 1, f"hosts disagree on the final loss: {lines}"
    (multi_loss,) = losses
    assert abs(multi_loss - single_loss) < 1e-3, (
        f"multi-host {multi_loss} vs single {single_loss} (killed={killed})")


def _payload_toml(tmp_path, axes, kind, num_processes):
    return (
        "[runtime]\n"
        f'state_dir = "{tmp_path / "state"}"\n'
        f'checkpoint_dir = "{tmp_path / "ckpt"}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[mesh]\n"
        f"axes = {axes}\n"
        "[distributed]\n"
        f"num_processes = {num_processes}\n"
        "[payload]\n"
        f'kind = "{kind}"\n'
        f'corpus = "{tmp_path / "corpus.kvfeed"}"\n'
        "steps = 2\n"
        "batch = 8\n"
        "seq = 32\n"
    )


# name -> ([mesh] axes in a world of 2, payload kind, the mesh shape),
# run in this order in one world
PAYLOADS = {
    "devicecheck-model2": ("{ data = 1, model = 2 }", "devicecheck", (1, 2)),
    "probe-model2": ("{ data = 1, model = 2 }", "transformer-probe", (1, 2)),
    "probe-seq2-ring": ("{ data = 1, seq = 2 }", "transformer-probe",
                        (1, 2)),
    "eval-data2-fresh": ("{ data = 0 }", "eval", (2,)),
    "train-model2": ("{ data = 1, model = 2 }", "train", (1, 2)),
    "eval-data2-trained": ("{ data = 0 }", "eval", (2,)),
}


def test_payloads_on_a_world_of_two_equal_one_process(tmp_path):
    """The device check reports the resolved mesh; the transformer probe
    (on the same 4 rows) and the eval payload (the fresh init, then the
    checkpoint a tensor-parallel train run wrote: gathered, and cut again
    for the data-parallel eval) across two ranks equal the port in one
    process within 1e-5 at fp32, the one-process eval restoring the
    world's checkpoint."""
    from kvedge_torch.data.feeder import write_corpus
    from kvedge_torch.runtime import probes
    from kvedge_torch.runtime import train as tpay
    from kvedge_torch.testing.world import run_world

    write_corpus(tmp_path / "corpus.kvfeed", np.random.default_rng(3)
                 .integers(0, 512, size=4000, dtype=np.int32))
    tokens = np.random.default_rng(4).integers(
        0, 512, (4, probes.PROBE_SEQ + 1))
    cases = [dict(toml=_payload_toml(tmp_path, axes, kind, 2), kind=kind,
                  tokens=tokens) for axes, kind, _ in PAYLOADS.values()]
    ranks = run_world("kvedge_torch.testing.parallelcases:families", 2,
                      payloads=cases, tmp_dir=str(tmp_path / "world"))
    for i, (name, (axes, kind, shape)) in enumerate(PAYLOADS.items()):
        got = [r["payloads"][i] for r in ranks]
        assert all(g["ok"] for g in got), (name, got)
        assert {(g["mesh_shape"], g["device_count"]) for g in got} == {
            (shape, 2)}, name
        if kind in ("devicecheck", "train"):
            continue
        single = RuntimeConfig.parse(_payload_toml(
            tmp_path, "{ data = 0, model = 1, seq = 1 }", kind, 1))
        if kind == "eval":
            if name == "eval-data2-fresh":
                single = dataclasses.replace(
                    single, checkpoint_dir=str(tmp_path / "none"))
            result = tpay.run_eval_payload(single, device="cpu",
                                           dtype="float32")
            assert result.step == (None if "fresh" in name else 2), name
            want = result.loss
        else:
            if "ring" in name:
                single = dataclasses.replace(single, payload_attention="ring")
            want = probes.run_transformer_probe(
                single, "cpu", "float32", tokens=tokens).probe_checksum
        assert abs(got[0]["value"] - got[1]["value"]) == 0.0, name
        assert abs(got[0]["value"] - want) < 1e-5, (name, got[0], want)


_BOOT_WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from kvedge_torch.runtime.boot import start_runtime
    from kvedge_torch.runtime.config import RuntimeConfig

    cfg = RuntimeConfig.parse(open(os.environ["KVEDGE_BOOT_TOML"]).read())
    handle = start_runtime(cfg, device="cpu")
    snap = handle.snapshot()
    print("BOOT " + json.dumps({"ok": handle.check.ok,
                                "error": handle.check.error,
                                "distributed": snap["distributed"],
                                "mesh_shape": snap["check"]["mesh_shape"],
                                "device_count": snap["check"]["device_count"]}),
          flush=True)
    handle.shutdown()
""")


def test_two_booted_runtimes_join_one_world(tmp_path):
    """Two processes boot the same TOML with their own process ids: each
    joins the world before its payload, reports it in ``/status``'s
    ``distributed`` (the reference's ``DistributedState``), and its
    device check sees the mesh resolved over the world."""
    port = _free_port()
    procs = []
    for pid in range(2):
        toml = tmp_path / f"boot-{pid}.toml"
        toml.write_text(
            "[runtime]\n"
            f'state_dir = "{tmp_path / f"pvc-{pid}"}"\n'
            "[tpu]\n"
            'platform = "cpu"\n'
            "[mesh]\n"
            "axes = { data = 0, model = 1 }\n"
            "[distributed]\n"
            "num_processes = 2\n"
            f'coordinator_address = "127.0.0.1:{port}"\n'
            f"process_id = {pid}\n"
            "[status]\n"
            "port = 0\n"
            'bind = "127.0.0.1"\n')
        env = dict(os.environ, KVEDGE_BOOT_TOML=str(toml), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOT_WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    docs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            line = [ln for ln in out.splitlines() if ln.startswith("BOOT ")]
            docs.append(json.loads(line[0][5:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, doc in enumerate(docs):
        assert doc["ok"], doc["error"]
        assert doc["distributed"] == theirs.DistributedState(
            active=True, num_processes=2, process_id=pid,
            coordinator=f"127.0.0.1:{port}").to_dict()
        assert (doc["mesh_shape"], doc["device_count"]) == ([2, 1], 2)


# [mesh] axes over 8 devices (the conftest's virtual CPU devices for the
# reference, num_processes = 8 for the port) and [payload]/[model] lines
DERIVATIONS = {
    "seq-default-ring": ("{ data = 0, seq = 2 }", ""),
    "seq-naive-refused": ("{ data = 0, seq = 2 }", 'attention = "naive"\n'),
    "ring-without-seq": ("{ data = 0 }", 'attention = "ring"\n'),
    "ulysses-rounds-heads": ("{ data = 1, model = 2, seq = 4 }",
                             'attention = "ulysses"\n'),
    "ulysses-explicit-heads": ("{ data = 0, seq = 2 }",
                               'attention = "ulysses"\n[model]\n'
                               "n_heads = 3\nd_model = 96\n"),
    "model-axis-heads": ("{ data = 1, model = 8 }", ""),
}


@pytest.mark.parametrize("name", DERIVATIONS)
def test_model_derivation_matches_the_reference(name):
    """``RuntimeConfig.model_config`` against the reference's
    ``derive_model_config`` on the same TOML and mesh: the same
    attention, head count and model, or the same refusal."""
    from kvedge_tpu.runtime.workload import derive_model_config

    axes, extra = DERIVATIONS[name]
    text = (f"[mesh]\naxes = {axes}\n[distributed]\nnum_processes = 8\n"
            f"[payload]\n{extra}")
    try:
        jcfg, _ = derive_model_config(JaxConfig.parse(text), seq=32)
    except ValueError as e:
        with pytest.raises(RuntimeConfigError) as ours:
            RuntimeConfig.parse(text).model_config()
        assert str(ours.value) == str(e)
        return
    tcfg = dataclasses.replace(RuntimeConfig.parse(text),
                               max_seq=32).model_config()
    for field in ("attention", "n_heads", "n_kv_heads", "d_model",
                  "n_layers", "vocab", "d_ff", "max_seq"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("batch,data,n,ckpt", [
    (6, 4, 4, "c"), (8, 4, 4, ""), (8, 4, 4, "c"), (8, 2, 4, "c")],
    ids=["indivisible", "no-shared-dir", "data4", "data2-of-4"])
def test_feed_geometry_is_the_references(batch, data, n, ckpt):
    """The prechecks' messages are the reference's (the multi-host one
    names what the port supports), and each rank reads ``batch / data``
    rows at ``data_index * rows``: ranks sharing a data index read the
    same rows."""
    from kvedge_torch.parallel.mesh import Mesh
    from kvedge_torch.runtime.train import feed_geometry
    from kvedge_tpu.runtime.devicecheck import DeviceCheckResult
    from kvedge_tpu.runtime.workload import _feed_geometry

    cfg = dataclasses.replace(RuntimeConfig(), train_batch=batch,
                              num_processes=n, checkpoint_dir=ckpt,
                              mesh_axes=(("data", data), ("seq", n // data)))
    base = DeviceCheckResult(
        ok=True, platform="cpu", device_count=n, device_kinds=("cpu",),
        mesh_axes=("data", "seq"), mesh_shape=(data, n // data),
        probe_ms=0.0, probe_checksum=0.0)
    want, _ = _feed_geometry(JaxConfig(train_batch=batch), base, "train")
    geometries = set()
    for rank in range(n):
        mesh = Mesh(("data", "seq"), (data, n // data),
                    (rank // (n // data), rank % (n // data)))
        error, geometry = feed_geometry(cfg, mesh, "train")
        if batch % data:
            assert error == want.error
            return
        if not ckpt:
            assert error.startswith("multi-host train needs [runtime] "
                                    "checkpoint_dir on shared storage")
            return
        assert error is None
        geometries.add((mesh.index("data"), geometry))
    assert geometries == {(i, (batch // data, i * batch // data))
                          for i in range(data)}
