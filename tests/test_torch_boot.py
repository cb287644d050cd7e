"""The port's boot contract (``kvedge_torch/runtime/boot.py``,
``heartbeat.py``, ``devicecheck.py``, ``probes.py`` and the config's new
sections) against the JAX package's, on the CPU.

Mirrors the cases of ``tests/test_runtime.py`` that need no mesh larger
than one device, each run through both packages where the reference can
run it here:

* ``boot_count`` survives a restart, a corrupt heartbeat resets, and a
  state directory booted by one package goes on counting under the
  other; the heartbeat writer's functions are the reference's.
* The status, heartbeat and check documents carry the reference's keys
  (the check adds the port's ``probe_max_err``); the booting, degraded,
  topology and failing-payload states answer with the reference's
  messages and ``/healthz`` bodies.
* The transformer probe on the JAX tree and batch carried across: its
  loss equals the JAX probe's within 2e-2 (bf16; XLA and torch round
  bf16 chains at other points, as in ``test_torch_training.py``). The
  inference probe's tokens equal the JAX package's ``generate`` on the
  same weights and prompt.
* The JAX package's default TOML parses in the port once ``[tpu]
  platform`` is set, to the same values; meshes over several processes
  parse as the reference's do; what is still refused is refused by name
  with its ROADMAP Queue A item.
"""

import dataclasses
import inspect
import json
import math
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.runtime import boot as jboot
from kvedge_tpu.runtime import heartbeat as jhb
from kvedge_tpu.runtime import workload as jwork
from kvedge_torch.runtime import boot as tboot
from kvedge_torch.runtime import heartbeat as thb
from kvedge_torch.runtime import probes
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.runtime.devicecheck import DeviceCheckResult
from kvedge_torch.runtime.profiling import SERVE_MAX_SECONDS
from kvedge_torch.runtime.status import render_metrics

torch.set_num_threads(2)


def _cfg(tmp_path, **overrides) -> RuntimeConfig:
    base = dict(name="test-edge", state_dir=str(tmp_path / "state"),
                expected_platform="cpu", status_port=0,
                status_bind="127.0.0.1", payload="devicecheck")
    base.update(overrides)
    return dataclasses.replace(RuntimeConfig(), **base)


def _jcfg(tmp_path, **overrides) -> JaxConfig:
    base = dict(name="test-edge", state_dir=str(tmp_path / "state"),
                expected_platform="cpu", status_port=0,
                status_bind="127.0.0.1", payload="none")
    base.update(overrides)
    return dataclasses.replace(JaxConfig(), **base)


def _start(cfg):
    return tboot.start_runtime(cfg, device="cpu")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---- heartbeats and boot_count -------------------------------------------


def test_heartbeat_writer_is_the_reference_functions():
    for name in ("write_heartbeat", "next_boot_count", "HeartbeatWriter"):
        assert (inspect.getsource(getattr(thb, name))
                == inspect.getsource(getattr(jhb, name))), name


def test_heartbeat_boot_count_survives_restart(tmp_path):
    state = str(tmp_path / "state")
    handle = _start(_cfg(tmp_path))
    try:
        assert handle.boot_count == 1
        beat = thb.read_heartbeat(state)
        # Two beats a boot: the booting one and the payload's.
        assert beat["boot_count"] == 1 and beat["seq"] == 2
        assert beat["ok"] is True
    finally:
        handle.shutdown()
    handle = _start(_cfg(tmp_path))
    try:
        assert handle.boot_count == 2
        beat = thb.read_heartbeat(state)
        assert beat["boot_count"] == 2 and beat["seq"] == 4
    finally:
        handle.shutdown()


def test_heartbeat_corrupt_file_resets_gracefully(tmp_path):
    state = tmp_path / "state"
    state.mkdir()
    (state / thb.HEARTBEAT_FILE).write_text("{corrupt")
    assert thb.read_heartbeat(str(state)) is None
    assert thb.next_boot_count(str(state)) == 1
    assert thb.write_heartbeat(str(state), {"ok": True})["seq"] == 1


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_boot_count_continues_across_the_two_packages(tmp_path, first):
    """One state volume, booted by one package then the other: the
    count and the sequence go on."""
    boots = {"jax": lambda: jboot.start_runtime(_jcfg(tmp_path)),
             "torch": lambda: _start(_cfg(tmp_path, payload="none"))}
    order = [first, "torch" if first == "jax" else "jax", first]
    for n, pkg in enumerate(order, start=1):
        handle = boots[pkg]()
        try:
            assert handle.boot_count == n
            beat = thb.read_heartbeat(str(tmp_path / "state"))
            assert (beat["boot_count"], beat["seq"]) == (n, 2 * n)
            assert handle.snapshot()["boot_count"] == n
        finally:
            handle.shutdown()


def test_boot_once_from_a_config_file(tmp_path, capsys):
    path = tmp_path / "config.toml"
    path.write_text(_cfg(tmp_path, payload="none").to_toml())
    tboot.boot(str(path), once=True, device="cpu")
    tboot.boot(str(path), once=True, device="cpu")
    beat = thb.read_heartbeat(str(tmp_path / "state"))
    assert beat["boot_count"] == 2 and beat["ok"] is True
    out = capsys.readouterr().out
    assert "payload=none ok=True" in out and "boot_count=2" in out


# ---- the documents -------------------------------------------------------


@pytest.fixture(scope="module")
def both_booted(tmp_path_factory):
    """The devicecheck payload booted by each package: its heartbeat and
    /status documents."""
    docs = {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path_factory.mktemp(pkg)
        handle = (jboot.start_runtime(_jcfg(tmp, payload="devicecheck"))
                  if pkg == "jax" else _start(_cfg(tmp)))
        try:
            docs[pkg] = {"heartbeat": thb.read_heartbeat(str(tmp / "state")),
                         "status": _get(handle.status_port, "/status")[1],
                         "healthz": _get(handle.status_port, "/healthz"),
                         "metrics": render_metrics(handle.snapshot())}
        finally:
            handle.shutdown()
    return docs


def test_status_and_heartbeat_documents_key_for_key(both_booted):
    ours, theirs = both_booted["torch"], both_booted["jax"]
    assert set(ours["status"]) == set(theirs["status"])
    assert set(ours["heartbeat"]) == set(theirs["heartbeat"])
    assert (set(ours["status"]["check"]) - {"probe_max_err"}
            == set(theirs["status"]["check"]))
    assert ours["status"]["distributed"] == theirs["status"]["distributed"]
    for key in ("name", "ok", "payload", "boot_count", "heartbeat_seq",
                "init_events", "train_progress", "serving", "last_failure"):
        assert ours["status"][key] == theirs["status"][key], key
    assert ours["healthz"] == theirs["healthz"] == (200, {"status": "ok"})
    check = ours["status"]["check"]
    assert (check["platform"], check["device_count"], check["mesh_axes"],
            check["mesh_shape"]) == ("cpu", 1, ["data", "model"], [1, 1])
    assert theirs["status"]["check"]["mesh_axes"] == ["data", "model"]


def test_check_document_has_the_reference_fields():
    ours = {f.name for f in dataclasses.fields(DeviceCheckResult)}
    from kvedge_tpu.runtime.devicecheck import (
        DeviceCheckResult as JaxResult,
    )

    assert ours - {"probe_max_err"} == {
        f.name for f in dataclasses.fields(JaxResult)}


def test_metrics_families_match(both_booted):
    def families(body):
        return {ln.split()[2] for ln in body.splitlines()
                if ln.startswith("# TYPE")}

    assert families(both_booted["torch"]["metrics"]) == families(
        both_booted["jax"]["metrics"])
    assert "kvedge_boot_count 1" in both_booted["torch"]["metrics"]
    assert "kvedge_devices 1" in both_booted["torch"]["metrics"]


def test_status_surfaces_supervisor_events(tmp_path):
    events = tmp_path / "state" / "init-events.jsonl"
    events.parent.mkdir(parents=True)
    events.write_text(
        '{"ts": 1.0, "event": "supervisor-start", "pid": 1}\n'
        '{"ts": 2.0, "event": "child-start", "pid": 7, "attempt": 0}\n'
        '{"ts": 3.0, "event": "child-exit", "co'  # truncated mid-write
    )
    handle = _start(_cfg(tmp_path, payload="none"))
    try:
        code, doc = _get(handle.status_port, "/status")
        assert code == 200
        assert [e["event"] for e in doc["init_events"]] == [
            "supervisor-start", "child-start"]
        body = render_metrics(handle.snapshot())
        assert "kvedge_probe_ms 0.0" in body and "kvedge_devices 0" in body
    finally:
        handle.shutdown()


# ---- booting, degraded, topology, failing payload -------------------------


def _degraded_pair(tmp_path, monkeypatch, env=None, **fields):
    """Boot each package with ``fields``; returns {pkg: (check error,
    /healthz answer, /status ok)}."""
    if env is not None:
        monkeypatch.setenv("KVEDGE_EXPECTED_PROCESSES", env)
    out = {}
    for pkg in ("jax", "torch"):
        handle = (jboot.start_runtime(_jcfg(tmp_path / pkg,
                                            payload="devicecheck", **fields))
                  if pkg == "jax" else _start(_cfg(tmp_path / pkg, **fields)))
        try:
            status = _get(handle.status_port, "/status")
            out[pkg] = (handle.check.error,
                        _get(handle.status_port, "/healthz"),
                        status[0], status[1]["ok"])
            assert not handle.check.ok
        finally:
            handle.shutdown()
    return out


@pytest.mark.parametrize("fields,env,message", [
    ({"expected_platform": "tpu"}, None,
     "expected platform 'tpu', got 'cpu'"),
    ({"expected_chips": 13}, None, "expected 13 chips, {n} visible"),
    ({}, "4", "topology mismatch: the chart was rendered for 4 hosts "
              "(KVEDGE_EXPECTED_PROCESSES) but the runtime config declares "
              "[distributed] num_processes=1; fix the config TOML"),
    ({}, "four", "KVEDGE_EXPECTED_PROCESSES='four' is not an integer"),
], ids=["platform", "chips", "topology", "topology-not-an-int"])
def test_degraded_states_answer_as_the_reference(tmp_path, monkeypatch,
                                                 fields, env, message):
    got = _degraded_pair(tmp_path, monkeypatch, env, **fields)
    for pkg, n in (("jax", 8), ("torch", 1)):
        error, healthz, status_code, ok = got[pkg]
        assert error == message.format(n=n), pkg
        assert healthz == (503, {"status": "degraded", "reason": error})
        assert (status_code, ok) == (200, False)


@pytest.mark.parametrize("fields,message", [
    ({"mesh_axes": (("data", 1), ("seq", 2)), "num_processes": 2},
     r"kind = 'serve' over a 'seq' axis of 2"),
    ({"mesh_axes": (("seq", 0),), "num_processes": 2},
     r"kind = 'serve' over a 'seq' axis of 2: .*'stage' and 'expert'"),
], ids=["mesh", "num_processes"])
def test_a_config_the_parser_refuses_degrades_the_boot(tmp_path, fields,
                                                       message):
    """Built in code, past the parser: the boot degrades with the
    parser's message; /status answers, /healthz is the 503."""
    handle = _start(_cfg(tmp_path, payload="serve", **fields))
    try:
        assert not handle.check.ok and handle.serve_fn is None
        with pytest.raises(RuntimeConfigError, match=message):
            handle.cfg.validate()
        code, doc = _get(handle.status_port, "/healthz")
        assert code == 503 and doc["reason"] == handle.check.error
        assert _get(handle.status_port, "/status")[0] == 200
    finally:
        handle.shutdown()


def test_boot_accepts_matching_topology_env(tmp_path, monkeypatch):
    monkeypatch.setenv("KVEDGE_EXPECTED_PROCESSES", "1")
    handle = _start(_cfg(tmp_path))
    try:
        assert handle.check.ok, handle.check.error
    finally:
        handle.shutdown()


def test_failing_payload_degrades_not_crashes(tmp_path, monkeypatch):
    def explode(*args, **kwargs):
        raise RuntimeError("synthetic payload failure")

    monkeypatch.setattr(jwork, "run_transformer_probe", explode)
    monkeypatch.setattr(probes, "run_transformer_probe", explode)
    errors = {}
    for pkg in ("jax", "torch"):
        handle = (jboot.start_runtime(_jcfg(tmp_path / pkg,
                                            payload="transformer-probe"))
                  if pkg == "jax" else
                  _start(_cfg(tmp_path / pkg, payload="transformer-probe")))
        try:
            errors[pkg] = handle.check.error
            assert _get(handle.status_port, "/status")[1]["ok"] is False
            assert _get(handle.status_port, "/healthz")[0] == 503
        finally:
            handle.shutdown()
    assert errors["torch"] == errors["jax"] == (
        "payload 'transformer-probe' failed: "
        "RuntimeError('synthetic payload failure')")


def test_a_missing_card_degrades_the_boot(tmp_path, monkeypatch):
    """No card and no CPU asked for: the payload degrades with the
    device's message; nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    handle = tboot.start_runtime(_cfg(tmp_path, payload="serve",
                                      expected_platform="gpu"))
    try:
        assert not handle.check.ok and handle.serve_fn is None
        assert "no CUDA device is visible" in handle.check.error
        code, doc = _get(handle.status_port, "/healthz")
        assert code == 503 and "no CUDA device" in doc["reason"]
    finally:
        handle.shutdown()


def test_status_server_answers_during_boot_work(tmp_path, monkeypatch):
    """/version answers and /healthz is the booting 503 (the reference's
    body) while the payload runs; POST /generate and POST /profile are
    503 until it is done; afterwards the server is healthy."""
    seen = {}

    def probing_payload(cfg, handle, *args):
        port = handle.status_port
        seen["version"] = _get(port, "/version")[0]
        seen["healthz"] = _get(port, "/healthz")
        for route in ("/generate", "/profile?seconds=0.1"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{route}", method="POST",
                data=json.dumps({"tokens": [[1]], "n_new": 1}).encode())
            try:
                urllib.request.urlopen(req, timeout=30)
                seen[route] = 200
            except urllib.error.HTTPError as e:
                seen[route] = (e.code, json.loads(e.read())["error"])
        return DeviceCheckResult(
            ok=True, platform="probe", device_count=0, device_kinds=(),
            mesh_axes=(), mesh_shape=(), probe_ms=0.0, probe_checksum=0.0)

    monkeypatch.setattr(tboot, "_run_payload", probing_payload)
    handle = _start(_cfg(tmp_path))
    try:
        assert seen["version"] == 200
        assert seen["healthz"] == (503, {
            "status": "degraded",
            "reason": jboot._booting().error})
        assert seen["/generate"][0] == 503
        assert "no generation backend yet" in seen["/generate"][1]
        assert seen["/profile?seconds=0.1"][0] == 503
        assert "still booting" in seen["/profile?seconds=0.1"][1]
        assert _get(handle.status_port, "/healthz")[0] == 200
        assert handle.trace_capture.capture(0.1)["files"] == 1
        assert _get(handle.status_port, "/profile/traces")[1]["traces"][0][
            "name"] == "trace-0001"
    finally:
        handle.shutdown()


def test_a_capture_waits_for_the_serve_payloads_work_lock(tmp_path):
    """The runtime's profiler starts and stops under the paged server's
    work lock, the lock every device launch of its decode loop takes."""
    handle = _start(_cfg(tmp_path, payload="serve", payload_serving="paged",
                         max_seq=64, serving_prefix_persist=False))
    try:
        assert handle.check.ok, handle.check.error
        done = threading.Event()
        with handle.serve_fn.device_quiet():
            t = threading.Thread(target=lambda: (
                handle.trace_capture.capture(0.1), done.set()))
            t.start()
            time.sleep(0.3)
            assert not done.is_set()
        t.join(timeout=30)
        assert not t.is_alive() and done.is_set()
        doc = handle.serve_fn({"tokens": [[1, 2, 3]], "n_new": 3})
        assert len(doc["tokens"][0]) == 6
    finally:
        handle.shutdown()


def test_the_serve_payload_caps_a_capture_window(tmp_path):
    """A stop pauses every thread for as long as its trace is big, so at
    serve a window is capped (``profiling.SERVE_MAX_SECONDS``) far below
    the reference's 60 s."""
    handle = _start(_cfg(tmp_path, payload="serve", payload_serving="paged",
                         max_seq=64, serving_prefix_persist=False))
    try:
        assert handle.check.ok, handle.check.error
        doc = handle.trace_capture.capture(3600.0)
        assert SERVE_MAX_SECONDS <= doc["duration_s"] < SERVE_MAX_SECONDS + 1
    finally:
        handle.shutdown()


def test_payload_none_skips_devices(tmp_path):
    handle = _start(_cfg(tmp_path, payload="none"))
    try:
        assert handle.check.ok and handle.check.platform == "skipped"
    finally:
        handle.shutdown()


# ---- the probes against the JAX package ------------------------------------


def test_transformer_probe_loss_equals_the_jax_probe(tmp_path):
    jcfg = _jcfg(tmp_path, payload="transformer-probe")
    want = jwork.run_transformer_probe(jcfg)
    assert want.ok, want.error
    # The reference's weights and batch (its PRNG), carried across.
    tcfg_j, _ = jwork.derive_model_config(jcfg, seq=probes.PROBE_SEQ)
    key = jax.random.PRNGKey(0)
    from kvedge_tpu.models import init_params as jinit

    tree = {k: np.asarray(v) for k, v in jinit(key, tcfg_j).items()}
    tokens = np.asarray(jax.random.randint(
        key, (probes.PROBE_BATCH_PER_DEVICE * want.device_count,
              probes.PROBE_SEQ + 1), 0, tcfg_j.vocab, dtype=jax.numpy.int32))
    got = probes.run_transformer_probe(
        _cfg(tmp_path, payload="transformer-probe"), "cpu", params=tree,
        tokens=tokens)
    assert got.ok, got.error
    assert abs(got.probe_checksum - want.probe_checksum) <= 2e-2
    assert got.probe_ms > 0
    # The seeded default run passes the same check.
    own = probes.run_transformer_probe(_cfg(tmp_path), "cpu")
    assert own.ok and abs(own.probe_checksum - math.log(512)) < 0.5 * \
        math.log(512)


def test_inference_probe_tokens_equal_the_jax_package(tmp_path):
    from kvedge_tpu.models import TransformerConfig as JaxModel
    from kvedge_tpu.models import generate as jgenerate
    from kvedge_tpu.models import init_params as jinit

    want = jwork.run_inference_probe(_jcfg(tmp_path))
    assert want.ok, want.error
    tcfg = probes.inference_probe_config()
    jcfg = JaxModel(**{f.name: getattr(tcfg, f.name) for f in
                       dataclasses.fields(JaxModel)
                       if hasattr(tcfg, f.name)})
    params = jinit(jax.random.PRNGKey(0), jcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1),
                                (2, probes.PROBE_PROMPT), 0, jcfg.vocab,
                                dtype=jax.numpy.int32)
    jtokens = np.asarray(jgenerate(params, prompt, jcfg,
                                   n_new=probes.PROBE_NEW_TOKENS))
    got = probes.run_inference_probe(
        _cfg(tmp_path), "cpu",
        params={k: np.asarray(v) for k, v in params.items()},
        prompt=np.asarray(prompt))
    assert got.ok, got.error
    assert got.probe_checksum == want.probe_checksum == float(jtokens.sum())
    own = probes.run_inference_probe(_cfg(tmp_path), "cpu")
    assert own.ok and own.probe_checksum == int(own.probe_checksum)


@pytest.mark.parametrize("kind", ["transformer-probe", "inference-probe"])
def test_probes_propagate_a_devicecheck_failure(tmp_path, kind):
    run = (probes.run_transformer_probe if kind == "transformer-probe"
           else probes.run_inference_probe)
    result = run(_cfg(tmp_path, expected_platform="tpu"), "cpu")
    assert not result.ok and "expected platform" in result.error


def test_probe_payloads_through_start_runtime(tmp_path):
    for kind in ("transformer-probe", "inference-probe"):
        handle = _start(_cfg(tmp_path / kind, payload=kind,
                             payload_attention="flash"))
        try:
            assert handle.check.ok, handle.check.error
            assert handle.check.probe_ms > 0
            assert thb.read_heartbeat(str(tmp_path / kind / "state"))[
                "check"]["probe_checksum"] == handle.check.probe_checksum
        finally:
            handle.shutdown()


# ---- the config --------------------------------------------------------


SHARED_FIELDS = (
    "name", "state_dir", "checkpoint_dir", "heartbeat_interval_s",
    "expected_platform", "expected_chips", "status_port", "status_bind",
    "status_token", "payload", "payload_attention", "payload_serving",
    "serving_slots", "serving_window", "serving_prefix_persist",
    "serving_slo_fast_s", "train_corpus", "train_steps", "train_batch")


def _same_values(ours: RuntimeConfig, theirs: JaxConfig) -> None:
    for field in SHARED_FIELDS:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.max_seq == theirs.train_seq
    assert ours.mesh_axes == theirs.mesh.axes
    assert ours.num_processes == theirs.distributed.num_processes
    for field in ("preset", "vocab", "experts", "expert_capacity_factor",
                  "pipeline_schedule"):
        assert getattr(ours, field) == getattr(theirs.model, field), field


def test_the_reference_default_toml_parses_in_the_port():
    text = JaxConfig().to_toml().replace('platform = "tpu"',
                                         'platform = "gpu"')
    ours, theirs = RuntimeConfig.parse(text), JaxConfig.parse(text)
    _same_values(ours, theirs)
    assert ours == dataclasses.replace(RuntimeConfig(), name="kvedge-tpu")
    # ... and the port's document parses in the reference to the same.
    _same_values(ours, JaxConfig.parse(ours.to_toml()))
    assert RuntimeConfig.parse(ours.to_toml()) == ours


def test_defaults_are_the_reference_but_the_platform():
    ours, theirs = RuntimeConfig(), JaxConfig()
    assert ours.payload == theirs.payload == "devicecheck"
    assert ours.expected_platform == "gpu" and theirs.expected_platform == \
        "tpu"
    assert (ours.heartbeat_interval_s, ours.name, ours.mesh_axes) == (
        theirs.heartbeat_interval_s, theirs.name, theirs.mesh.axes)


def test_status_token_round_trips_through_config_toml():
    cfg = RuntimeConfig.parse('[status]\nport = 0\ntoken = "tok-from-secret"\n')
    assert cfg.status_token == "tok-from-secret"
    assert RuntimeConfig.parse(cfg.to_toml()).status_token == \
        "tok-from-secret"


@pytest.mark.parametrize("text,match", [
    ('[mesh]\naxes = { data = 3, model = 1 }\n[distributed]\n'
     'num_processes = 2\n', r"wants 3 devices, which \[distributed\] "
     r"num_processes = 2 cannot hold"),
    ('[mesh]\naxes = { data = 0, seq = 0 }\n', "at most one mesh axis"),
    ('[mesh]\nshape = [1]\n', r"\['shape'\]"),
    ('[mesh]\naxes = { seq = 0 }\n[distributed]\nnum_processes = 2\n'
     '[payload]\nkind = "serve"\n', r"kind = 'serve' over a 'seq' axis"),
    ('[distributed]\nprocess_id = 3\n', "process_id 3 not in"),
    ('[distributed]\nhosts = 2\n', r"\['hosts'\]"),
    ('[model]\npipeline_schedule = "zb"\n',
     r"pipeline_schedule must be 'gpipe' or '1f1b'"),
    ('[mesh]\naxes = { seq = 0, stage = 2 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "serve"\n',
     r"'serve' over a 'seq' axis of 2"),
    ('[mesh]\naxes = { expert = 2, seq = 0 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "inference-probe"\n',
     r"'inference-probe' over a 'seq' axis of 2"),
    ('[mesh]\naxes = { data = 1, seq = 2 }\n[distributed]\n'
     'num_processes = 2\n[payload]\nkind = "inference-probe"\n',
     r"'inference-probe' over a 'seq' axis"),
    ('[model]\nn_experts = 4\n', r"\['n_experts'\]"),
    ('[tpu]\ncores = 4\n', r"\[tpu\] key\(s\) \['cores'\]"),
    ('[runtime]\nheartbeat_interval_s = 0\n', "heartbeat_interval_s"),
    ('[runtime]\nname = ""\n', "name must be non-empty"),
    ('[tpu]\nexpected_chips = -1\n', "expected_chips must be >= 0"),
    ('[payload]\nkind = "benchmark"\n', "kind must be one of"),
    ('[slice]\nhosts = 2\n', r"\['slice'\]"),
])
def test_still_refused_by_name(text, match):
    with pytest.raises(RuntimeConfigError, match=match):
        RuntimeConfig.parse(text)


@pytest.mark.parametrize("text,shape", [
    ('[mesh]\naxes = { data = 2, model = 1 }\n[distributed]\n'
     'num_processes = 2\n', (2, 1)),
    ('[mesh]\naxes = { data = 0, seq = 2 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "train"\ncorpus = "c.bin"\n',
     (2, 2)),
    ('[mesh]\naxes = { data = 1, model = 2, seq = 2 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "transformer-probe"\n'
     'attention = "ulysses"\n', (1, 2, 2)),
    ('[distributed]\nnum_processes = 2\n[payload]\nkind = "eval"\n'
     'corpus = "c.bin"\n', (2, 1)),
], ids=["data-model", "data-seq", "model-seq", "default-axes"])
def test_meshes_over_the_world_are_accepted(text, shape):
    """The lifted refusals: a mesh over several processes and
    ``num_processes > 1`` parse, resolve against the world as the
    reference's ``MeshSpec`` does, and round-trip through the TOML."""
    cfg = RuntimeConfig.parse(text)
    assert tuple(cfg.axis_sizes().values()) == shape
    assert cfg.mesh.resolved_shape(cfg.num_processes) == \
        JaxConfig.parse(text).mesh.resolved_shape(cfg.num_processes)
    assert RuntimeConfig.parse(cfg.to_toml()) == cfg


def test_one_device_meshes_are_accepted():
    for axes in ("{ data = 1 }", "{ data = 0, model = 1, seq = 1 }",
                 "{ model = 0 }"):
        cfg = RuntimeConfig.parse(f"[mesh]\naxes = {axes}\n")
        assert cfg == RuntimeConfig.parse(cfg.to_toml())
    cfg = RuntimeConfig.parse('[distributed]\nnum_processes = 1\n'
                              'coordinator_address = "10.0.0.1"\n'
                              'process_id = 0\n')
    assert cfg.num_processes == 1
