"""The port's bootstrap (``kvedge_torch/bootstrap/``) and health probe
(``kvedge_torch/runtime/healthcheck.py``) against the JAX package's, on
the CPU, mirroring ``tests/test_bootstrap.py`` and
``tests/test_healthcheck.py``.

* The copies are the reference's modules but for their docstrings, the
  imports of the port's config and runtime, the header constant copied
  from the renderer, ``kvedge-runtime boot``'s ``--device`` and the JAX
  virtual-device knob left out.
* The chart's rendered boot document parses to the reference parser's
  document; serial discovery, ``apply`` (rebased, with the port's
  canonical TOML) and the command dispatch behave as the reference's.
* A boot document under ``tmp_path`` runs ``apply`` and then
  ``kvedge-runtime boot --once`` through the entrypoint, in a
  subprocess; the applied config parses in the port (and in the
  reference) to the source's values, and the heartbeat shows the boot.
* ``wait_healthy`` polls through 503s, fails fast on ``"terminal":
  true`` and answers as the reference's against the port's server.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from kvedge_tpu.bootstrap import bootdoc as jbootdoc
from kvedge_tpu.bootstrap import commands as jcommands
from kvedge_tpu.bootstrap import entrypoint as jentry
from kvedge_tpu.bootstrap import mount as jmount
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.config.values import DEFAULT_VALUES
from kvedge_tpu.render import bootconfig
from kvedge_tpu.render.bootconfig import boot_config_document
from kvedge_tpu.runtime import healthcheck as jhc
from kvedge_torch.bootstrap import bootdoc, commands, entrypoint, mount
from kvedge_torch.bootstrap.bootdoc import BootDocError, parse_boot_document
from kvedge_torch.bootstrap.commands import CommandError, rebase, run_command
from kvedge_torch.runtime import healthcheck as hc
from kvedge_torch.runtime import heartbeat
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_torch.runtime.status import StatusServer

REPO = pathlib.Path(__file__).resolve().parents[1]


def _body(mod) -> str:
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]


# ---- the copies --------------------------------------------------------


@pytest.mark.parametrize("ours,theirs", [(mount, jmount), (hc, jhc)],
                         ids=["mount", "healthcheck"])
def test_the_copy_is_the_reference_but_for_its_docstring(ours, theirs):
    assert _body(ours) == _body(theirs)


def test_bootdoc_and_commands_differ_only_where_the_port_must():
    assert bootdoc.HEADER == bootconfig.HEADER
    for name in ("_parse_commands", "parse_boot_document"):
        assert (inspect.getsource(getattr(bootdoc, name))
                == inspect.getsource(getattr(jbootdoc, name))), name
    for name in ("rebase", "cmd_locate", "cmd_apply", "run_command"):
        assert (inspect.getsource(getattr(commands, name))
                == inspect.getsource(getattr(jcommands, name))), name
    for name in ("authorize_ssh_keys", "start_sshd_if_present",
                 "run_boot_sequence"):
        assert (inspect.getsource(getattr(entrypoint, name))
                == inspect.getsource(getattr(jentry, name))), name
    assert "KVEDGE_FORCE_VIRTUAL_DEVICES" not in inspect.getsource(entrypoint)


# ---- the document ------------------------------------------------------


def test_parse_rendered_document_as_the_reference():
    values = DEFAULT_VALUES.replace(publicSshKey="ssh-ed25519 KEY me@host")
    text = boot_config_document(values)
    doc = parse_boot_document(text)
    assert dataclasses.asdict(doc) == dataclasses.asdict(
        jbootdoc.parse_boot_document(text))
    assert doc.hostname == bootconfig.RUNTIME_HOSTNAME
    assert doc.ssh_authorized_keys == ("ssh-ed25519 KEY me@host",)
    assert doc.bootcmd[0][:2] == ("kvedge-bootstrap", "locate")
    assert doc.runcmd[0][:2] == ("kvedge-bootstrap", "apply")
    assert doc.runcmd[1][:2] == ("kvedge-runtime", "boot")
    assert parse_boot_document(boot_config_document(
        DEFAULT_VALUES)).ssh_authorized_keys == ()


@pytest.mark.parametrize("text", [
    "#cloud-config\nhostname: nope\n", "",
    f"{bootconfig.HEADER}\nhostname: h\nbootcmd: notalist\n",
    f"{bootconfig.HEADER}\nhostname: h\nruncmd:\n  - [1, 2]\n",
    f'{bootconfig.HEADER}\nhostname: h\nruncmd:\n  - ""\n',
], ids=["sentinel", "empty", "not-a-list", "not-strings", "empty-command"])
def test_malformed_documents_rejected(text):
    with pytest.raises(BootDocError):
        parse_boot_document(text)
    with pytest.raises(jbootdoc.BootDocError):
        jbootdoc.parse_boot_document(text)


# ---- mount and commands --------------------------------------------------


def test_locate_by_serial(tmp_path):
    disks = tmp_path / "mnt" / "disks"
    vol = disks / bootconfig.CONFIG_SERIAL
    vol.mkdir(parents=True)
    (vol / "userdata").write_text("[runtime]\n")
    link = tmp_path / "mnt" / "app-secret"
    for _ in range(2):  # idempotent: bootcmd reruns every boot
        assert mount.locate(bootconfig.CONFIG_SERIAL, str(disks),
                            str(link)) == str(vol)
    assert (link / "userdata").read_text() == "[runtime]\n"
    (disks / "WRONGSECRET").mkdir()
    with pytest.raises(mount.MountError, match="no volume with serial"):
        mount.locate("NOPE123", str(disks), str(tmp_path / "link"))
    with pytest.raises(mount.MountError, match="wrong Secret"):
        mount.locate("WRONGSECRET", str(disks), str(tmp_path / "link"))


def test_rebase():
    assert rebase("/etc/kvedge/config.toml", "/") == "/etc/kvedge/config.toml"
    assert rebase("/etc/x", "/tmp/root") == "/tmp/root/etc/x"


SOURCE = (
    '[runtime]\nname = "edge-1"\nstate_dir = "/var/lib/kvedge/state"\n'
    'heartbeat_interval_s = 2.5\n'
    '[tpu]\nplatform = "cpu"\nexpected_chips = 1\n'
    '[mesh]\naxes = { data = 0, model = 1 }\n'
    '[model]\npreset = "probe"\nn_layers = 2\n'
    '[distributed]\nnum_processes = 1\n'
    '[status]\nport = 0\nbind = "127.0.0.1"\ntoken = "t0k"\n'
    '[payload]\nkind = "eval"\ncorpus = "/state/c.kvfeed"\n'
    'eval_corpus = "/state/c.kvfeed.eval"\nseq = 64\nserving = "paged"\n'
    'serving_window = "auto"\nserving_trace = 0.5\n'
)


def test_apply_rebases_and_writes_the_canonical_toml(tmp_path):
    (tmp_path / "userdata").write_text(SOURCE)
    run_command(("kvedge-bootstrap", "apply", "--source", "/userdata",
                 "--target", "/etc/kvedge/config.toml"), root=str(tmp_path))
    text = (tmp_path / "etc" / "kvedge" / "config.toml").read_text()
    assert (tmp_path / "var/lib/kvedge/state").is_dir()
    applied = RuntimeConfig.parse(text)
    source = RuntimeConfig.parse(SOURCE)
    rebased = {k: str(tmp_path / v.lstrip("/")) for k, v in (
        ("state_dir", source.state_dir), ("train_corpus",
                                          source.train_corpus),
        ("eval_corpus", source.eval_corpus))}
    assert applied == dataclasses.replace(source, **rebased)
    # The reference parses the applied document to the same values.
    theirs = JaxConfig.parse(text)
    for field in ("name", "heartbeat_interval_s", "expected_platform",
                  "expected_chips", "status_token", "payload",
                  "serving_window", "serving_trace", "state_dir",
                  "train_corpus", "eval_corpus"):
        assert getattr(theirs, field) == getattr(applied, field), field
    assert theirs.train_seq == applied.max_seq == 64
    assert theirs.mesh.axes == applied.mesh_axes


def test_apply_rejects_bad_config(tmp_path):
    for text, match in (("not [valid toml", "invalid"),
                        ("[mesh]\naxes = { seq = 2 }\n[payload]\n"
                         'kind = "serve"\n', "'seq' axis")):
        (tmp_path / "userdata").write_text(text)
        with pytest.raises(CommandError, match=match):
            run_command(("kvedge-bootstrap", "apply", "--source",
                         "/userdata", "--target", "/etc/kvedge/config.toml"),
                        root=str(tmp_path))


def test_unknown_virtual_subcommand_and_extension_commands(tmp_path):
    with pytest.raises(CommandError, match="subcommand"):
        run_command(("kvedge-bootstrap", "frobnicate"), root=str(tmp_path))
    with pytest.raises(CommandError, match="subcommand"):
        run_command(("kvedge-runtime",), root=str(tmp_path))
    marker = tmp_path / "ran"
    run_command(("touch", str(marker)), root=str(tmp_path))
    assert marker.exists()
    with pytest.raises(CommandError, match="exited with"):
        run_command(("false",), root=str(tmp_path))


def test_locate_with_relative_root_resolves(tmp_path, monkeypatch):
    (tmp_path / "mnt/disks/SER123").mkdir(parents=True)
    (tmp_path / "mnt/disks/SER123/userdata").write_text("x = 1\n")
    monkeypatch.chdir(tmp_path)
    resolved = mount.locate(serial="SER123", search_root="./mnt/disks",
                            link="./mnt/app-secret")
    assert (tmp_path / "mnt/app-secret/userdata").read_text() == "x = 1\n"
    assert resolved == str(tmp_path / "mnt/disks/SER123")


# ---- the whole sequence ----------------------------------------------------


def _pod(tmp_path, toml: str, boot_args: str) -> pathlib.Path:
    """The chart's layout under ``tmp_path``: the config volume by serial
    and the boot document (the renderer's, with ``boot_args`` on the
    runtime boot command)."""
    vol = tmp_path / "mnt" / "disks" / bootconfig.CONFIG_SERIAL
    vol.mkdir(parents=True)
    (vol / "userdata").write_text(toml)
    doc = boot_config_document(DEFAULT_VALUES).replace(
        "kvedge-runtime boot --config /etc/kvedge/config.toml",
        f"kvedge-runtime boot --config /etc/kvedge/config.toml {boot_args}")
    secret = tmp_path / "mnt" / "boot-secret"
    secret.mkdir(parents=True)
    (secret / "userdata").write_text(doc)
    return secret / "userdata"


def _entrypoint(doc, root):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "kvedge_torch.bootstrap.entrypoint",
         "--boot-config", str(doc), "--root", str(root)],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_boot_document_applies_then_boots_once(tmp_path):
    toml = ('[runtime]\nname = "cpu-edge"\nstate_dir = "/var/lib/kvedge/state"\n'
            '[tpu]\nplatform = "cpu"\n[model]\npreset = "probe"\n'
            '[payload]\nkind = "inference-probe"\n'
            '[status]\nport = 0\nbind = "127.0.0.1"\n')
    doc = _pod(tmp_path, toml, "--once --device cpu")
    for boot in (1, 2):
        proc = _entrypoint(doc, tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert (f"payload=inference-probe ok=True devices=1 status=:"
                in proc.stdout) and f"boot_count={boot}" in proc.stdout
    state = tmp_path / "var/lib/kvedge/state"
    beat = heartbeat.read_heartbeat(str(state))
    assert beat["boot_count"] == 2 and beat["seq"] == 4 and beat["ok"]
    assert beat["check"]["platform"] == "cpu"
    assert beat["check"]["probe_checksum"] > 0
    applied = RuntimeConfig.parse(
        (tmp_path / "etc/kvedge/config.toml").read_text())
    assert applied == dataclasses.replace(RuntimeConfig.parse(toml),
                                          state_dir=str(state))
    assert (tmp_path / "mnt/app-secret/userdata").read_text() == toml


def test_boot_document_failures_exit_nonzero(tmp_path):
    doc = _pod(tmp_path, '[payload]\nkind = "train"\n', "--once --device cpu")
    proc = _entrypoint(doc, tmp_path)
    assert proc.returncode == 1
    assert "boot failed: injected config is invalid" in proc.stdout
    assert "requires corpus" in proc.stdout


def test_a_degraded_boot_still_completes_its_cycle(tmp_path):
    """A config for the TPU on this host degrades the boot (the device
    check's message), it does not fail the document."""
    doc = _pod(tmp_path, '[runtime]\nstate_dir = "/s"\n[tpu]\nplatform = '
               '"tpu"\n[status]\nport = 0\nbind = "127.0.0.1"\n',
               "--once --device cpu")
    proc = _entrypoint(doc, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert ("DEGRADED: expected platform 'tpu', got 'cpu'" in proc.stdout)
    beat = heartbeat.read_heartbeat(str(tmp_path / "s"))
    assert beat["ok"] is False and beat["payload"] == "devicecheck"


# ---- the health probe --------------------------------------------------


def _serve(healthy_fn, detail=None):
    server = StatusServer("127.0.0.1", 0, snapshot=lambda: {"ok": True},
                          healthy=healthy_fn, health_detail=detail)
    server.start()
    return server


def test_healthy_immediately_and_cli_exit_codes():
    server = _serve(lambda: True)
    try:
        url = f"http://127.0.0.1:{server.port}/healthz"
        ok, detail = hc.wait_healthy(url, deadline_s=5)
        assert ok and "200" in detail
        assert hc.main([url, "--deadline", "5"]) == 0
    finally:
        server.shutdown()
    assert hc.main(["http://127.0.0.1:1/healthz", "--deadline", "0.3",
                    "--interval", "0.1"]) == 1


def test_degraded_times_out_with_last_error():
    server = _serve(lambda: False)
    try:
        ok, detail = hc.wait_healthy(
            f"http://127.0.0.1:{server.port}/healthz", deadline_s=0.5,
            interval_s=0.1)
        assert not ok and "503" in detail and "degraded" in detail
    finally:
        server.shutdown()


def test_polls_through_booting_and_recovering_fails_fast_on_terminal():
    state = {"doc": {"reason": "boot in progress"}}
    healthy = threading.Event()
    server = _serve(healthy.is_set, lambda: state["doc"])
    try:
        url = f"http://127.0.0.1:{server.port}/healthz"
        threading.Timer(0.3, healthy.set).start()
        assert hc.wait_healthy(url, deadline_s=10, interval_s=0.05)[0]
        healthy.clear()
        state["doc"] = {"reason": "pool poisoned", "terminal": False,
                        "recovering": True, "retry_after_s": 1.0}
        threading.Timer(0.3, healthy.set).start()
        assert hc.wait_healthy(url, deadline_s=10, interval_s=0.05)[0]
        healthy.clear()
        state["doc"] = {"reason": "pool poisoned", "terminal": True}
        ok, detail = hc.wait_healthy(url, deadline_s=30, interval_s=0.05)
        theirs = jhc.wait_healthy(url, deadline_s=30, interval_s=0.05)
        assert (ok, detail) == theirs
        assert not ok and json.loads(
            detail.split(": ", 1)[1].strip("'"))["terminal"] is True
    finally:
        server.shutdown()


def test_unreachable_endpoint_times_out():
    ok, detail = hc.wait_healthy("http://127.0.0.1:1/healthz",
                                 deadline_s=0.4, interval_s=0.1)
    assert not ok and detail
