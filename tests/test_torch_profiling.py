"""The port's on-demand profiler (``kvedge_torch/runtime/profiling.py``)
and its HTTP routes, on the CPU, mirroring the JAX package's
``tests/test_profiling.py``.

``POST /profile?seconds=N`` captures a bounded ``torch.profiler`` trace
into ``<state_dir>/traces/trace-NNNN/trace.json.gz``; captures are
numbered past the ones already on the volume, the newest ``keep`` are
retained, a concurrent capture is refused (409) and a booting runtime
refuses with 503. The profiler starts and stops inside the ``quiet()``
context manager, which the runtime wires to the serve payload's work
lock. The routes answer as the reference's do, the JAX server's status
codes held beside the port's.
"""

import gzip
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kvedge_tpu.runtime.status import StatusServer as JaxStatusServer
from kvedge_torch.runtime import profiling
from kvedge_torch.runtime.profiling import (
    TRACE_FILE,
    CaptureBusy,
    CaptureUnavailable,
    TraceCapture,
)
from kvedge_torch.runtime.status import StatusServer


def _cap(tmp_path, **kw):
    return TraceCapture(str(tmp_path), device="cpu", **kw)


def test_capture_writes_a_chrome_trace(tmp_path):
    doc = _cap(tmp_path).capture(seconds=0.2)
    assert doc["trace_dir"].startswith(str(tmp_path / "traces"))
    assert doc["files"] == 1 and doc["bytes"] > 0
    assert doc["duration_s"] >= 0.2
    with gzip.open(f"{doc['trace_dir']}/{TRACE_FILE}", "rt") as fh:
        events = json.load(fh)["traceEvents"]
    # The default activity (one matmul) makes the trace non-empty.
    assert any(ev.get("name") == "aten::mm" for ev in events)


def test_captures_are_sequenced_not_overwritten(tmp_path):
    cap = _cap(tmp_path, activity=None)
    first = cap.capture(seconds=0.1)
    second = cap.capture(seconds=0.1)
    assert first["trace_dir"] != second["trace_dir"]


def test_seq_resumes_past_traces_from_a_previous_boot(tmp_path):
    first = _cap(tmp_path, activity=None).capture(seconds=0.1)
    second = _cap(tmp_path, activity=None).capture(seconds=0.1)
    assert first["trace_dir"].endswith("trace-0001")
    assert second["trace_dir"].endswith("trace-0002")


def test_retention_keeps_only_newest(tmp_path):
    cap = _cap(tmp_path, keep=2, activity=None)
    for _ in range(3):
        cap.capture(seconds=0.1)
    remaining = sorted((tmp_path / "traces").iterdir())
    assert [p.name for p in remaining] == ["trace-0002", "trace-0003"]
    assert [t["name"] for t in cap.list()] == ["trace-0002", "trace-0003"]


def test_retention_is_numeric_past_trace_9999(tmp_path):
    traces = tmp_path / "traces"
    traces.mkdir()
    for seq in (9998, 9999):
        (traces / f"trace-{seq:04d}").mkdir()
    cap = _cap(tmp_path, keep=2, activity=None)
    doc = cap.capture(seconds=0.1)
    assert doc["trace_dir"].endswith("trace-10000")
    assert doc["files"] > 0
    remaining = sorted(p.name for p in traces.iterdir())
    assert remaining == ["trace-10000", "trace-9999"]


def test_list_has_the_reference_keys(tmp_path):
    cap = _cap(tmp_path, activity=None)
    assert cap.list() == []
    cap.capture(seconds=0.1)
    (entry,) = cap.list()
    assert set(entry) == {"name", "seq", "age_s", "files", "bytes"}
    assert entry["seq"] == 1 and entry["files"] == 1 and entry["bytes"] > 0


def test_long_capture_sleeps_between_activity_runs(tmp_path):
    calls = []
    cap = _cap(tmp_path, activity=lambda: calls.append(1))
    cap.capture(seconds=0.7)
    assert 1 <= len(calls) <= 3


def test_concurrent_capture_is_refused(tmp_path):
    release = threading.Event()
    cap = _cap(tmp_path, activity=lambda: release.wait(timeout=5))
    results = {}

    def long_capture():
        results["first"] = cap.capture(seconds=0.3)

    t = threading.Thread(target=long_capture)
    t.start()
    time.sleep(0.05)  # let the first capture take the lock
    with pytest.raises(CaptureBusy):
        cap.capture(seconds=0.1)
    release.set()
    t.join(timeout=30)
    assert not t.is_alive() and results["first"]["files"] == 1


def test_a_profiler_already_running_refuses_the_capture(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cap = _cap(tmp_path, activity=None)
    outer = profile(activities=[ProfilerActivity.CPU])
    outer.start()
    try:
        with pytest.raises(CaptureBusy, match="already running"):
            cap.capture(0.1)
    finally:
        outer.stop()  # still running: the capture did not end it
    assert cap.capture(0.1)["trace_dir"].endswith("trace-0001")


def test_the_profiler_starts_only_once_device_work_is_held_off(tmp_path):
    """``quiet()`` (the serve payload's work lock, in a runtime) is held
    elsewhere: the capture waits for it before starting the profiler,
    and takes it again to stop."""
    work = threading.Lock()
    entered = []

    def quiet():
        entered.append(1)
        return work

    cap = _cap(tmp_path, activity=None, quiet=quiet)
    done = threading.Event()
    work.acquire()
    try:
        t = threading.Thread(target=lambda: (cap.capture(0.1), done.set()))
        t.start()
        time.sleep(0.3)
        assert not done.is_set()  # waiting on the payload's device work
    finally:
        work.release()
    t.join(timeout=30)
    assert not t.is_alive() and done.is_set()
    assert len(entered) == 2 and not work.locked()  # start and stop


def test_the_trace_is_written_with_device_work_released(tmp_path,
                                                        monkeypatch):
    """Only the two toggles hold ``quiet()``: the trace's writing (its
    JSON and gzip, seconds on the card) runs after device work is let go,
    so serving pauses for the disable alone."""
    work = threading.Lock()
    held_while_writing = []
    write = profiling._write_trace

    def spy(results, path):
        held_while_writing.append(work.locked())
        write(results, path)

    monkeypatch.setattr(profiling, "_write_trace", spy)
    doc = _cap(tmp_path, activity=None, quiet=lambda: work).capture(0.1)
    assert held_while_writing == [False]
    assert doc["files"] == 1 and doc["start_s"] >= 0 and doc["stop_s"] >= 0


# ---- HTTP routes ---------------------------------------------------------


def _post(url: str, headers: dict | None = None) -> tuple[int, dict]:
    req = urllib.request.Request(url, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def servers(tmp_path):
    """The port's and the JAX package's servers over one capture each
    (the JAX one's profiler is a stand-in: its route, not jax.profiler,
    is under test)."""
    cap = _cap(tmp_path / "torch", activity=None)
    ours = StatusServer("127.0.0.1", 0, snapshot=lambda: {"ok": True},
                        profiler=cap.capture, profile_traces=cap.list)
    theirs = JaxStatusServer(
        "127.0.0.1", 0, snapshot=lambda: {"ok": True},
        profiler=lambda s: {"trace_dir": "", "duration_s": s, "files": 1,
                            "bytes": 1},
        profile_traces=list)
    ours.start()
    theirs.start()
    yield ours, theirs
    ours.shutdown()
    theirs.shutdown()


def test_post_profile_returns_trace_summary_and_lists_it(servers, tmp_path):
    ours, theirs = servers
    code, doc = _post(f"http://127.0.0.1:{ours.port}/profile?seconds=0.2")
    assert code == 200 and doc["files"] == 1
    assert set(doc) == {"trace_dir", "duration_s", "files", "bytes",
                        "start_s", "stop_s", "export_s"}
    code, listed = _get(f"http://127.0.0.1:{ours.port}/profile/traces")
    assert code == 200
    assert [t["name"] for t in listed["traces"]] == ["trace-0001"]
    assert _get(f"http://127.0.0.1:{theirs.port}/profile/traces")[0] == 200


@pytest.mark.parametrize("method,path,want", [
    ("GET", "/profile", 405),
    ("POST", "/profile?seconds=abc", 400),
])
def test_profile_route_errors_match_the_reference(servers, method, path,
                                                  want):
    for srv in servers:
        url = f"http://127.0.0.1:{srv.port}{path}"
        code = (_post(url) if method == "POST" else _get(url))[0]
        assert code == want


@pytest.fixture
def gated_server(tmp_path):
    cap = _cap(tmp_path, activity=None)
    srv = StatusServer("127.0.0.1", 0, snapshot=lambda: {"ok": True},
                       profiler=cap.capture, token="sekrit-tok")
    srv.start()
    yield srv
    srv.shutdown()


@pytest.mark.parametrize("headers", [
    {}, {"Authorization": "Bearer wrong"},
    {"Authorization": "Bearer sekr\xedt"},
], ids=["none", "wrong", "non-ascii"])
def test_post_profile_without_the_bearer_token_is_401(gated_server,
                                                      tmp_path, headers):
    code, doc = _post(
        f"http://127.0.0.1:{gated_server.port}/profile?seconds=0.1",
        headers=headers)
    assert code == 401 and "Bearer" in doc["error"]
    assert not (tmp_path / "traces").exists()  # nothing captured


def test_bearer_token_post_profile_succeeds(gated_server):
    code, doc = _post(
        f"http://127.0.0.1:{gated_server.port}/profile?seconds=0.1",
        headers={"Authorization": "Bearer sekrit-tok"})
    assert code == 200 and doc["files"] == 1
    for path in ("/status", "/healthz"):  # GET stays open
        assert _get(f"http://127.0.0.1:{gated_server.port}{path}")[0] == 200


@pytest.mark.parametrize("server_cls", [StatusServer, JaxStatusServer],
                         ids=["torch", "jax"])
def test_post_profile_while_booting_or_unwired_is_503(server_cls):
    def gated(seconds):
        raise CaptureUnavailable("runtime is still booting")

    if server_cls is JaxStatusServer:
        from kvedge_tpu.runtime.profiling import (
            CaptureUnavailable as JaxUnavailable,
        )

        def gated(seconds):  # noqa: F811 - the reference's exception
            raise JaxUnavailable("runtime is still booting")

    for kw in ({"profiler": gated}, {}):
        srv = server_cls("127.0.0.1", 0, snapshot=lambda: {"ok": True}, **kw)
        srv.start()
        try:
            code, doc = _post(f"http://127.0.0.1:{srv.port}/profile")
            assert code == 503
            if kw:
                assert "booting" in doc["error"]
            else:
                assert doc == {"error": "profiler not available"}
                assert _get(f"http://127.0.0.1:{srv.port}/profile/traces"
                            ) == (503, {"error": "profiler not available"})
        finally:
            srv.shutdown()


def test_a_busy_capture_is_409(tmp_path):
    release = threading.Event()
    cap = _cap(tmp_path, activity=lambda: release.wait(timeout=5))
    srv = StatusServer("127.0.0.1", 0, snapshot=lambda: {"ok": True},
                       profiler=cap.capture)
    srv.start()
    try:
        t = threading.Thread(target=cap.capture, args=(0.3,))
        t.start()
        time.sleep(0.05)
        code, doc = _post(f"http://127.0.0.1:{srv.port}/profile?seconds=0.1")
        assert code == 409 and "already running" in doc["error"]
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        srv.shutdown()
