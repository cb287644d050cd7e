"""The port's HTTP surface end to end on the CPU (2-layer probe model,
fp32): request ids, the reconnect log, and the observability routes.

* A streamed request dropped after k tokens and reconnected with its
  ``X-Request-Id`` and ``emitted_offset = k`` stitches to the
  uninterrupted tokens, streamed and buffered, with no duplicate and no
  gap; so does a buffered request re-asked at offset 0; and a streamed
  one across a poison and the supervisor's revive.
* An unknown id is a 400; ``emitted_offset`` with checkpoints off is the
  reference's 400.
* ``/status``, ``/metrics``, ``/trace``, ``/slo``, ``/debug/bundle`` and
  ``/version`` answer on a booted runtime; each optional route is a 404
  naming its knob while that is off; ``/profile`` answers as the
  reference's unwired profiler; ``[status] token`` refuses a POST
  without the bearer token, and the GET surface stays open.
"""

import http.client
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.serve import boot_serve
from kvedge_torch.testing.servingfaults import FaultPlan, FaultyCache

torch.set_num_threads(2)

BOUND_S = 60.0
PROMPT = [[3, 1, 4, 1, 5, 9, 2, 6]]
N_NEW = 40


def _cfg(tmp_path, **kw):
    base = dict(preset="probe", n_layers=2, max_seq=64,
                payload_serving="paged", serving_slots=2,
                serving_page_size=4, serving_prefill_chunk=8,
                serving_window=4, serving_prefix_cache=False,
                state_dir=str(tmp_path))
    base.update(kw)
    return ServeConfig(**base)


def _runtime(tmp_path, **kw):
    return boot_serve(_cfg(tmp_path, **kw), device="cpu",
                      dtype="float32", host="127.0.0.1", port=0)


def _request(rt, method, path, doc=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{rt.port}{path}", method=method,
        data=None if doc is None else json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=BOUND_S) as r:
            body = r.read()
            return r.status, body, dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(rt, doc, headers=None):
    code, body, hdrs = _request(rt, "POST", "/generate", doc, headers)
    return code, json.loads(body), hdrs


def _get(rt, path):
    code, body, hdrs = _request(rt, "GET", path)
    return code, body


def _stream_then_drop(rt, rid, k):
    """A streamed request read for its first ``k`` token records, then
    the connection closed. Returns those tokens."""
    conn = http.client.HTTPConnection("127.0.0.1", rt.port, timeout=BOUND_S)
    body = json.dumps({"tokens": PROMPT, "n_new": N_NEW, "stream": True})
    conn.request("POST", "/generate", body,
                 {"Content-Type": "application/json", "X-Request-Id": rid})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("X-Request-Id") == rid
    got = []
    while len(got) < k:
        rec = json.loads(resp.fp.readline())
        got.append(rec["token"])
    conn.close()
    return got


def _stream_records(rt, doc, headers):
    code, body, hdrs = _request(rt, "POST", "/generate", doc, headers)
    assert code == 200, body
    return [json.loads(line) for line in body.splitlines()], hdrs


def _want(rt):
    code, doc, _ = _post(rt, {"tokens": PROMPT, "n_new": N_NEW})
    assert code == 200
    return doc["tokens"][0][len(PROMPT[0]):]


@pytest.mark.parametrize("k", [1, 7])
def test_dropped_stream_reconnects_without_duplicates_or_gaps(tmp_path, k):
    rt = _runtime(tmp_path, serving_checkpoint_every=2)
    try:
        want = _want(rt)
        head = _stream_then_drop(rt, f"cli-{k}", k)
        # Streamed reconnect.
        recs, hdrs = _stream_records(
            rt, {"emitted_offset": k, "stream": True},
            {"X-Request-Id": f"cli-{k}"})
        assert hdrs["X-Request-Id"] == f"cli-{k}"
        tail = [r["token"] for r in recs if "token" in r]
        done = recs[-1]
        assert done["done"] is True and done["resumed_at"] == [k]
        assert done["tokens"] == [tail]
        assert head + tail == want
        # Buffered reconnect of the same request, at another offset.
        code, doc, _ = _post(rt, {"emitted_offset": [k + 2]},
                             {"X-Request-Id": f"cli-{k}"})
        assert code == 200 and doc["resumed_at"] == [k + 2]
        assert head + tail[:2] + doc["tokens"][0] == want
    finally:
        rt.close()


def test_buffered_request_reasked_at_offset_zero(tmp_path):
    rt = _runtime(tmp_path, serving_checkpoint_every=2)
    try:
        code, first, hdrs = _post(rt, {"tokens": PROMPT, "n_new": N_NEW},
                                  {"X-Request-Id": "buf-1"})
        assert code == 200 and first["request_id"] == "buf-1"
        assert hdrs["X-Request-Id"] == "buf-1"
        code, again, _ = _post(rt, {"emitted_offset": 0},
                               {"X-Request-Id": "buf-1"})
        assert code == 200
        assert PROMPT[0] + again["tokens"][0] == first["tokens"][0]
    finally:
        rt.close()


def test_dropped_stream_reconnects_across_a_poison_and_revive(tmp_path):
    rt = _runtime(tmp_path, serving_checkpoint_every=1,
                  serving_overlap="on")
    try:
        want = _want(rt)
        # The third harvest from here raises: the request, checkpointed
        # at every boundary, parks in the journal and resumes after the
        # supervisor's revive.
        FaultyCache.arm(rt.server._cache, FaultPlan(
            seed=0, kinds=("raise",), fire_window=(2, 3),
            seams=("wharvest",)))
        head = _stream_then_drop(rt, "cli-revive", 1)
        recs, _ = _stream_records(rt, {"emitted_offset": 1, "stream": True},
                                  {"X-Request-Id": "cli-revive"})
        tail = [r["token"] for r in recs if "token" in r]
        assert recs[-1]["done"] is True
        assert head + tail == want
        st = rt.stats()
        assert st["journal_restores_total"] >= 1
        assert st["recoveries_total"] == 1
    finally:
        rt.close()


def test_unknown_id_and_checkpoints_off_are_400s(tmp_path):
    rt = _runtime(tmp_path, serving_checkpoint_every=2)
    try:
        code, doc, _ = _post(rt, {"emitted_offset": 0},
                             {"X-Request-Id": "never-issued"})
        assert code == 400 and "unknown or expired" in doc["error"]
        code, doc, _ = _post(rt, {"emitted_offset": 0})
        assert code == 400 and "original request id" in doc["error"]
        _post(rt, {"tokens": PROMPT, "n_new": 4}, {"X-Request-Id": "x-1"})
        code, doc, _ = _post(rt, {"emitted_offset": 5},
                             {"X-Request-Id": "x-1"})
        assert code == 400 and "emitted_offset" in doc["error"]
    finally:
        rt.close()
    rt = _runtime(tmp_path / "off")
    try:
        assert rt.resume_log is None
        code, doc, _ = _post(rt, {"emitted_offset": 0},
                             {"X-Request-Id": "x-1"})
        assert code == 400
        assert "serving_checkpoint_every > 0" in doc["error"]
        # A bad header is cleaned away and a fresh id minted.
        code, doc, hdrs = _post(rt, {"tokens": PROMPT, "n_new": 2},
                                {"X-Request-Id": "bad id!"})
        assert code == 200 and doc["request_id"].startswith("req-")
        assert hdrs["X-Request-Id"] == doc["request_id"]
    finally:
        rt.close()


# ---- the routes --------------------------------------------------------------


def test_routes_on_a_booted_runtime(tmp_path):
    rt = _runtime(tmp_path, serving_trace="on", serving_slo=True,
                  serving_bundle=True, serving_occupancy_ring=32,
                  serving_window="auto")
    try:
        code, doc, _ = _post(rt, {"tokens": PROMPT, "n_new": 6},
                             {"X-Request-Id": "route-1"})
        assert code == 200 and doc["request_id"] == "route-1"
        code, body = _get(rt, "/status")
        status = json.loads(body)
        assert code == 200 and status["ok"] is True
        serving = status["serving"]
        assert serving["requests_total"] == serving["completed_total"] == 1
        assert serving["backend"] == "paged"
        assert serving["ttft_ms"]["count"] >= 1
        code, body = _get(rt, "/metrics")
        text = body.decode()
        assert code == 200
        for family in ("kvedge_up", "kvedge_serve_requests_total",
                       "kvedge_serve_ttft_ms_count",
                       "kvedge_serve_itl_ms_count",
                       "kvedge_serve_device_ms_window_count",
                       "kvedge_serve_autotune_window",
                       "kvedge_serve_slo_snapshots_total",
                       "kvedge_serve_trace_events_total",
                       "kvedge_serve_occupancy_pages_total"):
            assert f"\n{family}" in text, family
        code, body = _get(rt, "/trace")
        trace = json.loads(body)
        assert code == 200
        assert "route-1" in {ev.get("args", {}).get("rid")
                             for ev in trace["traceEvents"]}
        code, body = _get(rt, "/slo")
        assert code == 200 and json.loads(body)["snapshots_total"] >= 1
        code, body = _get(rt, "/debug/bundle")
        bundle = json.loads(body)
        assert code == 200 and bundle["bundle_version"] == 1
        assert bundle["degraded"] == 0 and bundle["occupancy_tail"]
        assert len(bundle["config_fingerprint"]) == 12
        code, body = _get(rt, "/version")
        assert code == 200 and json.loads(body)["version"]
        code, body = _get(rt, "/healthz")
        assert code == 200 and json.loads(body) == {"status": "ok"}
    finally:
        rt.close()


def test_optional_routes_404_when_off_and_profile_unwired(tmp_path):
    rt = _runtime(tmp_path)
    try:
        for path, knob in (("/trace", "serving_trace"),
                           ("/slo", "serving_slo"),
                           ("/debug/bundle", "serving_bundle")):
            code, body = _get(rt, path)
            assert code == 404 and knob in json.loads(body)["error"]
        # The runtime serves /profile since boot_serve boots
        # through start_runtime: no capture on disk yet, GET is a 405
        # and a malformed window a 400 (nothing is captured).
        code, body = _get(rt, "/profile/traces")
        assert code == 200 and json.loads(body) == {"traces": []}
        assert _get(rt, "/profile")[0] == 405
        assert _request(rt, "POST", "/profile?seconds=x", {})[0] == 400
        assert _get(rt, "/nope")[0] == 404
    finally:
        rt.close()


def test_bearer_token_gates_post_only(tmp_path):
    rt = _runtime(tmp_path, status_token="s3cret")
    try:
        code, doc, hdrs = _post(rt, {"tokens": PROMPT, "n_new": 2})
        assert code == 401 and hdrs["WWW-Authenticate"] == "Bearer"
        code, doc, _ = _post(rt, {"tokens": PROMPT, "n_new": 2},
                             {"Authorization": "Bearer wrong"})
        assert code == 401
        code, doc, _ = _post(rt, {"tokens": PROMPT, "n_new": 2},
                             {"Authorization": "Bearer s3cret"})
        assert code == 200
        assert _request(rt, "POST", "/profile", {})[0] == 401
        # Past the gate the runtime's profiler answers (a malformed
        # window: a 400, nothing captured).
        assert _request(rt, "POST", "/profile?seconds=x", {},
                        {"Authorization": "Bearer s3cret"})[0] == 400
        for path in ("/healthz", "/status", "/metrics"):
            assert _get(rt, path)[0] == 200, path
        # The refused POSTs never reached the serving backend.
        assert rt.stats()["requests_total"] == 1
    finally:
        rt.close()


def test_request_counters_map_outcomes(tmp_path):
    rt = _runtime(tmp_path, serving_checkpoint_every=2)
    try:
        _post(rt, {"tokens": PROMPT, "n_new": 3})
        _post(rt, {"tokens": PROMPT, "n_new": 0})          # 400
        recs, _ = _stream_records(rt, {"tokens": PROMPT, "n_new": 3,
                                       "stream": True}, {})
        assert recs[-1]["done"] is True
        deadline = time.monotonic() + BOUND_S
        while rt.stats()["completed_total"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        st = rt.stats()
        assert st["requests_total"] == 3
        assert st["rejected_total"] == 1 and st["errors_total"] == 0
        assert st["tokens_generated_total"] == 6
        assert st["latency_ms_sum"] > 0
    finally:
        rt.close()
