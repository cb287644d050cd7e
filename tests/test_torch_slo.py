"""The SLO engine, the occupancy ring and the flight bundle in the port,
against the JAX package, at small shapes (vocab 128, d_model 32, 4
heads, 2 kv heads, 2 layers, page 4, fp32) on the CPU.

* One sequence of boundary snapshots gives the JAX engine's documents,
  SLIs, burn rates and alerts.
* The burn-gated shed (``slo_shed``) sheds a batch arrival while the
  alert fires and never the top class; ``slo_shed`` without objectives
  is refused.
* The SLO engine and the occupancy ring on return the tokens of both
  off, bit for bit (overlap on and off, spec windows).
* After a poison the bundle is complete and its parts agree (metrics,
  page books, journal); the serve payload writes it beside
  ``last-failure.json`` with the trace tail in the record; one set of
  knobs gives the JAX server's ``config_fingerprint``.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.runtime import slo as jslo
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer, ServerOverloaded
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import heartbeat
from kvedge_torch.runtime import slo as tslo
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.failures import ServingFailure
from kvedge_torch.runtime.serve import ServeRuntime
from kvedge_torch.runtime.status import GenerateUnavailable
from kvedge_torch.runtime.tracing import POSTMORTEM_EVENTS, Tracer
from kvedge_torch.testing.servingfaults import FaultPlan, FaultyCache

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")
OBS = dict(slo=tslo.SloObjectives(fast_window_s=1.0, slow_window_s=10.0),
           occupancy_ring=64)


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _server(models, **kw):
    _, tcfg, _, tparams = models
    kw.setdefault("slots", 2)
    kw.setdefault("pages", 24)
    kw.setdefault("page_size", 4)
    kw.setdefault("window", 4)
    return PagedGenerationServer(tparams, tcfg, device="cpu", **kw)


def _sampling(k):
    return np.asarray(jax.random.PRNGKey(k), np.uint32), 0.8, 0.9


TRAFFIC = [([5, 9, 2, 7], 9, None), ([1, 2, 3, 4], 12, 3),
           ([8, 8, 1], 7, None), ([3, 1, 4, 1, 5], 10, 5)]


def _drive(server):
    return [server.submit(p, n, sampling=_sampling(s) if s else None)
            for p, n, s in TRAFFIC]


# ---- the engine against the reference's ------------------------------------


def _snapshots(seed: int, n: int) -> list:
    """Cumulative snapshots a server would hand the engine: histograms on
    the reference's stage edges and counters, growing, with one reset."""
    rng = np.random.default_rng(seed)
    edges = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
             2000.0, 5000.0)
    counts = {k: np.zeros(len(edges) + 1, int) for k in
              ("ttft_ms", "itl_ms", "queue_ms")}
    sums = dict.fromkeys(counts, 0.0)
    totals = {"tokens_total": 0, "done_total": 0, "shed_total": 0}
    out = []
    for i in range(n):
        if i == n - 3:  # a rebuilt pool: counters restart
            counts = {k: np.zeros_like(v) for k, v in counts.items()}
            sums = dict.fromkeys(counts, 0.0)
            totals = dict.fromkeys(totals, 0)
        for k in counts:
            for _ in range(int(rng.integers(0, 4))):
                v = float(rng.exponential(300.0 if k == "ttft_ms" else 40.0))
                counts[k][int(np.searchsorted(edges, v))] += 1
                sums[k] += v
        done = int(rng.integers(0, 3))
        totals["done_total"] += done
        totals["tokens_total"] += done * int(rng.integers(4, 40))
        totals["shed_total"] += int(rng.integers(0, 2))
        snap = {k: {"edges": list(edges), "counts": [int(c) for c in v],
                    "sum": sums[k], "count": int(v.sum())}
                for k, v in counts.items()}
        snap.update(totals)
        out.append((0.25 * i, snap))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_documents_and_burns_equal_the_reference(seed):
    obj = dict(target=0.95, ttft_ms=400.0, itl_ms=50.0, queue_ms=100.0,
               fast_window_s=1.0, slow_window_s=4.0)
    ours = tslo.SloEngine(tslo.SloObjectives(**obj), ring=16)
    theirs = jslo.SloEngine(jslo.SloObjectives(**obj), ring=16)
    for t, snap in _snapshots(seed, 40):
        assert ours.observe(t, snap) == theirs.observe(t, snap)
        assert ours.doc(now=t) == theirs.doc(now=t)
        for w in (obj["fast_window_s"], obj["slow_window_s"]):
            assert ours.burn(w, now=t) == theirs.burn(w, now=t)
        assert ours.alert(now=t) == theirs.alert(now=t)
        assert ours.metrics() == theirs.metrics()
    assert ours.resets_total == theirs.resets_total == 1
    ring_t, ring_j = tslo.OccupancyRing(8), jslo.OccupancyRing(8)
    for i in range(12):
        fields = {"pages_live": i, "bucket": 1 << (i % 3)}
        ring_t.sample(0.1 * i, fields)
        ring_j.sample(0.1 * i, fields)
    assert ring_t.tail() == ring_j.tail()
    assert ring_t.chrome_counters(0.0) == ring_j.chrome_counters(0.0)


# ---- the shed gate ----------------------------------------------------------


def test_burn_gated_shed_protects_the_top_class(models):
    server = _server(models, slo=tslo.SloObjectives(), slo_shed=True)
    try:
        assert server._sched.burn_input is not None
        assert server.submit([5, 9, 2], 2, priority="batch")
        # The alert hot: a batch arrival sheds with the burn reason, the
        # top class never does.
        server._sched.burn_input = lambda: True
        with pytest.raises(ServerOverloaded, match="burn-rate"):
            server.submit([5, 9, 2], 2, priority="batch")
        assert server.submit([5, 9, 2], 2, priority="interactive")
        assert server.stats()["sched_shed_total"] == 1
    finally:
        server.close()


def test_burn_gated_shed_fires_from_measured_traffic(models):
    """Objectives no request can meet: once both windows hold snapshots
    the alert fires from the server's own histograms and a batch arrival
    sheds; interactive requests still run."""
    slo = tslo.SloObjectives(ttft_ms=1e-6, itl_ms=1e-6, queue_ms=1e-6,
                             fast_window_s=0.05, slow_window_s=0.1)
    server = _server(models, slo=slo, slo_shed=True)
    try:
        deadline = time.monotonic() + 60
        while not server._slo.alert():
            assert time.monotonic() < deadline, "the alert never fired"
            server.submit([5, 9, 2], 3)
            time.sleep(0.02)
        with pytest.raises(ServerOverloaded, match="burn-rate"):
            server.submit([5, 9, 2], 2, priority="batch")
        assert server.submit([5, 9, 2], 2)
        assert server.stats()["slo_alert"] == 1
    finally:
        server.close()


def test_slo_shed_without_objectives_is_refused(models):
    server = _server(models)
    try:
        assert server._sched.burn_input is None
        assert server._slo is None and server._occ_ring is None
    finally:
        server.close()
    with pytest.raises(ValueError, match="slo_shed"):
        _server(models, slo_shed=True)


@pytest.mark.parametrize("shape", [dict(overlap="on"), dict(overlap="off"),
                                   dict(speculative=2, spec_window=2)],
                         ids=["overlap", "serial", "spec-windows"])
def test_slo_and_ring_on_equal_off_bit_for_bit(models, shape):
    off = _server(models, **shape)
    try:
        want = _drive(off)
    finally:
        off.close()
    on = _server(models, **shape, **OBS)
    try:
        assert _drive(on) == want
        stats = on.stats()
    finally:
        on.close()
    assert stats["slo_snapshots_total"] >= 1
    assert stats["occupancy_samples_total"] >= 1
    assert stats["occupancy_pages_total"] == 24


# ---- the flight bundle -------------------------------------------------------


def test_bundle_after_a_poison_is_complete_and_consistent(models):
    tracer = Tracer(sample=1.0)
    server = _server(models, overlap="on", tracer=tracer,
                     checkpoint_every=1, **OBS)
    errors = []

    def journaled():
        # Checkpointed before the fault, this request parks in the
        # journal at the poison; the close fails it.
        try:
            server.submit([3, 1, 4], 20, request_id="req-b")
        except Exception as e:
            errors.append(e)

    waiter = threading.Thread(target=journaled)
    try:
        server.submit([3, 1, 4, 1, 5], 4, request_id="req-a")
        FaultyCache.arm(server._cache, FaultPlan(
            seed=0, kinds=("raise",), fire_window=(1, 2),
            seams=("wharvest",)))
        waiter.start()
        deadline = time.monotonic() + 60
        while server.degraded is None:
            assert time.monotonic() < deadline, "pool never poisoned"
            time.sleep(0.002)
        server._thread.join(timeout=60)
        bundle = server.flight_bundle()
        stats = server.stats()
    finally:
        server.close()
        waiter.join(timeout=60)
    assert len(errors) == 1 and isinstance(errors[0], ServingFailure)
    assert bundle["journal"]["entries"] == 1
    json.dumps(bundle)
    assert bundle["bundle_version"] == 1
    assert bundle["degraded"] == 1 and bundle["reason"]
    assert bundle["slo"] is not None and bundle["occupancy_tail"]
    assert len(bundle["config_fingerprint"]) == 12
    assert bundle["config"]["slots"] == 2
    assert bundle["config"]["slo"]["fast_window_s"] == 1.0
    books, metrics = bundle["page_accounting"], bundle["metrics"]
    assert books["free"] + books["live"] == books["pages_total"]
    assert metrics["free_pages"] == books["free"]
    assert metrics["pages_total"] == bundle["config"]["pages_total"]
    assert metrics["journal_entries"] == bundle["journal"]["entries"]
    assert metrics["journal_bytes"] == bundle["journal"]["bytes"]
    assert metrics["journal_shadow_bytes"] == bundle["journal"][
        "extra_bytes"]
    assert metrics["degraded"] == 1
    assert "poison" in {e["name"] for e in bundle["trace_tail"]}
    assert {"name", "cat", "t_ms"} <= set(bundle["trace_tail"][0])
    for key in stats:
        if key.startswith("slo_"):
            assert metrics[key] == stats[key], key


KNOBS = [dict(),
         dict(window="auto", overlap="off", prefill_chunk=8,
              checkpoint_every=4, page_low_watermark=0.25,
              page_high_watermark=0.5, prefix_cache=False),
         dict(speculative=2, spec_window=2, kv_dtype="int8", slo=True)]


@pytest.mark.parametrize("knobs", KNOBS, ids=["default", "window-auto",
                                              "spec-int8-slo"])
def test_config_fingerprint_equals_the_reference(models, knobs):
    jcfg, tcfg, jparams, tparams = models
    knobs = dict(knobs)
    slo = knobs.pop("slo", False)
    kw = {**dict(slots=2, pages=24, page_size=4, window=4), **knobs}
    jax_server = JaxServer(jparams, jcfg,
                           slo=jslo.SloObjectives() if slo else None, **kw)
    port = PagedGenerationServer(tparams, tcfg, device="cpu",
                                 slo=tslo.SloObjectives() if slo else None,
                                 **kw)
    try:
        ours, theirs = port.flight_bundle(), jax_server.flight_bundle()
    finally:
        port.close()
        jax_server.close()
    assert ours["config"] == theirs["config"]
    assert ours["config_fingerprint"] == theirs["config_fingerprint"]


def test_serve_payload_writes_the_bundle_beside_last_failure(tmp_path):
    cfg = ServeConfig(preset="probe", n_layers=2, max_seq=64,
                      payload_serving="paged", serving_slots=2,
                      serving_page_size=4, serving_prefill_chunk=8,
                      serving_window=4, serving_trace="on",
                      serving_slo=True, serving_bundle=True,
                      serving_occupancy_ring=64,
                      serving_recovery_attempts=0,
                      state_dir=str(tmp_path))
    rt = ServeRuntime(cfg, device="cpu", dtype="float32")
    try:
        assert rt.serve_fn({"tokens": [[1, 2, 3]], "n_new": 4})
        FaultyCache.arm(rt.server._cache, FaultPlan(
            seed=0, kinds=("raise",), fire_window=(0, 1),
            seams=("wharvest", "windowp[4]", "windowp[2]", "step")))
        with pytest.raises((ServingFailure, GenerateUnavailable)):
            rt.serve_fn({"tokens": [[1, 2, 3]], "n_new": 8})
        deadline = time.monotonic() + 30
        while heartbeat.read_flight_bundle(cfg.state_dir) is None:
            assert time.monotonic() < deadline, "no flight bundle"
            time.sleep(0.02)
        bundle = heartbeat.read_flight_bundle(cfg.state_dir)
        record = heartbeat.read_failure_record(cfg.state_dir)
    finally:
        rt.close()
    assert os.path.exists(tmp_path / "flight-bundle.json")
    assert os.path.exists(tmp_path / "last-failure.json")
    assert bundle["bundle_version"] == 1 and bundle["degraded"] == 1
    assert bundle["ts"] > 0 and bundle["boot_count"] >= 0
    trace = record["trace"]
    assert trace and len(trace) <= POSTMORTEM_EVENTS
    assert "poison" in {ev["name"] for ev in trace}
