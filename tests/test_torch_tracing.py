"""Request ids, the flight recorder, the serving histograms and /metrics in
the port, against the JAX package, at small shapes (vocab 128, d_model
32, 4 heads, 2 kv heads, 2 layers, page 4, fp32) on the CPU.

* ``runtime/tracing.py``, ``slo.py``, ``autotune.py`` and
  ``debuglock.py`` are the JAX package's modules but for their
  docstrings.
* One seeded traffic through both servers with a tracer: for each
  request id the multiset of (span name, category) is the same; tracing
  on returns the tokens of tracing off, bit for bit; ``export_chrome``
  is valid Chrome trace-event JSON with one named track per category;
  an unsampled request keeps only the fabric spans; the tracer rides
  through a poison (``FaultyCache.arm``) and a revive.
* ``/metrics`` over the same traffic through both servers: the same
  ``kvedge_*`` families, types and HELP lines, equal deterministic
  counters (requests, tokens, prefix hits and tokens saved, sheds and
  preemptions in a fixed-order setup), and both pass a strict
  Prometheus text-format checker (a copy of the JAX package's test's).
* A burst with ``debug_locks`` raises no ``LockDisciplineError`` and
  returns the tokens of the plain locks; the JAX package's lock
  analyzer finds nothing unsuppressed in ``kvedge_torch/``.
"""

import collections
import inspect
import json
import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.runtime import autotune as jautotune
from kvedge_tpu.runtime import debuglock as jdebuglock
from kvedge_tpu.runtime import slo as jslo
from kvedge_tpu.runtime import status as jstatus
from kvedge_tpu.runtime import tracing as jtracing
from kvedge_torch.analysis import locklint
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import autotune as tautotune
from kvedge_torch.runtime import debuglock as tdebuglock
from kvedge_torch.runtime import slo as tslo
from kvedge_torch.runtime import status as tstatus
from kvedge_torch.runtime import tracing as ttracing
from kvedge_torch.runtime.failures import ServingFailure
from kvedge_torch.runtime.tracing import Tracer
from kvedge_torch.testing.servingfaults import FaultPlan, FaultyCache

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _sampling(k, jax_side):
    if k is None:
        return None
    key = jax.random.PRNGKey(k)
    if jax_side:
        return key, jnp.float32(0.8), jnp.float32(0.9)
    return np.asarray(key, np.uint32), 0.8, 0.9


def _server(models, jax_side, **kw):
    jcfg, tcfg, jparams, tparams = models
    kw.setdefault("slots", 2)
    kw.setdefault("pages", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("window", 4)
    if jax_side:
        return JaxServer(jparams, jcfg, **kw)
    return PagedGenerationServer(tparams, tcfg, device="cpu", **kw)


# Seeded traffic: (prompt, n_new, sampling seed or None, request id).
_rng = np.random.default_rng(5)
TRAFFIC = [([int(t) for t in _rng.integers(1, 128, size=n)], m, s,
            f"req-{i}")
           for i, (n, m, s) in enumerate([(5, 9, None), (3, 12, 3),
                                          (11, 6, None), (7, 8, 4),
                                          (2, 13, None)])]


def _drive(server, jax_side, traffic=TRAFFIC):
    return [server.submit(p, n, sampling=_sampling(s, jax_side),
                          request_id=rid) for p, n, s, rid in traffic]


def _spans_by_rid(tracer):
    out = collections.defaultdict(collections.Counter)
    for rec in tracer._snapshot():
        if rec[5]:
            out[rec[5]][(rec[3], rec[4])] += 1
    return dict(out)


# ---- the copies are the reference's ---------------------------------------


def _body(mod) -> str:
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]


@pytest.mark.parametrize("ours,theirs", [
    (ttracing, jtracing), (tslo, jslo), (tautotune, jautotune),
    (tdebuglock, jdebuglock)], ids=["tracing", "slo", "autotune",
                                    "debuglock"])
def test_the_copy_is_the_reference_but_for_its_docstring(ours, theirs):
    assert _body(ours) == _body(theirs)


def test_metric_tables_and_rendering_are_the_reference():
    for name in ("_METRIC_FIELDS", "_SERVE_METRIC_FIELDS",
                 "_SERVE_HISTOGRAM_FIELDS"):
        assert getattr(tstatus, name) == getattr(jstatus, name), name
    for fn in ("render_metrics", "_render_histogram"):
        assert (inspect.getsource(getattr(tstatus, fn))
                == inspect.getsource(getattr(jstatus, fn))), fn


# ---- spans: the port's against the reference's ---------------------------


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_span_multisets_per_request_equal_the_reference(models, overlap):
    got = {}
    for jax_side in (True, False):
        mod = jtracing if jax_side else ttracing
        tracer = mod.Tracer(sample=1.0)
        server = _server(models, jax_side, overlap=overlap, tracer=tracer)
        try:
            tokens = _drive(server, jax_side)
        finally:
            server.close()
        got[jax_side] = (tokens, _spans_by_rid(tracer))
    assert got[False][0] == got[True][0]
    assert got[False][1] == got[True][1]
    assert set(got[False][1]) == {rid for *_, rid in TRAFFIC}
    for spans in got[False][1].values():
        assert {("enqueue", "sched"), ("queue", "sched"),
                ("prefill", "serve"), ("decode", "serve")} <= set(spans)


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_tracing_on_equals_off_bit_for_bit(models, overlap):
    off = _server(models, False, overlap=overlap)
    try:
        want = _drive(off, False)
    finally:
        off.close()
    tracer = Tracer(sample=1.0)
    on = _server(models, False, overlap=overlap, tracer=tracer)
    try:
        assert _drive(on, False) == want
    finally:
        on.close()
    names = {rec[3] for rec in tracer._snapshot()}
    assert {"prefill", "decode", "queue", "enqueue"} <= names
    assert "window" in names or "step" in names


def _check_chrome(doc: dict) -> list:
    """Schema-check a Chrome trace-event document (the JAX package's
    test's checker); returns the non-metadata events."""
    json.dumps(doc)
    assert doc["displayTimeUnit"] in ("ms", "ns")
    named_tracks, payload, counters = {}, [], []
    for ev in doc["traceEvents"]:
        assert isinstance(ev["name"], str) and ev["name"]
        assert ev["ph"] in ("X", "i", "M", "C")
        assert ev["pid"] == 1 and isinstance(ev["tid"], int)
        if ev["ph"] == "M":
            assert ev["name"] == "thread_name"
            named_tracks[ev["tid"]] = ev["args"]["name"]
            continue
        assert isinstance(ev["cat"], str) and ev["cat"]
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "C":
            assert ev["args"] and all(isinstance(v, (int, float))
                                      for v in ev["args"].values())
            counters.append(ev)
            continue
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        else:
            assert ev["s"] == "t"
        payload.append(ev)
    for ev in payload:
        assert named_tracks[ev["tid"]] == ev["cat"]
    return payload + counters


def test_export_chrome_has_one_track_per_category(models):
    tracer = Tracer(sample=1.0)
    server = _server(models, False, overlap="on", tracer=tracer,
                     occupancy_ring=16)
    try:
        _drive(server, False)
    finally:
        server.close()
    doc = tracer.export_chrome()
    events = _check_chrome(doc)
    tracks = [ev for ev in doc["traceEvents"] if ev["ph"] == "M"]
    cats = {ev["cat"] for ev in events if ev["ph"] != "C"}
    assert sorted(ev["args"]["name"] for ev in tracks) == sorted(cats)
    assert {"serve", "sched"} <= cats
    assert any(ev["ph"] == "C" and ev["name"] == "occupancy"
               for ev in events)
    rids = {ev.get("args", {}).get("rid") for ev in events}
    assert {rid for *_, rid in TRAFFIC} <= rids


def test_unsampled_request_keeps_only_fabric_spans(models):
    tracer = Tracer(sample=0.0001)
    rid = next(f"req-{i}" for i in range(1000)
               if not tracer.sampled(f"req-{i}"))
    server = _server(models, False, tracer=tracer)
    try:
        got = server.submit([5, 9, 2], 4, request_id=rid)
    finally:
        server.close()
    plain = _server(models, False)
    try:
        assert got == plain.submit([5, 9, 2], 4)
    finally:
        plain.close()
    assert len(tracer) > 0
    assert not [rec for rec in tracer._snapshot() if rec[5] == rid]


def test_tracer_survives_a_poison_and_a_revive(models):
    tracer = Tracer(sample=1.0)
    server = _server(models, False, overlap="on", tracer=tracer,
                     pages=24)
    prompt = [3, 1, 4, 1, 5]
    try:
        baseline = server.submit(prompt, 4, request_id="req-a")
        FaultyCache.arm(server._cache, FaultPlan(
            seed=0, kinds=("raise",), fire_window=(1, 2),
            seams=("wharvest",)))
        with pytest.raises(ServingFailure):
            server.submit(prompt, 40, request_id="req-b")
        server._thread.join(timeout=60)
        FaultyCache.arm(server._cache, None)
        server.revive()
        assert server.tracer is tracer
        assert server.submit(prompt, 4, request_id="req-c") == baseline
    finally:
        server.close()
    names = {rec[3] for rec in tracer._snapshot()}
    assert {"poison", "revive"} <= names
    assert "req-c" in {rec[5] for rec in tracer._snapshot()}


def test_stage_histograms_fill_without_a_tracer(models):
    server = _server(models, False, overlap="on")
    try:
        _drive(server, False)
        stats = server.stats()
    finally:
        server.close()
    n = len(TRAFFIC)
    for key in ("ttft_ms", "queue_ms", "decode_ms", "itl_ms"):
        hist = stats[key]
        assert len(hist["counts"]) == len(hist["edges"]) + 1
        assert hist["count"] == sum(hist["counts"]) == n, key
    for key in ("window_device_ms", "window_dispatch_harvest_ms",
                "window_host_ms"):
        assert stats[key]["count"] >= 1, key
    assert "trace_events" not in stats


# ---- /metrics -------------------------------------------------------------

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
_LE_RE = re.compile(r'^\{le="([^"]+)"\}$')


def check_prometheus_text(text: str) -> dict:
    """Strict text-format conformance (a copy of the JAX package's
    ``tests/test_tracing.py`` checker): unique HELP/TYPE per family,
    every sample under a declared family, counters end in _total,
    histogram ``le`` buckets cumulative and +Inf-terminated with a
    matching _count. Returns {family: type}."""
    helps: dict = {}
    types: dict = {}
    samples: dict = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            assert name not in helps, f"duplicate HELP for {name}"
            assert help_text.strip(), f"empty HELP for {name}"
            helps[name] = help_text
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[len("# TYPE "):].partition(" ")
            assert name not in types, f"duplicate TYPE for {name}"
            assert name in helps, f"TYPE before HELP for {name}"
            assert mtype in ("gauge", "counter", "histogram"), line
            types[name] = mtype
            continue
        assert not line.startswith("#"), f"line {ln}: bad comment {line}"
        m = _SAMPLE_RE.match(line)
        assert m, f"line {ln}: unparseable sample {line!r}"
        name, labels, value = m.groups()
        float(value)
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else ""
            if base and types.get(base) == "histogram":
                family = base
        assert family in types, f"sample {name} has no TYPE declaration"
        samples.setdefault(family, []).append((name, labels, float(value)))
    for name, mtype in types.items():
        assert samples.get(name), f"declared family {name} has no samples"
        if mtype == "counter":
            assert name.endswith("_total"), (
                f"counter {name} must end in _total")
        if mtype != "histogram":
            continue
        rows = samples[name]
        buckets = [(lbl, v) for n, lbl, v in rows if n == name + "_bucket"]
        assert buckets, f"histogram {name} has no buckets"
        les, counts = [], []
        for lbl, v in buckets:
            m = _LE_RE.match(lbl or "")
            assert m, f"histogram {name} bucket without le label: {lbl}"
            les.append(float("inf") if m.group(1) == "+Inf"
                       else float(m.group(1)))
            counts.append(v)
        assert les[-1] == float("inf"), f"{name} missing +Inf bucket"
        assert les == sorted(les), f"{name} le edges not increasing"
        assert counts == sorted(counts), (
            f"{name} bucket counts not cumulative")
        count_samples = [v for n, _, v in rows if n == name + "_count"]
        assert count_samples == [counts[-1]], (
            f"{name}_count disagrees with the +Inf bucket")
        assert [n for n, _, _ in rows if n == name + "_sum"], (
            f"histogram {name} has no _sum")
    return types


def test_conformance_checker_catches_violations():
    good = ("# HELP kvedge_x_total things\n"
            "# TYPE kvedge_x_total counter\nkvedge_x_total 1\n")
    check_prometheus_text(good)
    for text in (
            good + good,
            "# HELP kvedge_y things\n# TYPE kvedge_y counter\nkvedge_y 1\n",
            "kvedge_orphan 1\n",
            ("# HELP kvedge_h ms\n# TYPE kvedge_h histogram\n"
             'kvedge_h_bucket{le="1"} 5\nkvedge_h_bucket{le="+Inf"} 3\n'
             "kvedge_h_sum 1\nkvedge_h_count 3\n"),
            ("# HELP kvedge_h ms\n# TYPE kvedge_h histogram\n"
             'kvedge_h_bucket{le="1"} 1\n'
             "kvedge_h_sum 1\nkvedge_h_count 1\n")):
        with pytest.raises(AssertionError):
            check_prometheus_text(text)


def _families(text: str) -> dict:
    """{family: (type, help)} of an exposition."""
    helps, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = h
        elif line.startswith("# TYPE "):
            name, _, t = line[len("# TYPE "):].partition(" ")
            types[name] = t
    return {name: (types[name], helps[name]) for name in types}


COUNTERS = ("requests_done_total", "tokens_done_total", "prefix_hits",
            "prefix_tokens_saved", "prefix_lookups", "sched_shed_total",
            "sched_preemptions_total", "sched_resumes_total",
            "stop_finishes_total", "spec_passes", "spec_windows_total")

METRIC_CASES = {
    "plain": dict(),
    "observability": dict(overlap="on", trace=True, slo=True,
                          occupancy_ring=16, window="auto"),
    "spec-windows": dict(speculative=2, spec_window=2, trace=True,
                         prefix_cache=True),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metrics_families_and_counters_equal_the_reference(models, case):
    kw = dict(METRIC_CASES[case])
    trace, slo = kw.pop("trace", False), kw.pop("slo", False)
    out = {}
    for jax_side in (True, False):
        mods = (jtracing, jslo, jstatus) if jax_side else \
            (ttracing, tslo, tstatus)
        server = _server(models, jax_side,
                         tracer=mods[0].Tracer(sample=1.0) if trace else None,
                         slo=mods[1].SloObjectives() if slo else None,
                         page_low_watermark=0.9, **kw)
        try:
            tokens = _drive(server, jax_side)
            # A second pass shares every prompt: prefix hits.
            tokens += _drive(server, jax_side)
            # A batch arrival under the page low watermark sheds at once.
            with pytest.raises(Exception, match="shed"):
                server.submit(list(range(1, 40)), 20, priority="batch")
            stats = server.stats()
        finally:
            server.close()
        text = mods[2].render_metrics({"serving": stats})
        out[jax_side] = (tokens, text,
                         {k: stats.get(k) for k in COUNTERS})
    assert out[False][0] == out[True][0]
    assert _families(out[False][1]) == _families(out[True][1])
    assert out[False][2] == out[True][2]
    assert out[False][2]["sched_shed_total"] == 1
    assert out[False][2]["requests_done_total"] == 2 * len(TRAFFIC)
    for jax_side in (True, False):
        families = check_prometheus_text(out[jax_side][1])
        for family in ("kvedge_serve_ttft_ms", "kvedge_serve_queue_ms",
                       "kvedge_serve_decode_ms", "kvedge_serve_itl_ms",
                       "kvedge_serve_device_ms_window"):
            assert families[family] == "histogram", family


def test_preemption_counters_equal_the_reference(models):
    """A fixed-order preemption: a batch stream admitted alone into one
    slot, then an interactive request that must take its slot."""
    got = {}
    for jax_side in (True, False):
        server = _server(models, jax_side, slots=1, pages=16,
                         sched_policy="strict", sched_swap_budget_mb=64,
                         prefix_cache=False)
        try:
            victim = server.submit_stream([9, 8, 7], 40, priority="batch")
            first = next(victim)
            inter = server.submit([40, 41, 42], 6)
            rest = [first] + list(victim)
            st = server.stats()
        finally:
            server.close()
        got[jax_side] = (inter, rest, st["sched_preemptions_total"],
                         st["sched_resumes_total"],
                         st["requests_done_total"])
    assert got[False] == got[True]
    assert got[False][2] == got[False][3] == 1


# ---- lock discipline -------------------------------------------------------


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_debug_locks_burst_equals_plain_locks(models, overlap):
    def burst(debug):
        server = _server(models, False, overlap=overlap, debug_locks=debug,
                         sched_swap_budget_mb=64, checkpoint_every=2,
                         tracer=Tracer(sample=1.0), slo=tslo.SloObjectives(),
                         occupancy_ring=8)
        results = [None] * len(TRAFFIC)
        errors = []

        def one(i):
            p, n, s, rid = TRAFFIC[i]
            try:
                results[i] = server.submit(p, n, sampling=_sampling(s, False),
                                           request_id=rid)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(TRAFFIC))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            server.stats()
            server.flight_bundle()
        finally:
            server.close()
        assert not errors, errors
        return results

    assert burst(True) == burst(False)


def test_lock_analyzer_finds_nothing_unsuppressed_in_the_port(capsys):
    assert locklint.main([str(REPO / "kvedge_torch")]) == 0
    out = capsys.readouterr().out
    assert re.search(r"locklint: 0 finding\(s\)", out), out
