"""The port's admission scheduler and preemption by KV swap.

* ``kvedge_torch/models/scheduler.py`` is a copy of the JAX package's:
  on the same operation sequences (strict, weighted and fifo heads;
  sheds by queue depth, by measured wait and by deadline; the
  prefix-affinity bypass and its cap) both make the same decisions.
* Preemption in the port's server, at the reference's small shapes
  (vocab 128, d_model 32, 4 heads, 2 kv heads, 2 layers, page 4, fp32):
  a batch stream swapped out for an interactive request and resumed
  returns the tokens of the same request run uncontended, bit for bit:
  greedy and sampled, on a shared prefix or not, int8, the overlap on
  and off, and with spec windows. Cancel while swapped out and close
  free the host snapshot; the books settle.
* A shed reaches an HTTP client as a 503 carrying the refusal's text;
  the new ``[payload]`` keys parse and fail as the reference's do, and
  ``serving_prefix_persist = true`` is refused.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.config.runtime_config import RuntimeConfigError as JaxError
from kvedge_tpu.models import scheduler as jsched
from kvedge_tpu.models import transformer as jtr
from kvedge_torch.models import scheduler as tsched
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.serving import (
    PagedGenerationServer,
    RequestCancelled,
    ServerBusy,
    ServerClosed,
    ServerOverloaded,
)
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig
from kvedge_torch.runtime.serve import boot_serve

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")


# ---- the copied scheduler makes the reference's decisions ---------------


def _decisions(mod, policy, **kw):
    """One scripted operation sequence; returns what the scheduler
    decided at each step."""
    sched = mod.AdmissionScheduler(threading.Lock(), policy=policy, **kw)
    trace = []
    with sched._lock:
        tickets = [sched.enqueue_locked(object(), c, pages_needed=1)
                   for c in ("batch", "interactive", "batch", "interactive",
                             "interactive", "batch")]
        trace.append(("depths", sched.depths_locked(),
                      sched.depth_text_locked()))
        for c in ("interactive", "batch"):
            trace.append(("shed_depth", c, sched.shed_depth_locked(c),
                          sched.shed_check_locked(c, None) is not None))
        order = []
        while sched.head_locked() is not None:
            head = sched.head_locked()
            order.append((head.pclass, tickets.index(head)))
            sched.admit_locked(head)
        trace.append(("order", order, sched.stats_locked()["sched_shed_total"]))
    return trace


@pytest.mark.parametrize("policy,kw", [
    ("strict", {}),
    ("fifo", {}),
    ("weighted", {"weights": {"interactive": 3.0, "batch": 1.0}}),
    ("strict", {"max_queue_depth": 2}),
    ("fifo", {"max_queue_depth": 3}),
], ids=["strict", "fifo", "weighted", "strict-depth", "fifo-depth"])
def test_scheduler_decides_as_the_reference(policy, kw):
    assert _decisions(tsched, policy, **kw) == _decisions(jsched, policy, **kw)


def _wait_sheds(mod):
    sched = mod.AdmissionScheduler(threading.Lock(), policy="strict",
                                   max_queue_wait_s=0.5)
    now = time.monotonic()
    out = []
    with sched._lock:
        sched._wait_ewma["interactive"] = 4.0
        sched._last_admit["interactive"] = now
        # An empty class queue never wait-sheds (the anti-livelock guard).
        out.append(sched.shed_check_locked("interactive", None))
        out.append(sched.shed_check_locked("interactive", 100))
        sched.enqueue_locked(object(), "interactive", pages_needed=1)
        wait = sched.shed_check_locked("interactive", None)
        out.append(wait["reason"] if wait else None)
        # Deadline shed: no wait watermark, a deadline the estimate misses.
        sched.max_queue_wait_s = 0.0
        dl = sched.shed_check_locked("interactive", 100)
        out.append(dl["reason"] if dl else None)
        out.append(sched.shed_check_locked("interactive", 10_000))
        # The estimate ages toward zero without admissions.
        sched._last_admit["interactive"] = now - 40.0
        out.append(sched.shed_check_locked("interactive", 100))
        out.append(sched.shed)
    return out


def test_wait_and_deadline_sheds_match_the_reference():
    got, want = _wait_sheds(tsched), _wait_sheds(jsched)
    assert got == want
    assert got[0] is None and got[2] and "queue wait" in got[2]
    assert "unmeetable" in got[3] and got[-1] == 2


def _bypass(mod):
    sched = mod.AdmissionScheduler(threading.Lock(), policy="strict")
    out = []
    with sched._lock:
        tickets = [sched.enqueue_locked(object(), "interactive",
                                        pages_needed=1) for _ in range(8)]
        tickets.append(sched.enqueue_locked(object(), "batch",
                                            pages_needed=1))
        for i in (1, 2, 4, 5, 6, 7, 8):
            tickets[i].hot = True
        while sched.head_locked() is not None:
            ok = [i for i, t in enumerate(tickets)
                  if t in sched._queues[t.pclass]
                  and sched.bypass_ok_locked(t)]
            out.append(ok)
            pick = tickets[ok[0]] if ok else sched.head_locked()
            sched.admit_locked(pick)
            out.append(tickets.index(pick))
        out.append(sched.stats_locked()["sched_hot_bypass_total"])
    return out


def test_prefix_bypass_and_its_cap_match_the_reference():
    got = _bypass(tsched)
    assert got == _bypass(jsched)
    assert got[-1] > 0


def test_the_copy_is_the_reference_but_for_its_docstring():
    import inspect
    ours, theirs = inspect.getsource(tsched), inspect.getsource(jsched)
    strip = (lambda src: src[src.index('"""', 3) + 3:])
    assert strip(ours) == strip(theirs)
    assert tsched.DEFAULT_CLASSES == ("interactive", "batch")


# ---- preemption by swap in the port's server -----------------------------


@pytest.fixture(scope="module")
def tmodel():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return tcfg, params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")


def _sampling(k, t=0.8, p=0.9):
    return np.asarray(jax.random.PRNGKey(k), np.uint32), t, p


def _sched_server(tmodel, **kw):
    tcfg, params = tmodel
    for k, v in dict(slots=1, pages=16, page_size=4, window=4,
                     sched_policy="strict", sched_swap_budget_mb=64).items():
        kw.setdefault(k, v)
    return PagedGenerationServer(params, tcfg, device="cpu", **kw)


def _uncontended(tmodel, reqs, **kw):
    server = _sched_server(tmodel, slots=2, pages=24, prefix_cache=False,
                           sched_swap_budget_mb=0, **kw)
    try:
        return [server.submit(p, n, sampling=s) for p, n, s in reqs]
    finally:
        server.close()


def _assert_idle(server, pages):
    st = server.stats()
    assert st["active"] == 0 and st["reserved_pages"] == 0
    assert st["sched_swapped_out"] == 0 and st["sched_swap_bytes_host"] == 0
    with server._lock:
        assert server._sched.depth_locked() == 0
        for node in list(server._prefix_entry_nodes):
            server._evict_prefix_node(node, "pressure")
        assert server._cache.free_pages() == pages


CASES = [
    dict(),
    dict(overlap="off"),
    dict(sampled=True),
    dict(sampled=True, overlap="off"),
    dict(shared_prefix=True),
    dict(shared_prefix=True, sampled=True, overlap="off"),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int8", overlap="off", sampled=True),
    dict(speculative=2, spec_window=2),
    dict(speculative=2, spec_window=2, sampled=True),
    dict(speculative=2, overlap="off"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()) or "greedy")
def test_preempt_resume_equals_uncontended(tmodel, case):
    case = dict(case)
    sampled = case.pop("sampled", False)
    shared_prefix = case.pop("shared_prefix", False)
    base = [1, 2, 3, 4, 5, 6, 7, 8]
    victim_prompt = (base + [2]) if shared_prefix else [9, 8, 7]
    v_s = _sampling(11) if sampled else None
    i_s = _sampling(23, 0.7, 0.95) if sampled else None
    server = _sched_server(tmodel, **case)
    try:
        if shared_prefix:
            server.submit(base + [1], n_new=2)
        victim = server.submit_stream(victim_prompt, n_new=40, sampling=v_s,
                                      priority="batch")
        first = next(victim)
        got_i = server.submit([40, 41, 42], n_new=6, sampling=i_s)
        got_v = victim_prompt + [first] + list(victim)
        st = server.stats()
        assert st["sched_preemptions_total"] >= 1
        assert st["sched_resumes_total"] == st["sched_preemptions_total"]
        if shared_prefix:
            assert st["prefix_hits"] >= 1
        _assert_idle(server, 16)
    finally:
        server.close()
    want_v, want_i = _uncontended(
        tmodel, [(victim_prompt, 40, v_s), ([40, 41, 42], 6, i_s)],
        **{k: v for k, v in case.items() if k != "overlap"})
    assert got_i == want_i
    assert got_v == want_v, "resumed stream diverged"
    if not sampled and "kv_dtype" not in case:
        tcfg, params = tmodel
        assert got_v == generate(params, [victim_prompt], tcfg, 40,
                                 device="cpu")[0].tolist()


def test_cancel_while_swapped_out_and_close_free_the_snapshot(tmodel):
    server = _sched_server(tmodel)
    result = {}
    try:
        victim = server.submit_stream([9, 8, 7], n_new=40, priority="batch")
        next(victim)
        t = threading.Thread(target=lambda: result.setdefault(
            "i", server.submit([1, 2], n_new=50)))
        t.start()
        deadline = time.monotonic() + 60
        while server.stats()["sched_swapped_out"] != 1:
            assert time.monotonic() < deadline, "victim never swapped out"
            time.sleep(0.002)
        assert server.stats()["sched_swap_bytes_host"] > 0
        victim.cancel()
        with pytest.raises(RequestCancelled, match="swapped out"):
            list(victim)
        st = server.stats()
        assert st["sched_swapped_out"] == 0
        assert st["sched_swap_bytes_host"] == 0
        assert st["sched_resumes_total"] == 0
        t.join(timeout=120)
        tcfg, params = tmodel
        assert result["i"] == generate(params, [[1, 2]], tcfg, 50,
                                       device="cpu")[0].tolist()
        _assert_idle(server, 16)
        # A hard close fails a swapped-out waiter too.
        victim = server.submit_stream([9, 8, 7], n_new=40, priority="batch")
        next(victim)
        def closed_out():
            try:
                server.submit([1, 2], n_new=50)
            except ServerClosed as e:
                result["j"] = e

        t = threading.Thread(target=closed_out)
        t.start()
        deadline = time.monotonic() + 60
        while server.stats()["sched_swapped_out"] != 1:
            assert time.monotonic() < deadline, "victim never swapped out"
            time.sleep(0.002)
    finally:
        server.close()
    t.join(timeout=60)
    assert isinstance(result["j"], ServerClosed)
    with pytest.raises(ServerClosed):
        list(victim)
    assert server.stats()["sched_swap_bytes_host"] == 0


def test_strict_priority_admits_interactive_first_and_sheds_by_depth(tmodel):
    server = _sched_server(tmodel, sched_swap_budget_mb=0,
                           sched_max_queue_depth=2)
    seqs = {}
    try:
        occ = server.submit_stream([7, 7, 7], n_new=40)
        next(occ)

        def worker(tag, prompt, priority):
            h = server.submit_stream(prompt, n_new=2, priority=priority)
            list(h)
            seqs[tag] = h._req.admit_seq

        def parked():
            with server._lock:
                return server._sched.depth_locked()

        threads = [threading.Thread(target=worker, args=a) for a in (
            ("batch", [1, 2], "batch"), ("interactive", [3, 4], "interactive"))]
        for n, t in enumerate(threads, 1):
            t.start()
            deadline = time.monotonic() + 60
            while parked() != n:
                assert time.monotonic() < deadline
                time.sleep(0.002)
        with pytest.raises(ServerOverloaded, match="queue depth") as info:
            server.submit([9], n_new=2, priority="batch")
        assert isinstance(info.value, ServerBusy)
        with pytest.raises(ValueError, match="unknown priority class"):
            server.submit([9], n_new=2, priority="bulk")
        occ.cancel()
        for t in threads:
            t.join(timeout=120)
        assert seqs["interactive"] < seqs["batch"]
        assert server.stats()["sched_shed_total"] == 1
    finally:
        server.close()


# ---- the serve payload ---------------------------------------------------


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_a_shed_is_a_503_with_the_refusal_text(tmp_path, capsys):
    cfg = ServeConfig(preset="probe", n_layers=1, max_seq=64,
                      payload_serving="paged", serving_slots=1,
                      serving_pages=4, serving_page_low_watermark=0.5,
                      state_dir=str(tmp_path))
    rt = boot_serve(cfg, device="cpu", dtype="float32", seed=3,
                    host="127.0.0.1", port=0)
    try:
        url = f"http://127.0.0.1:{rt.port}/generate"
        body = {"tokens": [[1, 2, 3]], "n_new": 40}
        code, doc = _post(url, dict(body, priority="batch"))
        assert code == 503
        assert "request shed" in doc["error"]
        assert "low watermark" in doc["error"]
        assert "queue depth [interactive=0, batch=0]" in doc["error"]
        # The top class never page-sheds; deadline_ms rides along.
        code, doc = _post(url, dict(body, deadline_ms=60000))
        assert code == 200 and len(doc["tokens"][0]) == 43
        code, doc = _post(url, dict(body, priority="bulk"))
        assert code == 400 and "unknown priority class" in doc["error"]
        st = rt.server.stats()
        assert st["sched_shed_total"] == 1 and st["page_low_watermark"] == 0.5
    finally:
        rt.close()


# ---- the [payload] knobs -------------------------------------------------


GOOD = [
    "",
    "serving_prefix_cache = false\nserving_prefix_host_mb = 256\n",
    "serving_prefix_persist = false\n",
    "serving_sched_policy = 'weighted'\n"
    "serving_sched_weights = 'interactive=2, batch=0.5'\n",
    "serving_sched_policy = 'fifo'\nserving_sched_max_queue_depth = 8\n"
    "serving_sched_max_queue_wait_s = 2\nserving_sched_swap_budget_mb = 64\n",
    "serving_page_low_watermark = 0.1\nserving_page_high_watermark = 0.3\n",
]
BAD = [
    ("serving_prefix_cache = 1\n", "serving_prefix_cache"),
    ("serving_prefix_host_mb = -1\n", "serving_prefix_host_mb"),
    ("serving_sched_policy = 'lifo'\n", "serving_sched_policy"),
    ("serving_sched_weights = 'interactive'\n", "serving_sched_weights"),
    ("serving_sched_weights = 'batch=0'\n", "serving_sched_weights"),
    ("serving_sched_max_queue_depth = -1\n", "serving_sched_max_queue_depth"),
    ("serving_sched_max_queue_wait_s = -0.5\n",
     "serving_sched_max_queue_wait_s"),
    ("serving_sched_swap_budget_mb = -3\n", "serving_sched_swap_budget_mb"),
    ("serving_page_low_watermark = 1.0\n", "serving_page_low_watermark"),
    ("serving_page_low_watermark = 0.5\nserving_page_high_watermark = 0.2\n",
     "serving_page_low_watermark"),
]
FIELDS = ("serving_prefix_cache", "serving_prefix_host_mb",
          "serving_sched_policy", "serving_sched_weights",
          "serving_sched_max_queue_depth", "serving_sched_max_queue_wait_s",
          "serving_sched_swap_budget_mb", "serving_page_low_watermark",
          "serving_page_high_watermark")


@pytest.mark.parametrize("text", GOOD)
def test_new_keys_parse_as_the_reference(text):
    doc = "[payload]\nserving = 'paged'\n" + text
    ours, theirs = ServeConfig.parse(doc), JaxConfig.parse(doc)
    for name in FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
        assert type(getattr(ours, name)) is type(getattr(theirs, name)), name
    assert ours.sched_weights_dict() == theirs.sched_weights_dict()


@pytest.mark.parametrize("text,match", BAD)
def test_new_keys_fail_as_the_reference(text, match):
    doc = "[payload]\n" + text
    with pytest.raises(JaxError, match=match):
        JaxConfig.parse(doc)
    with pytest.raises(RuntimeConfigError, match=match):
        ServeConfig.parse(doc)


def test_prefix_persistence_and_other_left_out_knobs_are_refused():
    assert JaxConfig.parse("").serving_prefix_persist is True
    assert ServeConfig.parse("").serving_prefix_persist is True
    # The observability knobs are read now, with the reference's values;
    # what is still unported is refused by name.
    text = ("[payload]\nserving_occupancy_ring = 64\nserving_slo = true\n"
            "serving_debug_locks = true\nserving_trace = 'on'\n")
    ours, theirs = ServeConfig.parse(text), JaxConfig.parse(text)
    for name in ("serving_occupancy_ring", "serving_slo",
                 "serving_debug_locks", "serving_trace"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for text, match in (("[payload]\nserving_hbm_budget_mb = 64\n"
                         "serving_pages = 32\n", "mutually exclusive"),
                        ("[model]\nn_experts = 4\n", "n_experts"),
                        ("[payload]\nattention = 'ring'\n", "ring"),
                        ("[payload]\nattention = 'ulysses'\n", "ulysses")):
        with pytest.raises(RuntimeConfigError, match=match):
            ServeConfig.parse(text).model_config()
    # remat_policy "dots", MoE and pipelining are ported: accepted, with
    # the reference's refusals of invalid values.
    dataclasses.replace(TransformerConfig(**KW), remat_policy="dots",
                        n_experts=4, expert_top_k=2).validate()
    for change, match in ((dict(pipeline_stages=-1), "pipeline_stages"),
                          (dict(n_experts=-1), "n_experts"),
                          (dict(n_experts=4, expert_capacity_factor=0.0),
                           "capacity"),
                          (dict(n_experts=4, expert_top_k=3), "top_k"),
                          (dict(n_experts=1, expert_top_k=2), "top_k")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(TransformerConfig(**KW), **change).validate()
