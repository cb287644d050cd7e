"""Degraded mode, checkpoints, revive and the recovery supervisor in the
port's server, at the reference's small shapes (vocab 128, d_model 32, 4
heads, 2 kv heads, 2 layers, page 4, fp32) on the CPU.

* A fault at every seam label poisons the pool with the typed
  ``PoolPoisoned`` (a prefill seam fails its own submit, as the
  reference's); ``revive`` returns the pool to its idle fixpoint.
* The seeded ``ServingFaultSchedule`` keeps its invariants on the port's
  server (every request ends, typed; no over-emission; a free lock; a
  bounded close).
* The same seeded ``FaultPlan`` and the same traffic through the port's
  server and the JAX package's, plain, with the prefix cache, with spec
  windows and with int8 pages: the seam traces agree label by label,
  and so do the outcomes (who failed with which type, how many were
  restored, the tokens) and the journal's books at the poison.
* A 1 MiB ``journal_budget_mb`` on wider pages: the refused checkpoints,
  a shadow unwound for a refused entry and the outcomes are the JAX
  server's; a request resumes from its last entry that fit; a swapped
  victim whose snapshot does not fit fails typed.
* With ``checkpoint_every`` > 0, requests in flight at the fault resume
  after ``revive`` with the tokens of their runs alone, bit for bit, and
  each stream's tokens arrive exactly once: greedy and sampled, the
  overlap on and off, spec windows, a shared prefix with its journal
  shadow, and a swapped-out victim journaled at the poison.
* ``revive`` restores the pre-poison bucket, refuses a pool that is not
  poisoned, and copies new weights in place; the supervisor heals, and
  escalates to terminal when every revive fails at its first device
  call (what a sticky CUDA error does on the card).
* The emergency prefix dump is intact and loads into a fresh server;
  ``/healthz`` reports healthy, recovering and terminal, and a poisoned
  pool's 503 carries ``retry_after_s``.

Every wait on another thread has its own bound.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.testing import servingfaults as jfaults
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.failures import PoolPoisoned
from kvedge_torch.runtime.recovery import (
    HEALTHY,
    TERMINAL,
    RecoveryPolicy,
    RecoverySupervisor,
)
from kvedge_torch.runtime.serve import boot_serve
from kvedge_torch.testing.servingfaults import (
    FaultPlan,
    FaultyCache,
    InjectedFault,
    ServingFaultSchedule,
    prefix_file_intact,
)

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")
FAST = dict(backoff_base_s=0.01, backoff_cap_s=0.02, jitter=0.0)
BOUND_S = 60.0


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _key(k: int) -> np.ndarray:
    return np.asarray(jax.random.PRNGKey(k), np.uint32)


def _server(models, plan=None, **kw):
    """The port's server on the CPU, its cache armed with ``plan``."""
    _, _, tcfg, params = models
    kw.setdefault("slots", 2)
    kw.setdefault("pages", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("window", 4)
    kw.setdefault("prefix_cache", False)
    server = PagedGenerationServer(params, tcfg, device="cpu", **kw)
    FaultyCache.arm(server._cache, plan)
    return server


def _alone(models, prompt, n_new, sampling=None, **kw):
    """The request run alone on a fresh server with no fault."""
    server = _server(models, **kw)
    try:
        return server.submit(prompt, n_new, sampling=sampling)
    finally:
        server.close()


def _wait(cond, what: str, bound: float = BOUND_S) -> None:
    deadline = time.monotonic() + bound
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _wait_degraded(server) -> None:
    _wait(lambda: server.degraded is not None, "pool never poisoned")
    server._thread.join(timeout=BOUND_S)
    assert not server._thread.is_alive()


class _FireWhen(FaultPlan):
    """A raise at the first crossing of ``seams`` at which ``ready(server)``
    holds. Every decode-loop seam runs under the server lock, so the
    predicate reads a consistent server; no test thread's timing
    decides where the fault lands.

    On the CPU a tiny model decodes a whole request in a few ms, and a
    second submitter may not get the server lock before the first request
    ends. While ``let_in(server)`` holds, a checkpoint's swap-out (at a
    boundary, before the batch of the next window is read) therefore
    waits on the server's condition, which releases the lock to the
    admission, in 10 ms waits, 200 at most; only the plan's first
    swap-out waits."""

    def __init__(self, seams, ready, let_in=None):
        super().__init__(0, kinds=("raise",),
                         fire_window=(10**6, 10**6 + 1), seams=seams)
        self.ready = ready
        self.let_in = let_in
        self.waits = 0
        self.server = None

    def at_seam(self, label: str) -> None:
        server = self.server
        if server is not None and self.fired_on is None:
            while (label == "swapout" and self.let_in is not None
                   and self.let_in(server) and self.waits < 200):
                self.waits += 1
                server._work.wait(timeout=0.01)
            if label == "swapout":
                self.let_in = None   # once: the admission is in
            if label.startswith(self.seams) and self.ready(server):
                with self._lock:
                    self.fire_at = self.count
        super().at_seam(label)


def _rows_below(n):
    return lambda server: len(server._active) < n


def _journaled(n):
    return lambda server: len(server._journal) >= n


class _Stream:
    """A streamed request consumed on a daemon thread; ``first`` is set
    once its first token arrived."""

    def __init__(self, server, prompt, n_new, **kw):
        self.prompt, self.got, self.error = prompt, [], None
        self.first = threading.Event()
        self.done = threading.Event()

        def consume():
            try:
                for tok in server.submit_stream(prompt, n_new,
                                                timeout=BOUND_S, **kw):
                    self.got.append(tok)
                    self.first.set()
            except Exception as e:  # judged by the test
                self.error = e
            finally:
                self.first.set()
                self.done.set()

        threading.Thread(target=consume, daemon=True).start()

    def result(self):
        assert self.done.wait(BOUND_S), "stream never ended"
        if self.error is not None:
            raise self.error
        return self.prompt + self.got


def _assert_idle(server) -> None:
    """The idle fixpoint: nothing reserved, leased, queued or journaled,
    and every page free but those the prefix registry pins."""
    st = server.stats()
    assert st["active"] == 0 and st["reserved_pages"] == 0
    assert st["journal_entries"] == 0 and st["journal_bytes"] == 0
    assert st["sched_swapped_out"] == 0
    acct = server._cache.page_accounting()
    with server._lock:
        pinned = {p for e in server._prefix_entry_nodes.values()
                  for p in e["pages"]}
        assert not server._lease
    assert acct["live"] == len(pinned)
    assert acct["free"] + acct["live"] == acct["pages_total"]
    assert not (acct["free_dup"] or acct["neg_refs"] or acct["free_live"])


# ---- typed poison at every seam ------------------------------------------


SEAMS = {
    "prefill": dict(),
    "step": dict(overlap="off", window=1),
    "windowp": dict(overlap="on"),
    "wsamplep": dict(overlap="on"),
    "wharvest": dict(overlap="on"),
    "spec": dict(overlap="off", speculative=2),
    "specw": dict(speculative=2, spec_window=2),
    "specwharvest": dict(speculative=2, spec_window=2),
    "swapout": dict(checkpoint_every=1),
    "swapin": dict(slots=1, sched_swap_budget_mb=64),
}


@pytest.mark.parametrize("label", sorted(SEAMS))
def test_a_fault_at_every_seam_poisons_typed(models, label):
    kw = dict(SEAMS[label])
    plan = FaultPlan(0, kinds=("raise",), fire_window=(0, 1),
                     seams=(label,) if label != "swapin" else ("swapin",))
    server = _server(models, plan=plan, **kw)
    prompt = [3, 1, 4, 1, 5]
    sampling = (_key(3), 0.8, 0.9) if label == "wsamplep" else None
    try:
        if label == "prefill":
            # The submit path: the raw fault reaches its own submitter
            # (the reference's contract) and the pool stays healthy.
            with pytest.raises(InjectedFault, match="prefill"):
                server.submit(prompt, 8)
            assert server.degraded is None
        elif label == "swapin":
            # A preempted victim's resume faults in the decode loop.
            victim = _Stream(server, [9, 8, 7], 30, priority="batch")
            assert victim.first.wait(BOUND_S)
            assert server.submit([40, 41, 42], 6) == _alone(
                models, [40, 41, 42], 6)
            with pytest.raises(PoolPoisoned) as err:
                victim.result()
            assert isinstance(err.value.__cause__, InjectedFault)
            assert server.stats()["sched_preemptions_total"] == 1
        else:
            with pytest.raises(PoolPoisoned) as err:
                server.submit(prompt, 8, sampling=sampling)
            assert isinstance(err.value.__cause__, InjectedFault)
            assert err.value.retryable
        assert plan.fired_on is not None
        assert plan.fired_on.startswith(label)
        if label != "prefill":
            _wait_degraded(server)
            assert server.stats()["degraded"] == 1
            with pytest.raises(PoolPoisoned, match="poisoned"):
                server.submit(prompt, 8)
            assert server.revive() == 0
        assert server.degraded is None
        _assert_idle(server)
        want = _alone(models, prompt, 8, sampling=sampling,
                      **{k: v for k, v in kw.items() if k != "checkpoint_every"})
        assert server.submit(prompt, 8, sampling=sampling) == want
        _assert_idle(server)
    finally:
        server.close()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_schedule_invariants_hold(models, seed):
    """The seeded schedule (concurrent blocking and streamed requests, a
    raise at a drawn seam) on the port's server, checkpoints off: every
    request ends with its tokens or typed, none over-emits, the lock is
    free, close is bounded and the decode loop gone (the schedule raises
    otherwise); a decode-loop fault degrades the pool."""
    plan = FaultPlan(seed, fire_window=(1, 12))
    server = _server(models, plan=plan)
    result = ServingFaultSchedule(server, plan, seed=seed,
                                  join_timeout_s=BOUND_S).run(
        n_requests=4, n_new=8, vocab=128)
    assert result.completed + result.failed == 4
    if result.fired_on is not None:
        assert result.failed >= 1
        assert (result.degraded is None) == result.fired_on.startswith(
            "prefill")


# ---- the port against the JAX server ------------------------------------


TRAFFIC = [([3, 1, 4, 1, 5], 12, None), ([7, 7, 2], 10, 5),
           ([9, 2, 6, 5, 3, 5], 9, None)]
# Three requests on one 8-token (2-page) prefix: the first registers it,
# the next two hit it and journal a reference to its shadow.
SHARED = [([1, 2, 3, 4, 5, 6, 7, 8, 2, 9], 12, None),
          ([1, 2, 3, 4, 5, 6, 7, 8, 3], 10, 5),
          ([1, 2, 3, 4, 5, 6, 7, 8, 4, 4, 1], 9, None)]
# The journal's and the restore's books, read at the poison and after the
# revive.
JOURNAL_STATS = ("journal_entries", "journal_bytes", "journal_shadow_nodes",
                 "journal_shadow_bytes", "checkpoints_total",
                 "checkpoint_skipped_total", "checkpoint_unchanged_total")


def _jserver(models, plan, *, slots=2, pages=32, page_size=4,
             kv_dtype="", **kw):
    """The JAX package's server over its own FaultyCache, sized as
    :func:`_server` sizes the port's."""
    jcfg, jparams, _, _ = models
    cache = jfaults.FaultyCache(
        jcfg, slots=slots, pages=pages, page_size=page_size,
        max_pages_per_seq=-(-(jcfg.max_seq + kw.get("speculative", 0))
                            // page_size),
        kv_dtype=kv_dtype, plan=plan)
    return JaxServer(jparams, jcfg, cache=cache, **kw)


def _drive(server, traffic, sampling_key):
    """``traffic`` one request at a time (so the seam order is fixed),
    reviving once when the fault poisons the pool. Returns each
    request's tokens or error type, the revive's count, the journal's
    books at the poison and the restore's after the traffic."""
    outcomes: list = []
    finished = threading.Event()

    def run():
        for prompt, n_new, k in traffic:
            sampling = None if k is None else sampling_key(k)
            try:
                outcomes.append(server.submit(prompt, n_new,
                                              sampling=sampling,
                                              timeout=BOUND_S))
            except Exception as e:
                outcomes.append(type(e).__name__)
        finished.set()

    threading.Thread(target=run, daemon=True).start()
    restored = at_poison = None
    _wait(lambda: finished.is_set() or server.degraded is not None,
          "traffic never ended")
    if server.degraded is not None:
        _wait_degraded(server)
        st = server.stats()
        at_poison = {k: st[k] for k in JOURNAL_STATS}
        restored = server.revive()
    assert finished.wait(BOUND_S), "traffic never ended after revive"
    st = server.stats()
    after = {"journal_restores_total": st["journal_restores_total"],
             "revive_evictions": st["prefix_evictions"]["revive"],
             "journal_entries": st["journal_entries"],
             "journal_shadow_nodes": st["journal_shadow_nodes"]}
    return outcomes, restored, at_poison, after


BASE = dict(window=4, checkpoint_every=1, prefix_cache=False, overlap="on")
FIRE_POINTS = [
    # (name, seam, its index, the requests restored, the server's knobs
    # over BASE, the traffic). The 4th swap-out is the third request's
    # first checkpoint, so it had no entry to resume.
    ("wharvest2", "wharvest", 2, 1, {}, TRAFFIC),
    ("windowp3", "windowp", 3, 1, {}, TRAFFIC),
    ("swapout4", "swapout", 4, 0, {}, TRAFFIC),
    ("wsamplep1", "wsamplep", 1, 1, {}, TRAFFIC),
    ("prefill1", "prefill", 1, None, {}, TRAFFIC),
    # The second request hits the registered prefix: its entry cites the
    # node's shadow, which the revive re-materialises.
    ("prefix-wharvest4", "wharvest", 4, 1, dict(prefix_cache=True),
     SHARED),
    ("prefix-wsamplep1", "wsamplep", 1, 1, dict(prefix_cache=True),
     SHARED),
    ("specw-harvest2", "specwharvest", 2, 1,
     dict(speculative=2, spec_window=2), TRAFFIC),
    ("int8-windowp3", "windowp", 3, 1, dict(kv_dtype="int8"), TRAFFIC),
]


@pytest.mark.parametrize("fire", FIRE_POINTS, ids=lambda f: f[0])
def test_port_and_jax_servers_agree_under_one_fault(models, fire):
    """The same plan on the same traffic (overlap on, window 4, a
    checkpoint every boundary) through both servers: the seam traces
    agree label by label, and so do the outcomes (which requests failed
    with which type, how many were restored, every token), the
    journal's books at the poison (entries, bytes, shadow nodes and
    bytes, checkpoints taken, skipped and unchanged) and the restore's
    (restores, the registry's revive evictions)."""
    _, label, at, restored, knobs, traffic = fire
    kw = {**BASE, **knobs}
    jplan = jfaults.FaultPlan(5, kinds=("raise",), fire_window=(0, 1))
    tplan = FaultPlan(5, kinds=("raise",), fire_window=(at, at + 1),
                      seams=(label,))
    jserver = _jserver(models, jplan, **kw)
    tserver = _server(models, plan=tplan, **kw)
    try:
        got = _drive(tserver, traffic, lambda k: (_key(k), 0.8, 0.9))
        # The JAX plan fires at the crossing the port's plan fired at.
        fired = next(i for i, ln in enumerate(tplan.trace[1:])
                     if ln.endswith("<- raise"))
        jplan.fire_at = fired
        want = _drive(jserver, traffic,
                      lambda k: (jax.random.PRNGKey(k), 0.8, 0.9))
    finally:
        tserver.close()
        jserver.close()

    def labels(trace):
        return [ln.split("] ", 1)[1] for ln in trace[1:]]

    assert tplan.fired_on is not None and tplan.fired_on.startswith(label)
    assert labels(tplan.trace) == labels(jplan.trace)
    assert jplan.fired_on == tplan.fired_on
    assert got == want
    outcomes, got_restored, at_poison, _ = got
    assert got_restored == restored
    assert sum(isinstance(o, str) for o in outcomes) == (
        restored is not None and restored == 0 or label == "prefill")
    if kw["prefix_cache"]:
        assert at_poison["journal_shadow_nodes"] == 1


# ---- the journal's byte budget ------------------------------------------


# Wider pages, so that a few of them outgrow a 1 MiB journal budget: 16
# tokens x 4 layers x 2 kv heads x 128 dims x K and V x 4 bytes = 128
# KiB a page, 8 pages a MiB.
WIDE = dict(vocab=128, d_model=256, n_heads=2, n_kv_heads=2, n_layers=4,
            d_ff=64, max_seq=192, dtype="float32")
WIDE_KW = dict(window=8, checkpoint_every=1, overlap="on", page_size=16,
               pages=32, journal_budget_mb=1)
PREFIX = list(range(1, 113))    # 7 pages


@pytest.fixture(scope="module")
def wide():
    jcfg = jtr.TransformerConfig(**WIDE, remat=False,
                                 paged_attention="gather")
    tcfg = TransformerConfig(**WIDE)
    jparams = jtr.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


BUDGET_POINTS = [
    # (name, window dispatch to fail, the requests restored, the
    # server's knobs over WIDE_KW, the traffic).
    # One request outgrows the budget at 8 pages (128 tokens): its later
    # checkpoints are refused and it resumes from its last one that fit.
    ("older-entry", 18, 1, {}, [([3, 1, 4, 1, 5, 9, 2, 6], 150, None)]),
    # A request on a registered 7-page prefix: its shadow and its own 2
    # pages never fit, so each checkpoint builds the shadow and unwinds
    # it, and the fault fails the request typed.
    ("shadow-unwound", 3, 0, dict(prefix_cache=True),
     [(PREFIX + [7], 4, None), (PREFIX + [9] * 20, 16, None)]),
]


@pytest.mark.parametrize("point", BUDGET_POINTS, ids=lambda p: p[0])
def test_journal_budget_refusals_agree_with_jax(wide, point):
    """``journal_budget_mb`` = 1 through both servers under one plan: the
    refused checkpoints (``checkpoint_skipped_total``), the shadow that
    a refused entry unwinds, the journal's bytes at the poison, the seam
    traces and the outcomes are the JAX server's; a request resumed from
    an older entry has the tokens of its run alone."""
    _, at, restored, knobs, traffic = point
    kw = {**WIDE_KW, "prefix_cache": False, **knobs}
    jplan = jfaults.FaultPlan(5, kinds=("raise",), fire_window=(0, 1))
    tplan = FaultPlan(5, kinds=("raise",), fire_window=(at, at + 1),
                      seams=("windowp",))
    jserver = _jserver(wide, jplan, **kw)
    tserver = _server(wide, plan=tplan, **kw)
    try:
        got = _drive(tserver, traffic, None)
        jplan.fire_at = next(i for i, ln in enumerate(tplan.trace[1:])
                             if ln.endswith("<- raise"))
        want = _drive(jserver, traffic, None)
    finally:
        tserver.close()
        jserver.close()
    assert [ln.split("] ", 1)[1] for ln in tplan.trace[1:]] == \
        [ln.split("] ", 1)[1] for ln in jplan.trace[1:]]
    assert got == want
    outcomes, got_restored, at_poison, _ = got
    assert got_restored == restored
    assert at_poison["checkpoint_skipped_total"] >= 1
    assert at_poison["journal_shadow_nodes"] == 0
    assert at_poison["journal_bytes"] <= 1 << 20
    if restored:
        prompt, n_new, _ = traffic[-1]
        assert outcomes[-1] == _alone(wide, prompt, n_new,
                                      **{**kw, "journal_budget_mb": 0})
    else:
        assert outcomes[-1] == "PoolPoisoned"


def test_swapped_victim_over_the_budget_fails_typed(wide):
    """A preempted victim whose pages never fit the journal budget (a
    140-token prompt, 9 pages) has no checkpoint, and its swap snapshot
    is refused at the poison: it fails with the poison. The interactive
    request, whose entries fit, is restored with the tokens of its run
    alone."""
    victim_prompt, inter_prompt = [5 + i % 100 for i in range(140)], [40,
                                                                     41, 42]
    plan = _FireWhen(("wharvest",), lambda server: (
        server._sched.swapped_locked() and any(
            e.req.prompt == inter_prompt
            for e in server._journal._entries.values())),
        let_in=lambda server: server.requests_queued < 2)
    kw = {**WIDE_KW, "prefix_cache": False}
    server = plan.server = _server(wide, plan=plan, slots=1,
                                   sched_swap_budget_mb=64, **kw)
    try:
        victim = _Stream(server, victim_prompt, 40, priority="batch")
        _wait(lambda: server.stats()["active"] == 1, "victim never active")
        inter = _Stream(server, inter_prompt, 40)
        _wait_degraded(server)
        st = server.stats()
        assert st["journal_entries"] == 1 and st["sched_swapped_out"] == 0
        # The victim may be preempted before its first checkpoint; its
        # snapshot's refusal at the poison is skipped at least once.
        assert st["checkpoint_skipped_total"] >= 1
        with pytest.raises(PoolPoisoned):
            victim.result()
        assert server.revive() == 1
        got = inter.result()
        _assert_idle(server)
    finally:
        server.close()
    assert got == _alone(wide, inter_prompt, 40, **kw)


# ---- revive restores the requests in flight -----------------------------


RESTORE_CASES = [
    dict(overlap="on"),
    dict(overlap="off"),
    dict(overlap="on", sampled=True),
    dict(overlap="off", sampled=True),
    dict(speculative=2, spec_window=2, seam="specwharvest"),
    dict(speculative=2, spec_window=2, sampled=True, seam="specw"),
    dict(speculative=2, overlap="off", seam="spec"),
    dict(overlap="on", shared_prefix=True),
    dict(overlap="off", shared_prefix=True, sampled=True),
    dict(overlap="on", kv_dtype="int8"),
]


@pytest.mark.parametrize("case", RESTORE_CASES, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()))
def test_revive_restores_in_flight_bit_for_bit(models, case):
    case = dict(case)
    sampled = case.pop("sampled", False)
    shared = case.pop("shared_prefix", False)
    seam = case.pop("seam", "wharvest" if case.get("overlap") == "on"
                    else "w")   # windowp or wsamplep
    plan = _FireWhen((seam,), _journaled(2), let_in=_rows_below(2))
    server = plan.server = _server(models, plan=plan, checkpoint_every=1,
                                   prefix_cache=shared, **case)
    base = [1, 2, 3, 4, 5, 6, 7, 8]
    prompts = ([base + [2, 9], base + [3]] if shared
               else [[3, 1, 4, 1, 5], [7, 7, 2]])
    samplings = ([(_key(11), 0.8, 0.9), None] if sampled
                 else [None, None])
    try:
        if shared:
            server.submit(base + [1], 2)   # registers 2 full pages
        # Both submitted at once: the first boundary holds its window
        # until the second is active.
        a = _Stream(server, prompts[0], 44, sampling=samplings[0])
        b = _Stream(server, prompts[1], 24, sampling=samplings[1])
        _wait_degraded(server)
        st = server.stats()
        assert st["journal_entries"] == 2 and st["checkpoints_total"] >= 2
        if shared:
            assert st["journal_shadow_nodes"] == 1
            assert st["journal_shadow_bytes"] > 0
        assert server.revive() == 2
        got = [a.result(), b.result()]
        _assert_idle(server)
        st = server.stats()
        assert st["journal_restores_total"] == 2
        assert st["journal_shadow_nodes"] == 0
        if shared:
            assert st["prefix_evictions"]["revive"] >= 1
    finally:
        server.close()
    want = [_alone(models, p, n, sampling=s, **case)
            for p, n, s in zip(prompts, (44, 24), samplings)]
    assert got == want


def test_swapped_out_victim_is_journaled_at_poison(models):
    """A preempted victim's host snapshot joins the journal at the
    poison; with one slot the revive restores one request and requeues
    the other into the swap set, and both finish as alone."""
    # The victim may be preempted before its first checkpoint: its swap
    # snapshot is its checkpoint then. Fire once the interactive request
    # is journaled while the victim is swapped out.
    plan = _FireWhen(("wharvest",), lambda server: (
        server._sched.swapped_locked() and any(
            e.req.prompt == [40, 41, 42]
            for e in server._journal._entries.values())),
        let_in=lambda server: server.requests_queued < 2)
    server = plan.server = _server(models, plan=plan, slots=1,
                                   checkpoint_every=1,
                                   sched_swap_budget_mb=64)
    try:
        victim = _Stream(server, [9, 8, 7], 30, priority="batch")
        # Active: its first boundary holds the lock open for the next.
        _wait(lambda: server.stats()["active"] == 1, "victim never active")
        inter = _Stream(server, [40, 41, 42], 20)
        _wait_degraded(server)
        st = server.stats()
        assert st["journal_entries"] == 2 and st["sched_swapped_out"] == 0
        assert server.revive() == 2
        got = [victim.result(), inter.result()]
        _assert_idle(server)
        # The restore takes the earliest admission (the victim) into the
        # slot and requeues the interactive one, which preempts it again.
        assert server.stats()["sched_preemptions_total"] == 2
    finally:
        server.close()
    assert got == [_alone(models, [9, 8, 7], 30),
                   _alone(models, [40, 41, 42], 20)]


def test_unjournaled_requests_fail_typed_and_close_fails_the_journal(models):
    """Checkpoints off: the request in flight fails with the poison. A
    journaled request of a pool that is closed instead of revived fails
    with the poison too, never parks for good."""
    plan = FaultPlan(0, kinds=("raise",), fire_window=(1, 2),
                     seams=("wharvest",))
    server = _server(models, plan=plan)
    try:
        with pytest.raises(PoolPoisoned):
            server.submit([3, 1, 4], 20)
    finally:
        server.close()
    plan = _FireWhen(("wharvest",), _journaled(1))
    server = plan.server = _server(models, plan=plan, checkpoint_every=1)
    s = _Stream(server, [3, 1, 4], 30)
    try:
        _wait_degraded(server)
        assert server.stats()["journal_entries"] == 1
        assert not s.done.is_set()   # parked, not failed
    finally:
        server.close()
    with pytest.raises(PoolPoisoned):
        s.result()


def test_revive_restores_the_prepoison_bucket(models):
    """Two rows run at bucket 2; the fault lands on the first checkpoint,
    so nothing is journaled (bucket 1 would do for the revive): revive
    sets the pre-poison bucket 2, whose programs exist."""
    plan = _FireWhen(("swapout",), lambda server: len(server._active) == 2,
                     let_in=_rows_below(2))
    server = plan.server = _server(models, plan=plan, slots=4,
                                   min_bucket=1, checkpoint_every=1)
    try:
        a = _Stream(server, [3, 1, 4, 1, 5], 50)
        b = _Stream(server, [7, 7, 2], 30)
        _wait_degraded(server)
        assert server._prebucket == 2
        assert server.stats()["journal_entries"] == 0
        for s in (a, b):
            with pytest.raises(PoolPoisoned):
                s.result()
        assert server.revive() == 0
        assert server._cache.bucket == 2
        assert server.stats()["bucket"] == 2
        assert server.submit([3, 1, 4, 1, 5], 6) == _alone(
            models, [3, 1, 4, 1, 5], 6)
        _assert_idle(server)
    finally:
        server.close()


def test_revive_requires_a_poisoned_pool(models):
    server = _server(models)
    try:
        with pytest.raises(RuntimeError, match="still running"):
            server.revive()
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="not poisoned"):
        server.revive()


def test_load_params_copies_in_place_and_refuses_other_trees(models):
    _, jparams, tcfg, params = models
    other_np = {k: np.asarray(v) * 1.5 for k, v in jparams.items()}
    server = PagedGenerationServer(
        {k: v.clone() for k, v in params.items()}, tcfg, slots=2, pages=16,
        page_size=4, window=4, prefix_cache=False, device="cpu")
    try:
        before = {k: v.data_ptr() for k, v in server._params.items()}
        other = params_from_numpy(other_np, tcfg, "cpu")
        server.load_params(other)
        assert {k: v.data_ptr() for k, v in server._params.items()} == before
        fresh = PagedGenerationServer(
            other, tcfg, slots=2, pages=16, page_size=4, window=4,
            prefix_cache=False, device="cpu")
        try:
            want = fresh.submit([3, 1, 4, 1, 5], 8)
        finally:
            fresh.close()
        assert server.submit([3, 1, 4, 1, 5], 8) == want
        with pytest.raises(ValueError, match="keys"):
            server.load_params({"embedding": other["embedding"]})
        bad = dict(other, w_up=other["w_up"].double())
        with pytest.raises(ValueError, match="w_up"):
            server.load_params(bad)
        bad = dict(other, ln_final=other["ln_final"][:-1])
        with pytest.raises(ValueError, match="ln_final"):
            server.load_params(bad)
    finally:
        server.close()


# ---- the supervisor on the real server ----------------------------------


def test_supervisor_heals_and_reloads_the_emergency_dump(models, tmp_path):
    """A fault mid-decode: the pool dumps its registry on the way down
    (an intact file a fresh server loads), the request in flight fails
    typed (no checkpoints here), and the supervisor revives the pool,
    re-pins the dump and re-restores the params; the prompt then hits
    the reloaded entries with its tokens alone, and the registry's pages
    are in the page count."""
    _, _, tcfg, params = models
    path = str(tmp_path / "prefix-cache.npz")
    plan = _FireWhen(("wharvest",), lambda server: any(
        r.prompt == [5, 4, 3, 2] for r in server._active.values()))
    server = plan.server = _server(models, plan=plan, prefix_cache=True)
    server.start_prefix_persistence(path, "fp-1", interval=3600.0)
    restores = []

    def restore_params():
        restores.append(1)
        return params

    sup = RecoverySupervisor(
        server, policy=RecoveryPolicy(max_attempts=2, **FAST),
        state_dir=str(tmp_path), prefix_path=path,
        prefix_fingerprint="fp-1", restore_params=restore_params,
        seed=5).attach()
    prompt = [7, 7, 7, 7, 2, 4, 6, 8, 1]
    try:
        server.submit(prompt, 4)   # the prompt's and the turn's entries
        assert server.stats()["prefix_entries"] >= 2
        dying = server._thread
        with pytest.raises(PoolPoisoned):
            server.submit([5, 4, 3, 2], 30)   # registers one more
        dying.join(timeout=BOUND_S)   # the dump ran on this thread
        assert prefix_file_intact(path)
        with np.load(path) as data:
            entries = len(json.loads(bytes(data["doc"]).decode())["entries"])
        assert entries >= 3
        fresh = _server(models, prefix_cache=True)
        try:
            assert fresh.load_prefix_cache(path, "fp-1") == entries
        finally:
            fresh.close()
        assert sup.wait_settled(timeout=BOUND_S) == HEALTHY
        sup._worker.join(timeout=BOUND_S)
        assert restores == [1]
        st = server.stats()
        assert st["prefix_entries"] == entries
        assert st["prefix_evictions"]["revive"] == entries
        assert sup.stats()["recoveries_total"] == 1
        _assert_idle(server)
        hits = st["prefix_hits"]
        assert server.submit(prompt, 4) == _alone(models, prompt, 4)
        assert server.stats()["prefix_hits"] == hits + 1
        _assert_idle(server)
    finally:
        sup.stop()
        server.close()


def test_supervisor_escalates_when_the_device_stays_unusable(models,
                                                             tmp_path):
    """Every revive fails at its first device call (on the card a sticky
    CUDA error does this): the supervisor escalates to terminal within
    its attempt budget, records no heal, and the pool keeps refusing
    with the retryable PoolPoisoned."""
    plan = FaultPlan(0, kinds=("raise",), fire_window=(1, 2),
                     seams=("wharvest",))
    server = _server(models, plan=plan, retry_after_s=7.0)

    def dead_device():
        raise RuntimeError("CUDA error: device-side assert triggered")

    server._cache.wait_device = dead_device
    sup = RecoverySupervisor(
        server, policy=RecoveryPolicy(max_attempts=2, **FAST),
        state_dir=str(tmp_path)).attach()
    try:
        with pytest.raises(PoolPoisoned):
            server.submit([3, 1, 4], 20)
        assert sup.wait_settled(timeout=BOUND_S) == TERMINAL
        st = sup.stats()
        assert st["recovery_attempts_total"] == 2
        assert st["recoveries_total"] == 0
        with pytest.raises(PoolPoisoned) as err:
            server.submit([3, 1, 4], 4)
        assert err.value.retry_after_s == 7.0
        assert server.degraded is not None
    finally:
        sup.stop()
        server.close()


# ---- /healthz and the 503 over HTTP --------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=BOUND_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    return _get(req)


def _runtime(tmp_path, attempts):
    cfg = ServeConfig(preset="probe", max_seq=64, payload_serving="paged",
                      serving_slots=2, serving_page_size=4,
                      serving_pages=32, serving_window=4,
                      serving_prefix_cache=False,
                      serving_recovery_attempts=attempts,
                      serving_retry_after_s=9.0,
                      state_dir=str(tmp_path))
    return boot_serve(cfg, device="cpu", dtype="float32",
                      host="127.0.0.1", port=0)


def test_healthz_recovering_then_healthy_and_the_503_hint(tmp_path):
    rt = _runtime(tmp_path, attempts=2)
    base = f"http://127.0.0.1:{rt.port}"
    gate = threading.Event()
    try:
        assert _get(base + "/healthz") == (200, {"status": "ok"})
        plan = FaultPlan(0, kinds=("raise",), fire_window=(0, 1),
                         seams=("wharvest",))
        FaultyCache.arm(rt.server._cache, plan)
        real_revive = rt.server.revive

        def held_revive(**kw):   # hold the supervisor in "recovering"
            assert gate.wait(BOUND_S)
            return real_revive(**kw)

        rt.server.revive = held_revive
        code, doc = _post(base + "/generate",
                          {"tokens": [[3, 1, 4]], "n_new": 8})
        # The request in flight fails with the poison itself, whose hint
        # is the taxonomy's default; later refusals carry the server's.
        assert code == 503 and doc["retry_after_s"] == 30.0
        assert "poisoned" in doc["error"]
        _wait(lambda: rt.supervisor.state == "recovering",
              "supervisor never started")
        code, doc = _get(base + "/healthz")
        assert code == 503
        assert doc["status"] == "degraded" and doc["recovering"] is True
        assert doc["terminal"] is False and doc["retry_after_s"] == 9.0
        assert doc["pages_total"] == 32 and "pages_free" in doc
        assert "InjectedFault" in doc["reason"]
        code, doc = _post(base + "/generate",
                          {"tokens": [[3, 1, 4]], "n_new": 8})
        assert code == 503 and doc["retry_after_s"] == 9.0
        gate.set()
        assert rt.supervisor.wait_settled(timeout=BOUND_S) == HEALTHY
        assert _get(base + "/healthz") == (200, {"status": "ok"})
        code, doc = _post(base + "/generate",
                          {"tokens": [[3, 1, 4]], "n_new": 8})
        assert code == 200 and len(doc["tokens"][0]) == 11
        record = json.loads((tmp_path / "last-failure.json").read_text())
        assert record["type"] == "PoolPoisoned" and record["retryable"]
    finally:
        gate.set()
        rt.close()


def test_healthz_terminal_without_a_supervisor(tmp_path):
    (tmp_path / "prefix-cache.npz.tmp").write_bytes(b"torn")
    rt = _runtime(tmp_path, attempts=0)
    base = f"http://127.0.0.1:{rt.port}"
    try:
        assert rt.supervisor is None
        assert not (tmp_path / "prefix-cache.npz.tmp").exists()  # swept
        FaultyCache.arm(rt.server._cache, FaultPlan(
            0, kinds=("raise",), fire_window=(0, 1), seams=("windowp",)))
        code, doc = _post(base + "/generate",
                          {"tokens": [[3, 1, 4]], "n_new": 8})
        assert code == 503 and doc["retry_after_s"] == 30.0
        code, doc = _get(base + "/healthz")
        assert code == 503 and doc["terminal"] is True
        assert "recovering" not in doc and "InjectedFault" in doc["reason"]
        code, doc = _post(base + "/generate",
                          {"tokens": [[3, 1, 4]], "n_new": 8})
        assert code == 503 and doc["retry_after_s"] == 9.0
    finally:
        rt.close()
