"""The port's failure taxonomy, journal, recovery supervisor and fault plan.

* ``kvedge_torch/runtime/failures.py`` and ``runtime/journal.py`` are the
  JAX package's modules but for their docstrings; the heartbeat subset
  and the recovery supervisor are its functions but for the supervisor's
  in-place params re-restore and its (absent) flight recorder.
* The taxonomy classifies as the reference's, ``DeadlineRunner`` latches
  dead after a timeout, the journal makes the reference's budget
  decisions on one operation sequence, and ``FaultPlan`` draws the
  reference's kind and index from a seed and refuses the kinds that
  wait for multi-host serving.
* The supervisor: the crash-loop breaker escalates a thrashing lineage
  at once, a healed outcome is not a strike, ``sweep_stranded_tmp``
  removes only top-level ``*.tmp`` files.
* The four recovery knobs parse and fail as the reference's parser's.
* ``_emit`` streams a restored request's replayed tokens exactly once;
  a torn prefix dump is not intact.
"""

import inspect
import threading

import numpy as np
import pytest

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.config.runtime_config import RuntimeConfigError as JaxError
from kvedge_tpu.runtime import failures as jfail
from kvedge_tpu.runtime import heartbeat as jhb
from kvedge_tpu.runtime import journal as jjournal
from kvedge_tpu.runtime import recovery as jrec
from kvedge_tpu.testing import servingfaults as jfaults
from kvedge_torch.models.serving import PagedGenerationServer, _Request
from kvedge_torch.runtime import failures as tfail
from kvedge_torch.runtime import heartbeat as thb
from kvedge_torch.runtime import journal as tjournal
from kvedge_torch.runtime import recovery as trec
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig
from kvedge_torch.testing import servingfaults as tfaults


def _body(mod) -> str:
    """A module's source below its docstring."""
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]


# ---- the copies are the reference's -------------------------------------


@pytest.mark.parametrize("ours,theirs", [(tfail, jfail),
                                         (tjournal, jjournal)],
                         ids=["failures", "journal"])
def test_the_copy_is_the_reference_but_for_its_docstring(ours, theirs):
    assert _body(ours) == _body(theirs)


def test_heartbeat_subset_is_the_reference_functions():
    names = ("read_init_events", "append_init_event", "_read_json_doc",
             "_write_json_atomic", "read_heartbeat", "write_failure_record",
             "read_failure_record")
    for name in names:
        assert (inspect.getsource(getattr(thb, name))
                == inspect.getsource(getattr(jhb, name))), name
    for const in ("HEARTBEAT_FILE", "INIT_EVENTS_FILE", "INIT_EVENTS_TAIL",
                  "FAILURE_FILE", "_INIT_EVENTS_READ_BYTES"):
        assert getattr(thb, const) == getattr(jhb, const), const


def test_recovery_copy_differs_only_in_params_and_tracing():
    """Every function of the supervisor module is the reference's,
    ``_trace_event`` (the flight recorder's recovery instants) included,
    but ``_attempt_once``, whose step 4 copies the params in place
    instead of rebinding them."""
    changed = {"_attempt_once"}
    assert trec.RecoveryPolicy() == trec.RecoveryPolicy(
        **vars(jrec.RecoveryPolicy()))
    assert (inspect.getsource(trec.sweep_stranded_tmp)
            == inspect.getsource(jrec.sweep_stranded_tmp))
    for name, fn in vars(jrec.RecoverySupervisor).items():
        if not inspect.isfunction(fn) or name in changed:
            continue
        assert (inspect.getsource(getattr(trec.RecoverySupervisor, name))
                == inspect.getsource(fn)), name
    ours = inspect.getsource(trec.RecoverySupervisor._attempt_once)
    theirs = inspect.getsource(jrec.RecoverySupervisor._attempt_once)
    assert "server._params = params" in theirs
    assert "server._params = params" not in ours
    assert "server.load_params(params)" in ours
    assert ours.replace(
        "                    # In place: every captured graph holds the "
        "addresses\n                    # of the tensors it was captured "
        "with.\n                    server.load_params(params)",
        "                    server._params = params") == theirs


# ---- the taxonomy --------------------------------------------------------


def test_taxonomy_classifies_as_the_reference():
    for mod in (tfail, jfail):
        assert mod.DEFAULT_RETRY_AFTER_S == 30.0
        assert mod.PoolPoisoned("x").retryable
        assert mod.PoolPoisoned("x").retry_after_s == 30.0
        assert not mod.PageAccountingError("x").retryable
        assert not mod.DeviceOpTimeout("x").retryable
        assert issubclass(mod.SliceFollowerLost, mod.DeviceOpTimeout)
        lost = mod.SliceFollowerLost("gone", op="bcast", budget_s=2.0)
        assert mod.classify_failure(lost) is lost
        cause = KeyError("boom")
        wrapped = mod.classify_failure(cause)
        assert type(wrapped).__name__ == "PoolPoisoned"
        assert wrapped.__cause__ is cause
        assert str(wrapped) == ("serving pool poisoned by KeyError: "
                                "'boom'")


def test_op_budgets_compile_then_steady():
    b = tfail.OpBudgets(steady_s=1.0, compile_s=5.0)
    assert b.budget(("window", 8)) == (5.0, True)
    assert b.budget(("window", 8)) == (1.0, False)
    assert b.budget(("window", 16)) == (5.0, True)


def test_deadline_runner_latches_dead():
    """A wedged op times out typed, and every later op refuses at once
    without running: the stream is dead."""
    release = threading.Event()
    runner = tfail.DeadlineRunner(
        tfail.OpBudgets(steady_s=0.05, compile_s=0.05),
        failure=tfail.SliceFollowerLost)
    try:
        assert runner.run("warm", lambda: 7) == 7
        with pytest.raises(tfail.SliceFollowerLost, match="exceeded"):
            runner.run("wedge", lambda: release.wait(timeout=10.0))
        assert runner.dead == "wedge"
        ran = []
        with pytest.raises(tfail.SliceFollowerLost, match="dead"):
            runner.run("after", lambda: ran.append(1))
        assert ran == []
        with pytest.raises(ValueError, match="raised"):
            fresh = tfail.DeadlineRunner()
            fresh.run("bad", lambda: (_ for _ in ()).throw(
                ValueError("raised")))
        fresh.shutdown()
    finally:
        release.set()
        runner.shutdown()


# ---- the journal ---------------------------------------------------------


def _journal_ops(mod):
    """One operation sequence; returns what the journal decided."""
    j = mod.RequestJournal(max_bytes=100)
    dropped = []
    j.on_drop = lambda e: dropped.append((e.req, e.nbytes))

    def entry(req, seq, nbytes, node=None):
        return mod.JournalEntry(
            req=req, pclass="interactive", ticket_no=seq, admit_seq=seq,
            pages_reserved=2, saved_len=5, gen_len=1, next_token=3,
            emitted=1, arrays=(), nbytes=nbytes, prefix_node=node)

    out = [j.put("a", entry("a", 2, 40)), j.put("b", entry("b", 1, 50)),
           j.put("c", entry("c", 0, 20)),          # over budget: refused
           j.put("a", entry("a", 2, 30)),          # a replace frees 40
           j.put("c", entry("c", 0, 20), extra=5),
           len(j), j.nbytes]
    j.adjust_extra(5)
    out += [j.nbytes, j.extra_bytes, j.put("d", entry("d", 3, 1))]
    out.append(j.pop("b").nbytes if "b" in j else None)
    out.append([e.req for e in j.take_all()])
    out += [len(j), j.nbytes, dropped]
    with pytest.raises(ValueError):
        j.adjust_extra(-6)
    with pytest.raises(ValueError):
        mod.RequestJournal(max_bytes=-1)
    return out


def test_journal_makes_the_reference_decisions():
    got = _journal_ops(tjournal)
    assert got == _journal_ops(jjournal)
    assert got[2] is False and got[-1] == [("a", 40), ("b", 50)]


# ---- the fault plan ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_fault_plan_draws_the_reference_kind_and_index(seed):
    ours = tfaults.FaultPlan(seed, fire_window=(1, 40))
    theirs = jfaults.FaultPlan(seed, kinds=("raise",), fire_window=(1, 40))
    assert (ours.kind, ours.fire_at) == (theirs.kind, theirs.fire_at)
    assert ours.trace[0] == theirs.trace[0]


# The multi-host kind "hang" (a lost follower) is the reference's since
# the slice's transport injector: it draws the reference's decision, and
# a kind neither package has is refused.
@pytest.mark.parametrize("kinds", [("hang",), ("raise", "hang")])
def test_fault_plan_refuses_the_multi_host_kinds(kinds):
    ours = tfaults.FaultPlan(0, kinds=kinds, heal_at=9)
    theirs = jfaults.FaultPlan(0, kinds=kinds, heal_at=9)
    assert (ours.kind, ours.fire_at) == (theirs.kind, theirs.fire_at)
    assert ours.trace[0] == theirs.trace[0]
    with pytest.raises(ValueError, match="kinds"):
        tfaults.FaultPlan(0, kinds=kinds + ("melt",))


def test_fault_plan_seams_filter_counts_only_matching_labels():
    plan = tfaults.FaultPlan(0, kinds=("raise",), fire_window=(1, 2),
                             seams=("windowp",))
    for label in ("prefill[5]", "windowp[4]", "wharvest", "swapout"):
        plan.at_seam(label)
    with pytest.raises(tfaults.InjectedFault, match="windowp"):
        plan.at_seam("windowp[4]")
    assert plan.fired_on == "windowp[4]" and plan.count == 2
    assert plan.trace[1:] == ["[-] prefill[5]", "[0] windowp[4]",
                              "[-] wharvest", "[-] swapout",
                              "[1] windowp[4] <- raise"]


def test_prefix_file_intact_flags_a_torn_file(tmp_path):
    path = tmp_path / "prefix-cache.npz"
    assert tfaults.prefix_file_intact(str(path))   # absent is intact
    np.savez(path, doc=np.frombuffer(b'{"entries": []}', np.uint8),
             pool_k=np.zeros((1, 1)), pool_v=np.zeros((1, 1)))
    assert tfaults.prefix_file_intact(str(path))
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    assert not tfaults.prefix_file_intact(str(path))
    assert not jfaults.prefix_file_intact(str(path))


# ---- the supervisor without a server thread's timing --------------------


class _StubServer:
    """The attributes the supervisor reads, with a revive that counts."""

    def __init__(self, revive_error=None):
        self.on_degraded = None
        self.retry_after_hint = None
        self._thread = threading.Thread(target=lambda: None)
        self._thread.start()
        self._cache = object()
        self.revives = 0
        self.revive_error = revive_error

    def revive(self):
        self.revives += 1
        if self.revive_error is not None:
            raise self.revive_error
        return 3


FAST = dict(backoff_base_s=0.01, backoff_cap_s=0.02, jitter=0.0)


def test_crash_loop_breaker_escalates_at_once(tmp_path):
    state = str(tmp_path)
    for outcome in ("failed", "escalated", "healed", "healed"):
        thb.append_init_event(state, {"event": "serve-recovery",
                                      "outcome": outcome})
    thb.append_init_event(state, {"event": "give-up"})
    server = _StubServer()
    sup = trec.RecoverySupervisor(
        server, policy=trec.RecoveryPolicy(max_attempts=2, **FAST),
        state_dir=state).attach()
    server.on_degraded("PoolPoisoned: x", None)
    assert sup.wait_settled(timeout=10.0) == trec.TERMINAL
    assert server.revives == 0
    assert sup.stats()["recovery_failures_total"] == 1
    assert sup.health() == {"state": "terminal", "terminal": True}
    events = thb.read_init_events(state)
    assert events[-1]["outcome"] == "escalated"
    assert "3 crash-loop strikes" in events[-1]["detail"]


def test_healed_outcomes_are_not_strikes(tmp_path):
    state = str(tmp_path)
    for _ in range(5):
        thb.append_init_event(state, {"event": "serve-recovery",
                                      "outcome": "healed"})
    server = _StubServer()
    observed = []
    server.on_degraded = lambda r, f: observed.append(r)
    sup = trec.RecoverySupervisor(
        server, policy=trec.RecoveryPolicy(max_attempts=2, **FAST),
        state_dir=state).attach()
    server.on_degraded("PoolPoisoned: y", None)
    assert sup.wait_settled(timeout=10.0) == trec.HEALTHY
    sup._worker.join(timeout=10.0)   # it records after settling
    assert observed == ["PoolPoisoned: y"]   # the chained observer ran
    assert server.revives == 1
    st = sup.stats()
    assert st["recoveries_total"] == 1 and st["recovery_state"] == "healthy"
    last = thb.read_init_events(state)[-1]
    assert last["outcome"] == "healed" and "3 in-flight restored" in \
        last["detail"]


def test_attempt_budget_escalates_a_revive_that_keeps_failing(tmp_path):
    server = _StubServer(revive_error=tfail.PoolPoisoned("device gone"))
    sup = trec.RecoverySupervisor(
        server, policy=trec.RecoveryPolicy(max_attempts=3, **FAST),
        state_dir=str(tmp_path)).attach()
    server.on_degraded("PoolPoisoned: z", None)
    assert sup.wait_settled(timeout=10.0) == trec.TERMINAL
    sup._worker.join(timeout=10.0)
    assert server.revives == 3
    outcomes = [e["outcome"] for e in thb.read_init_events(str(tmp_path))]
    assert outcomes == ["failed", "failed", "failed", "escalated"]
    assert sup.stats()["recoveries_total"] == 0


def test_sweep_stranded_tmp(tmp_path):
    (tmp_path / "prefix-cache.npz.tmp").write_bytes(b"x")
    (tmp_path / "last-failure.json.tmp").write_text("{")
    (tmp_path / "prefix-cache.npz").write_bytes(b"keep")
    (tmp_path / "sub.tmp").mkdir()
    assert trec.sweep_stranded_tmp(str(tmp_path)) == [
        "last-failure.json.tmp", "prefix-cache.npz.tmp"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "prefix-cache.npz", "sub.tmp"]
    assert trec.sweep_stranded_tmp(str(tmp_path / "absent")) == []
    assert trec.sweep_stranded_tmp("") == []


def test_failure_record_round_trip(tmp_path):
    rec = thb.write_failure_record(str(tmp_path), {"type": "PoolPoisoned"})
    assert rec["boot_count"] == 0 and "ts" in rec
    assert thb.read_failure_record(str(tmp_path)) == rec
    assert jhb.read_failure_record(str(tmp_path)) == rec


# ---- the knobs against the reference's parser ----------------------------


KNOB_CASES = (
    "",
    "serving_retry_after_s = 5.0\n",
    "serving_retry_after_s = 5\n",
    "serving_recovery_attempts = 0\n",
    "serving_recovery_attempts = 4\n",
    "serving_checkpoint_every = 16\n",
    "serving_debug_pages = true\n",
    "serving_retry_after_s = 0.0\n",
    "serving_retry_after_s = -1.0\n",
    "serving_recovery_attempts = -1\n",
    "serving_checkpoint_every = -2\n",
    "serving_debug_pages = 1\n",
)
KNOBS = ("serving_retry_after_s", "serving_recovery_attempts",
         "serving_checkpoint_every", "serving_debug_pages")


@pytest.mark.parametrize("text", KNOB_CASES)
def test_recovery_knobs_parse_as_the_reference(text):
    doc = "[payload]\n" + text
    try:
        want = JaxConfig.parse(doc)
    except JaxError as e:
        with pytest.raises(RuntimeConfigError) as got:
            ServeConfig.parse(doc)
        name = text.split(" =")[0]
        assert name in str(got.value) and name in str(e)
        return
    got = ServeConfig.parse(doc)
    for knob in KNOBS:
        assert getattr(got, knob) == getattr(want, knob), knob
        assert type(getattr(got, knob)) is type(getattr(want, knob)), knob


def test_recovery_knob_defaults_are_the_reference():
    got, want = ServeConfig(), JaxConfig()
    assert [getattr(got, k) for k in KNOBS] == [getattr(want, k)
                                                for k in KNOBS]
    assert got.serving_recovery_attempts == 2


# ---- exactly-once streams ------------------------------------------------


def test_emit_streams_a_restored_replay_exactly_once():
    """After a journal restore rewound ``generated`` below what the
    consumer already read, the replayed tokens are recorded again but
    streamed only from the watermark on, by ``_emit`` and by the bulk
    ``_emit_many`` alike."""
    import queue
    req = _Request(prompt=[1], n_new=8, stream=queue.SimpleQueue())
    for t in (5, 6, 7):
        PagedGenerationServer._emit(req, t)
    # The restore: the checkpoint had 1 token, 3 were delivered.
    del req.generated[1:]
    req.stream_resume_at = 3
    PagedGenerationServer._emit(req, 6)
    PagedGenerationServer._emit_many(req, [7, 8, 9])
    PagedGenerationServer._emit_many(req, [])
    streamed = []
    while not req.stream.empty():
        streamed.append(req.stream.get())
    assert req.generated == [5, 6, 7, 8, 9]
    assert streamed == [5, 6, 7, 8, 9]
