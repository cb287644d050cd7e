"""A lost follower on the port's slice, in one process.

The cases of ``tests/test_serving_faults.py`` and ``tests/test_recovery.py``
that drive ``FaultySliceTransport``: a ``"hang"`` at a broadcast (a
follower's collective that never returns) surfaces as a typed
``SliceFollowerLost`` within the op budget, every request terminates
and ``close()`` stays bounded; a broadcast that completes past its
deadline is typed the same; the recovery supervisor re-forms the op
stream (a fresh runner and a barrier SYNC) and revives the pool, with a
journaled in-flight request restored through the re-formed stream and
the same tokens served again; ``heal_at`` ends an outage window, and a
follower that never returns escalates to terminal. The model and the
numpy weights are ``tests/test_torch_sliceserve.py``'s, the tokens held
to the JAX package's ``generate`` at fp32.
"""

import pathlib
import sys
import threading
import time

import pytest
import torch

from kvedge_torch.models.kvcache import PagedCacheError
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.failures import (
    DeviceOpTimeout,
    OpBudgets,
    PoolPoisoned,
    ServingFailure,
    SliceFollowerLost,
)
from kvedge_torch.runtime.recovery import (
    HEALTHY,
    TERMINAL,
    RecoveryPolicy,
    RecoverySupervisor,
)
from kvedge_torch.runtime.sliceserve import SlicePagedKVCache
from kvedge_torch.testing.servingfaults import (
    FaultPlan,
    FaultySliceTransport,
    ServingFaultSchedule,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_sliceserve import CFG, slice_tree  # noqa: E402

torch.set_num_threads(2)

# A wedged op surfaces in seconds; a first run of an op on the CPU takes
# milliseconds, far inside even the cold schedules' compile budget.
BUDGETS = dict(steady_s=3.0, compile_s=20.0)
COLD = dict(steady_s=2.0, compile_s=2.0)
FAST = dict(backoff_base_s=0.1, backoff_cap_s=0.2, jitter=0.0,
            barrier_budget_s=2.0, teardown_budget_s=30.0)
PROMPT = [3, 1, 4, 1, 5]


@pytest.fixture(scope="module")
def params():
    return params_from_numpy(slice_tree(), CFG, "cpu")


@pytest.fixture(scope="module")
def want():
    import jax.numpy as jnp
    import numpy as np

    from kvedge_tpu.models import generate
    from test_torch_sliceserve import JCFG

    jparams = {k: jnp.asarray(v) for k, v in slice_tree().items()}

    def run(n_new):
        out = generate(jparams, jnp.asarray([PROMPT], jnp.int32), JCFG,
                       n_new=n_new)
        return [int(t) for t in np.asarray(out)[0]]

    return run


def _cache(budgets=BUDGETS):
    return SlicePagedKVCache(CFG, slots=3, pages=24, page_size=4,
                             max_pages_per_seq=16, device="cpu",
                             op_budgets=OpBudgets(**budgets))


def _join_dying(thread):
    """The supervisor hears of the poison on the dying decode thread:
    joining it is the barrier after which wait_settled sees the
    transition."""
    thread.join(timeout=30)
    assert not thread.is_alive()


def _stream_in_background(server, n_new):
    got, errs, done = [], [], threading.Event()

    def consume():
        try:
            got.extend(server.submit_stream(PROMPT, n_new))
        except Exception as e:
            errs.append(e)
        finally:
            done.set()

    threading.Thread(target=consume, daemon=True).start()
    return got, done, errs


def test_follower_death_mid_decode_terminates_typed(params):
    """A follower that stops answering mid-decode: every request ends in
    a typed error, the pool degrades with SliceFollowerLost, close()
    returns promptly, and the stream stays latched dead."""
    plan = FaultPlan(seed=7, kinds=("hang",), fire_window=(6, 7))
    cache = _cache(COLD)
    FaultySliceTransport(cache, plan)
    server = PagedGenerationServer(params, CFG, cache=cache, window=2)
    result = ServingFaultSchedule(server, plan, seed=7,
                                  join_timeout_s=60.0).run(n_requests=2,
                                                           n_new=6)
    assert result.fired_on == "bcast"
    assert "SliceFollowerLost" in result.degraded
    assert result.failed >= 1
    assert result.close_s < 30.0
    assert server._cache._ops.dead is not None


def test_follower_death_schedule_replays_from_seed(params):
    """Same seed, fresh server: the same seam trace and outcome."""
    traces = []
    for _ in range(2):
        plan = FaultPlan(seed=11, kinds=("hang",), fire_window=(5, 6))
        cache = _cache(COLD)
        FaultySliceTransport(cache, plan)
        server = PagedGenerationServer(params, CFG, cache=cache, window=2)
        result = ServingFaultSchedule(server, plan, seed=11,
                                      join_timeout_s=60.0).run(
            n_requests=1, n_new=5)
        assert result.degraded is not None
        traces.append(result.trace)
    assert traces[0] == traces[1]


def test_broadcast_delay_past_deadline_is_typed(params):
    """A broadcast that lands only after its deadline is a lost follower
    at detection time: typed, the pool poisoned, new submits refused
    with a retry hint."""
    plan = FaultPlan(seed=3, kinds=("delay",), fire_window=(5, 6),
                     delay_s=5.0)
    cache = _cache()
    server = PagedGenerationServer(params, CFG, cache=cache)
    server.submit(PROMPT, n_new=6)  # every op key on its steady budget
    FaultySliceTransport(cache, plan)
    try:
        with pytest.raises(ServingFailure) as exc_info:
            server.submit(PROMPT, n_new=6)
        assert isinstance(exc_info.value, DeviceOpTimeout)
        assert server.degraded is not None
        with pytest.raises(PoolPoisoned) as refused:
            server.submit(PROMPT, n_new=4)
        assert refused.value.retryable and refused.value.retry_after_s > 0
    finally:
        server.close()
        plan.close()
    assert not server._thread.is_alive()


def _warm_server(params, want):
    """A slice server with every op key of the request on its steady
    budget (the prefix cache off: a second identical request prefills
    the same chunk)."""
    server = PagedGenerationServer(params, CFG, cache=_cache(),
                                   prefix_cache=False)
    assert server.submit(PROMPT, n_new=6) == want(6)
    return server


def test_slice_outage_heals_in_process(params, want):
    """The heal loop: the prefill's header hangs (the follower is gone),
    the pool poisons with SliceFollowerLost, the first reformation
    barrier hangs too, the second passes once the outage window ends
    (heal_at), and the same process serves the same tokens again.
    Seams after warm-up: 0-1 the admit's SYNC, 2 the prefill header,
    3 the first barrier, 4-5 the second."""
    server = _warm_server(params, want)
    plan = FaultPlan(seed=3, kinds=("hang",), fire_window=(2, 3),
                     heal_at=4)
    FaultySliceTransport(server._cache, plan)
    sup = RecoverySupervisor(server, policy=RecoveryPolicy(
        max_attempts=3, **FAST), seed=5).attach()
    dying = server._thread
    try:
        with pytest.raises(ServingFailure) as exc_info:
            server.submit(PROMPT, n_new=6)
        assert isinstance(exc_info.value, SliceFollowerLost)
        _join_dying(dying)
        assert sup.wait_settled(timeout=60.0) == HEALTHY
        assert server.degraded is None
        assert server._cache._ops.dead is None
        stats = sup.stats()
        assert (stats["recoveries_total"], stats["recovery_attempts_total"],
                stats["recovery_failures_total"]) == (1, 2, 0)
        assert server.submit(PROMPT, n_new=6) == want(6)
    finally:
        server.close()
        plan.close()


def test_slice_escalates_when_followers_never_return(params, want):
    """The outage never ends: every barrier times out, and after the
    attempt budget the machine is terminal; the pool keeps refusing with
    the typed, retryable error."""
    server = _warm_server(params, want)
    plan = FaultPlan(seed=3, kinds=("hang",), fire_window=(2, 3),
                     heal_at=10**9)
    FaultySliceTransport(server._cache, plan)
    sup = RecoverySupervisor(server, policy=RecoveryPolicy(
        max_attempts=2, **FAST), seed=5).attach()
    dying = server._thread
    try:
        with pytest.raises(ServingFailure):
            server.submit(PROMPT, n_new=6)
        _join_dying(dying)
        assert sup.wait_settled(timeout=60.0) == TERMINAL
        assert sup.health()["terminal"] is True
        stats = sup.stats()
        assert (stats["recoveries_total"], stats["recovery_attempts_total"],
                stats["recovery_failures_total"]) == (0, 2, 1)
        with pytest.raises(PoolPoisoned):
            server.submit(PROMPT, n_new=6)
    finally:
        server.close()
        plan.close()


def test_slice_reformation_restores_in_flight(params, want):
    """A broadcast dies mid-decode on a checkpointing slice server; the
    supervisor re-forms the stream and revives, the journaled request is
    restored through the re-formed transport (its admit and swap-in
    replayed), and it completes with the decode's tokens."""
    server = PagedGenerationServer(params, CFG, cache=_cache(), window=2,
                                   checkpoint_every=1, prefix_cache=False)
    assert server.submit(PROMPT, n_new=8) == want(8)
    plan = FaultPlan(seed=3, kinds=("raise",), fire_window=(8, 9))
    FaultySliceTransport(server._cache, plan)
    sup = RecoverySupervisor(server, policy=RecoveryPolicy(
        max_attempts=3, **FAST), seed=5).attach()
    dying = server._thread
    try:
        got, done, errs = _stream_in_background(server, 8)
        _join_dying(dying)
        assert sup.wait_settled(timeout=60.0) == HEALTHY
        assert done.wait(timeout=60)
        assert not errs, errs
        assert PROMPT + got == want(8)
        stats = server.stats()
        assert stats["journal_restores_total"] == 1
        assert stats["journal_entries"] == 0
    finally:
        server.close()
        plan.close()


def test_reform_replaces_dead_stream():
    cache = _cache()
    wedge = threading.Event()
    try:
        with pytest.raises(SliceFollowerLost):
            cache._ops.run(("wedge",), lambda: wedge.wait(60), budget_s=0.2)
        assert cache._ops.dead is not None
        cache.reform(budget_s=5.0)
        assert cache._ops.dead is None
        assert cache._ops.run(("noop",), lambda: 42, budget_s=5.0) == 42
    finally:
        wedge.set()
        cache.stop()
    with pytest.raises(PagedCacheError, match="stopped"):
        cache.reform()
    start = time.monotonic()
    cache.stop()  # idempotent: no second STOP
    assert time.monotonic() - start < 1.0
