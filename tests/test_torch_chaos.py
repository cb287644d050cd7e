"""The port's chaos campaigns (``kvedge_torch/testing/chaos.py``) on the
CPU, at the reference's shapes (``tests/test_chaos.py``: vocab 128,
d_model 32, 4 heads, 2 KV heads, 2 layers, fp32, 2 rounds of 3
requests, n_new 6) and seeds.

* The decision stream — ``_draw_config``, the server shape, every
  round's plan (kind and ``fire_at``), the prompts and the consumer
  mix — equals the reference campaign's for the reference's pinned
  seeds and for the first five seeds of its soak (the reference run
  with its server, cache and consumers stubbed out, which draws the
  same stream without decoding).
* The deterministic subset passes every invariant with at least one
  revive and one restored request, every armed round firing; so do the
  reference's prefix-mix campaigns, and a campaign on the default
  oracle (the port's ``models.decode.generate``), whose tokens are the
  JAX package's.
* A round whose plan cannot fire is a breach; the ``"delay"`` kind is
  drawn as the reference draws it and stalls without raising.
* The ``debug_pages`` audit trips, typed and terminal, on a seeded page
  leak, and passes a clean pool.

Every campaign is bounded by ``join_timeout_s`` = 60 s.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvedge_tpu.models.serving as jserving
from kvedge_tpu.models import generate as jgenerate
from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.testing import chaos as jchaos
from kvedge_tpu.testing import servingfaults as jfaults
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.failures import (
    PageAccountingError,
    ServingFailure,
)
from kvedge_torch.testing import chaos
from kvedge_torch.testing.faults import InvariantViolation
from kvedge_torch.testing.servingfaults import (
    FaultPlan,
    FaultyCache,
    InjectedFault,
)

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")

# The reference's pinned shapes and seeds (tests/test_chaos.py).
SERIAL = dict(checkpoint_every=1, overlap="off", window=2,
              speculative=0, spec_window=0)
OVERLAP = dict(checkpoint_every=1, overlap="on", window=2,
               speculative=0, spec_window=0)
SPEC = dict(checkpoint_every=2, overlap="off", window=2,
            speculative=2, spec_window=0)
PINNED = [(11, SERIAL), (17, SERIAL), (3, OVERLAP), (17, SPEC)]
PINNED_IDS = ["serial-11", "serial-17", "overlap-3", "spec-17"]
PREFIX = [(1, SERIAL), (5, SERIAL), (5, OVERLAP)]
PREFIX_IDS = ["serial-1", "serial-5", "overlap-5"]
SOAK_SEEDS = range(100, 105)   # the first five of the reference's soak

ROUNDS = 2
PER_ROUND = 3
N_NEW = 6
BOUND_S = 60.0


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def oracle(models):
    """The fault-free greedy reference, memoized across campaigns."""
    _, _, tcfg, params = models
    memo: dict = {}

    def fn(prompt, n_new):
        key = (tuple(prompt), n_new)
        if key not in memo:
            out = generate(params, [prompt], tcfg, n_new, device="cpu")
            memo[key] = [int(t) for t in out[0].tolist()]
        return memo[key]

    return fn


def _campaign(models, oracle, seed, config=None, **kw):
    _, _, tcfg, params = models
    return chaos.run_chaos_campaign(
        params, tcfg, seed=seed, rounds=ROUNDS,
        requests_per_round=PER_ROUND, n_new=N_NEW, config=config,
        oracle=oracle, join_timeout_s=BOUND_S, device="cpu", **kw)


def _decisions(trace):
    """The decision lines of a campaign trace: the campaign's shape, each
    plan, each submission (runtime lines — revives, outcomes, seams —
    depend on the run)."""
    return [ln for ln in trace
            if ln.startswith(("[campaign]", "[plan]")) or "submit" in ln]


class _StubCache:
    def __init__(self, *args, **kwargs):
        self.plan = None


class _StubServer:
    """Stands in for the reference's server: admits nothing, decodes
    nothing, never degrades; the campaign still draws every decision."""

    degraded = None

    def __init__(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _stub_drive(server, sub):
    sub.tokens = list(sub.want)
    sub.finished.set()


def _reference_trace(monkeypatch, seed, config, prefix_mix=False):
    """The reference campaign's trace with its server, cache, consumers
    and settle checks stubbed out: the decision stream it draws."""
    with monkeypatch.context() as m:
        m.setattr(jserving, "PagedGenerationServer", _StubServer)
        m.setattr(jchaos, "FaultyCache", _StubCache)
        m.setattr(jchaos, "_drive", _stub_drive)
        m.setattr(jchaos, "_check_settled", lambda *a, **k: None)
        m.setattr(jchaos, "_check_bundle", lambda *a, **k: None)
        res = jchaos.run_chaos_campaign(
            None, jtr.TransformerConfig(**KW), seed=seed, rounds=ROUNDS,
            requests_per_round=PER_ROUND, n_new=N_NEW, config=config,
            oracle=lambda prompt, n: prompt + [0] * n,
            prefix_mix=prefix_mix)
    return res.config, res.trace


@pytest.mark.parametrize("seed", [11, 17, 3, *SOAK_SEEDS, 1, 5])
def test_draw_config_equals_the_reference(seed):
    assert chaos._draw_config(random.Random(seed)) == \
        jchaos._draw_config(random.Random(seed))


@pytest.mark.parametrize(
    "seed,config,prefix_mix",
    [(s, c, False) for s, c in PINNED]
    + [(s, None, False) for s in SOAK_SEEDS] + [(*PREFIX[0], True)],
    ids=PINNED_IDS + [f"soak-{s}" for s in SOAK_SEEDS] + ["prefix-1"])
def test_decision_trace_equals_the_reference(models, oracle, monkeypatch,
                                             seed, config, prefix_mix):
    want_cfg, want = _reference_trace(monkeypatch, seed, config, prefix_mix)
    res = _campaign(models, oracle, seed, config, prefix_mix=prefix_mix)
    assert res.config == want_cfg
    assert _decisions(res.trace) == _decisions(want)
    # Every round's plan fired, on a decode-loop seam.
    assert len(res.fired) == ROUNDS
    assert all(f is not None and not f.startswith("prefill")
               for f in res.fired), res.fired


@pytest.mark.parametrize("seed,config", PINNED, ids=PINNED_IDS)
def test_deterministic_campaign(models, oracle, seed, config):
    """The reference's deterministic subset: the campaign revives,
    restores journaled requests and finishes every survivor bit-identical
    to the fault-free oracle (the harness raises otherwise)."""
    res = _campaign(models, oracle, seed, config)
    assert res.completed + res.failed == ROUNDS * PER_ROUND
    assert res.revives >= 1, res.fired
    assert res.restored_total >= 1, res.fired
    assert res.completed >= res.restored_total
    assert all(f is not None for f in res.fired)


@pytest.mark.parametrize("seed,config", PREFIX, ids=PREFIX_IDS)
def test_prefix_mix_campaign(models, oracle, seed, config):
    """The prefix cache on and prompts sharing page-sized stems: the
    refcount-aware conservation check holds after every round."""
    res = _campaign(models, oracle, seed, config, prefix_mix=True)
    assert res.completed + res.failed == ROUNDS * PER_ROUND
    assert res.revives >= 1, res.fired


def test_default_oracle_is_the_ports_generate_and_the_references(models):
    """With no oracle the campaign decodes each prompt with the port's
    greedy ``generate``, whose tokens are the JAX package's."""
    jcfg, jparams, tcfg, params = models
    res = chaos.run_chaos_campaign(
        params, tcfg, seed=11, rounds=ROUNDS, requests_per_round=PER_ROUND,
        n_new=N_NEW, config=SERIAL, join_timeout_s=BOUND_S, device="cpu")
    assert res.completed + res.failed == ROUNDS * PER_ROUND
    for prompt in ([3, 1, 4, 1, 5], [100, 7, 9]):
        want = jgenerate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                         n_new=N_NEW)
        got = generate(params, [prompt], tcfg, N_NEW, device="cpu")
        assert got[0].tolist() == [int(t) for t in np.asarray(want)[0]]


def test_a_plan_that_cannot_fire_is_a_breach(models, oracle):
    """n_new 1: a request ends at its prefill, no decode-loop seam has a
    row in flight, so the armed plan never fires — a breach, with the
    decision trace."""
    _, _, tcfg, params = models
    with pytest.raises(InvariantViolation, match="never fired") as err:
        chaos.run_chaos_campaign(
            params, tcfg, seed=11, rounds=1, requests_per_round=2,
            n_new=1, config=SERIAL, oracle=oracle,
            join_timeout_s=BOUND_S, device="cpu")
    assert err.value.trace[0].startswith("[campaign] seed=11")


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_delay_kind_is_drawn_as_the_reference_and_stalls(seed):
    ours = FaultPlan(seed, kinds=("raise", "delay"), fire_window=(1, 9),
                     delay_s=0.001)
    theirs = jfaults.FaultPlan(seed, kinds=("raise", "delay"),
                               fire_window=(1, 9), delay_s=0.001)
    assert (ours.kind, ours.fire_at) == (theirs.kind, theirs.fire_at)
    assert ours.trace[0] == theirs.trace[0]
    for i in range(ours.fire_at):
        ours.at_seam(f"windowp[{i}]")
    if ours.kind == "raise":
        with pytest.raises(InjectedFault):
            ours.at_seam("wharvest")
    else:
        ours.at_seam("wharvest")          # sleeps, then proceeds
    assert ours.fired_on == "wharvest"
    ours.at_seam("swapout")               # fires once only
    assert ours.trace[-1] == f"[{ours.fire_at + 1}] swapout"


class _LeakyCache(FaultyCache):
    """Steals one free page at the first admit: the books then claim one
    page fewer than the pool owns."""

    leaked = False

    def admit(self, *args, **kwargs):
        out = super().admit(*args, **kwargs)
        if not self.leaked and self._free:
            self._free.pop()
            self.leaked = True
        return out


def test_debug_pages_audit_trips_on_seeded_leak(models):
    _, _, tcfg, params = models
    server = PagedGenerationServer(params, tcfg, slots=2, pages=16,
                                   page_size=4, debug_pages=True,
                                   prefix_cache=False, device="cpu")
    server._cache.__class__ = _LeakyCache
    try:
        with pytest.raises(ServingFailure):
            server.submit([3, 1, 4], n_new=6, timeout=BOUND_S)
        # The typed audit failure, terminal: a replacement process running
        # the same code leaks the same way.
        assert isinstance(server._poison, PageAccountingError)
        assert server._poison.retryable is False
        assert "free" in str(server._poison)
    finally:
        server.close()


def test_debug_pages_audit_passes_clean_pool(models, oracle):
    _, _, tcfg, params = models
    server = PagedGenerationServer(params, tcfg, slots=2, pages=16,
                                   page_size=4, debug_pages=True,
                                   checkpoint_every=1, prefix_cache=False,
                                   device="cpu")
    FaultyCache.arm(server._cache, None)
    try:
        out = server.submit([3, 1, 4], n_new=6, timeout=BOUND_S)
        assert out == oracle([3, 1, 4], 6)
        assert server.degraded is None
        acct = server._cache.page_accounting()
        assert acct["free"] == acct["pages_total"]
    finally:
        server.close()
