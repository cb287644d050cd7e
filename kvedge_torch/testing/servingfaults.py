"""Seeded fault injection for the SERVING path.

The port's counterpart of the JAX package's
``kvedge_tpu/testing/servingfaults.py``, over the port's own device
seams: faults fire at the boundaries where a device op fails — a
prefill chunk, a step, a window's dispatch or harvest, a spec window's,
a swap — or where a multi-process slice's broadcast stalls
(:class:`FaultySliceTransport`), while concurrent requests are in
flight, and the harness then asserts the recovery contract the taxonomy
(``runtime/failures.py``) promises:

* **Every request terminates** — tokens or a typed error, never a hang.
* **No token is emitted twice** and no stream over-emits its budget.
* **The server lock is never orphaned**.
* **close() stays bounded** and the decode thread is actually gone.
* **Prefix-cache files are never torn** — absent or fully loadable.

Deterministic per seed: the plan draws its fault kind and firing seam
from ``random.Random(seed)`` and records every seam it crosses in
``trace``, with the reference's labels, so the same plan on the same
traffic can be held against the JAX server's trace label by label.

To drive a fault on the CPU::

    server = PagedGenerationServer(params, cfg, slots=2, pages=16,
                                   page_size=4, checkpoint_every=1,
                                   device="cpu")
    plan = FaultPlan(seed=0, kinds=("raise",), fire_window=(3, 4))
    FaultyCache.arm(server._cache, plan)

:meth:`FaultyCache.arm` puts a plan on any live cache, one a runtime
built too. The plan's kinds are the reference's: ``"raise"``,
``"delay"`` (the seam sleeps ``delay_s``, then proceeds) and ``"hang"``
(the seam parks like a lost follower's collective); ``heal_at`` turns a
plan into an outage window. :class:`FaultySliceTransport` puts a plan on
a ``runtime/sliceserve.SlicePagedKVCache``'s broadcasts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time

import numpy as np

from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.runtime.failures import ServingFailure
from kvedge_torch.testing.faults import InvariantViolation

__all__ = [
    "FaultPlan",
    "FaultyCache",
    "FaultySliceTransport",
    "InjectedFault",
    "InvariantViolation",
    "ServingFaultResult",
    "ServingFaultSchedule",
    "prefix_file_intact",
]


class InjectedFault(RuntimeError):
    """The raw (untyped) error a fault injector raises at a seam —
    deliberately NOT a ServingFailure, so runs also prove the
    classification path (classify_failure wraps it as PoolPoisoned)."""


class FaultPlan:
    """A seeded decision of WHAT fails and WHEN.

    The plan counts every seam crossing (a device op on a
    :class:`FaultyCache`, a broadcast on a :class:`FaultySliceTransport`)
    and fires ONCE, at the drawn index: with ``"raise"`` the seam raises
    :class:`InjectedFault` (a device op failing loudly), with ``"delay"``
    it sleeps ``delay_s`` and proceeds (a slow op or a stalled
    broadcast), with ``"hang"`` it parks until :meth:`close` (a dead
    follower: only the deadline watchdog can see it) and then raises, so
    an orphaned op thread never mutates the pools behind a pool that
    already poisoned. Every seam after it succeeds. ``kinds`` is drawn
    from as the reference draws it, so a seed picks the reference's kind
    and ``fire_at``.

    ``heal_at`` switches to the reference's **outage-window** semantics
    for recovery schedules: every seam crossing in ``[fire_at,
    heal_at)`` fires (the follower is gone, not glitching), and from
    ``heal_at`` on they succeed (the follower rejoined). A ``heal_at``
    beyond any reachable count models a follower that never returns.

    ``seams`` (the port's addition) restricts the count to the crossings
    whose label starts with one of its prefixes (``("windowp",)`` fires
    at the ``fire_at``-th window dispatch). A subclass may count by its
    own rule: :meth:`weight` (a crossing of weight w takes w counts)
    and :meth:`may_fire` (the plan fires at the first crossing it
    allows once the count has passed ``fire_at``). Every crossing still
    lands in ``trace``.
    """

    def __init__(self, seed: int, *, kinds=("raise",),
                 fire_window: tuple[int, int] = (1, 12),
                 seams: tuple[str, ...] | None = None,
                 delay_s: float = 0.0, heal_at: int | None = None):
        if not set(kinds) <= {"raise", "delay", "hang"}:
            raise ValueError(f"fault kinds {kinds!r}: the kinds are "
                             "'raise', 'delay' and 'hang'")
        rng = random.Random(seed)
        self.kind = rng.choice(list(kinds))
        self.fire_at = rng.randrange(*fire_window)
        self.heal_at = heal_at
        self.seams = seams
        self.delay_s = delay_s
        self.count = 0
        self.fired_on: str | None = None
        self.trace: list[str] = [
            f"[plan] seed={seed} kind={self.kind} fire_at={self.fire_at}"
            + (f" heal_at={heal_at}" if heal_at is not None else "")
        ]
        self._release = threading.Event()
        self._lock = threading.Lock()

    def weight(self, label: str) -> int:
        """The counts this crossing of ``label`` takes toward
        ``fire_at``: 1, or 0 outside ``seams``."""
        return int(self.seams is None or label.startswith(self.seams))

    def may_fire(self, label: str) -> bool:
        """Whether the plan may fire at this crossing of ``label``: not
        outside ``seams``."""
        return self.seams is None or label.startswith(self.seams)

    def at_seam(self, label: str) -> None:
        """Called by the injectors at every seam crossing."""
        w = self.weight(label)
        may = self.may_fire(label)
        with self._lock:
            if w <= 0 and not may:
                self.trace.append(f"[-] {label}")
                return
            i = self.count
            self.count += max(w, 0)
            if self.heal_at is None:
                fire = (may and self.count > self.fire_at
                        and self.fired_on is None)
            else:
                fire = may and self.fire_at <= i < self.heal_at
            if fire and self.fired_on is None:
                self.fired_on = label
            self.trace.append(
                f"[{i}] {label}" + (f" <- {self.kind}" if fire else "")
            )
        if not fire:
            return
        if self.kind == "raise":
            raise InjectedFault(f"injected raise at seam {i} ({label})")
        if self.kind == "hang":
            # Park like a dead follower's collective. The watchdog
            # orphans this thread; the bounded wait is the harness's own
            # leak guard, not part of the simulation.
            self._release.wait(timeout=120.0)
            raise InjectedFault(
                f"injected hang at seam {i} ({label}) released")
        time.sleep(self.delay_s)

    def close(self) -> None:
        """Release any parked seam (end-of-run cleanup)."""
        self._release.set()


class FaultyCache(PagedKVCache):
    """A paged cache whose device seams consult a :class:`FaultPlan`
    before executing — at a method's entry, before any replay or capture
    — with the genuine kernels running everywhere the plan stays quiet.
    The labels are the reference's: ``prefill[C]`` (a chunk of C
    tokens), ``step``, ``windowp[W]`` / ``wsamplep[W]`` (a window's
    dispatch, greedy / sampled), ``wharvest``, ``spec`` (a per-pass
    verify), ``specw[P]`` (a spec window's dispatch), ``specwharvest``,
    ``swapout`` and ``swapin``. A cache becomes one through :meth:`arm`
    only."""

    plan: FaultPlan | None = None

    @classmethod
    def arm(cls, cache: PagedKVCache, plan: FaultPlan | None) -> None:
        """Put ``plan`` on a live :class:`PagedKVCache` (one a runtime
        built) by turning it into a FaultyCache in place: its state,
        graphs and addresses are untouched."""
        cache.__class__ = cls
        cache.plan = plan

    def _seam(self, label: str) -> None:
        if self.plan is not None:
            self.plan.at_seam(label)

    def _device_prefill_chunk(self, params, slot: int, tokens, offset: int):
        self._seam(f"prefill[{tokens.shape[0]}]")
        return super()._device_prefill_chunk(params, slot, tokens, offset)

    def step(self, params, tokens, active=None):
        self._seam("step")
        return super().step(params, tokens, active)

    def step_spec(self, params, tokens, active, spec_mask):
        self._seam("spec")
        return super().step_spec(params, tokens, active, spec_mask)

    # Preemptive-swap seams: a swap-out dies with the victim's pages
    # still intact on the device (the poison path must not leak its
    # snapshot-to-be); a swap-in dies after the resume reservation was
    # re-booked (revive must return the pool to the idle fixpoint).
    def swapout_pages(self, ids):
        self._seam("swapout")
        return super().swapout_pages(ids)

    def swapin_pages(self, ids, arrays):
        self._seam("swapin")
        return super().swapin_pages(ids, arrays)

    # Overlapped-pipeline seams: dispatch and harvest are separate
    # failure boundaries — a dispatch can die while an earlier window is
    # still in flight, and a harvest can die on a window that was
    # dispatched healthy and may still be writing the pool.
    def _device_window_dispatch(self, params, tokens, n_steps: int, active,
                                caps, stop_tokens, sampling):
        self._seam(f"{'windowp' if sampling is None else 'wsamplep'}"
                   f"[{n_steps}]")
        return super()._device_window_dispatch(
            params, tokens, n_steps, active, caps, stop_tokens, sampling)

    def harvest_window(self, handle):
        self._seam("wharvest")
        return super().harvest_window(handle)

    def _device_spec_window(self, params, tokens, n_passes: int,
                            k_len: int, active, budgets, ctx, ctx_len,
                            sampling, caps):
        self._seam(f"specw[{n_passes}]")
        return super()._device_spec_window(
            params, tokens, n_passes, k_len, active, budgets, ctx,
            ctx_len, sampling, caps)

    def harvest_spec_window(self, handle):
        self._seam("specwharvest")
        return super().harvest_spec_window(handle)


class FaultySliceTransport:
    """Route a ``SlicePagedKVCache``'s broadcasts through a plan (the
    reference's injector): an instance-level patch of ``cache._bcast``,
    so the seam fires on the deadline runner's op thread, where a real
    broadcast to a lost follower would block. A ``"hang"`` plan is the
    dead-follower wedge: the watchdog orphans the op and raises
    ``SliceFollowerLost``."""

    def __init__(self, cache, plan: FaultPlan):
        self._cache = cache
        self._orig = cache._bcast
        self.plan = plan
        cache._bcast = self._bcast

    def _bcast(self, tree):
        self.plan.at_seam("bcast")
        return self._orig(tree)

    def heal(self) -> None:
        """Unhook: the cache's real transport again (a fire-once plan's
        "the follower is back"; ``heal_at`` plans heal by themselves)."""
        self._cache._bcast = self._orig


def prefix_file_intact(path: str) -> bool:
    """True iff ``path`` is absent or a complete, parseable prefix-cache
    dump — the never-torn invariant (dump writes tmp + os.replace, so a
    kill mid-write may strand a ``.tmp`` but never a torn ``path``)."""
    if not os.path.exists(path):
        return True
    try:
        with np.load(path) as data:
            json.loads(bytes(data["doc"]).decode())
            _ = data["pool_k"].shape, data["pool_v"].shape
    except Exception:
        return False
    return True


@dataclasses.dataclass
class _Submission:
    prompt: list[int]
    n_new: int
    streaming: bool
    tokens: list[int] | None = None
    error: Exception | None = None
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


@dataclasses.dataclass
class ServingFaultResult:
    requests: int
    completed: int
    failed: int
    kind: str
    fired_on: str | None
    degraded: str | None
    close_s: float
    trace: list[str]


class ServingFaultSchedule:
    """Drive seeded concurrent traffic into a server wearing a
    :class:`FaultPlan`, then enforce the recovery invariants.

    ``run()`` submits ``n_requests`` (prompts drawn from the seed, a
    seeded mix of blocking and streaming consumers), joins every
    waiter with a hard bound, closes the server, and checks:
    termination, typed errors only, no over-emission, lock health,
    bounded close, decode thread gone. Raises
    :class:`InvariantViolation` carrying the
    full seam trace on any breach.
    """

    # Errors a request is ALLOWED to terminate with. InjectedFault is
    # legal only on the submit path (a prefill seam raises into the
    # submitting thread before classification); the decode loop always
    # classifies, so waiters see ServingFailure subtypes.
    _TYPED = (ServingFailure,)

    def __init__(self, server, plan: FaultPlan, *, seed: int,
                 join_timeout_s: float = 60.0):
        from kvedge_torch.models.serving import (
            RequestCancelled,
            ServerBusy,
            ServerClosed,
        )

        self.server = server
        self.plan = plan
        self.rng = random.Random(seed)
        self.join_timeout_s = join_timeout_s
        self.trace = plan.trace
        self._allowed = self._TYPED + (
            ServerBusy, ServerClosed, RequestCancelled, InjectedFault,
        )

    # ---- schedule -------------------------------------------------------

    def run(self, n_requests: int = 3, n_new: int = 6, *,
            vocab: int = 64,
            prompt_len: tuple[int, int] = (2, 8)) -> ServingFaultResult:
        subs = [
            _Submission(
                prompt=[self.rng.randrange(1, vocab)
                        for _ in range(self.rng.randrange(*prompt_len))],
                n_new=n_new,
                streaming=self.rng.random() < 0.5,
            )
            for _ in range(n_requests)
        ]
        threads = []
        for i, sub in enumerate(subs):
            t = threading.Thread(
                target=self._drive, args=(sub,),
                name=f"fault-submit-{i}", daemon=True,
            )
            threads.append(t)
            self.trace.append(
                f"[submit {i}] len={len(sub.prompt)} n_new={sub.n_new} "
                f"{'stream' if sub.streaming else 'block'}"
            )
            t.start()

        for i, sub in enumerate(subs):
            if not sub.finished.wait(timeout=self.join_timeout_s):
                self.plan.close()  # free any parked seam before raising
                self._fail(
                    f"request {i} never terminated within "
                    f"{self.join_timeout_s:g}s — wedged waiter"
                )
        self._check_outcomes(subs)
        self._check_lock("after join")

        start = time.monotonic()
        self.server.close()
        close_s = time.monotonic() - start
        self.plan.close()
        if close_s > self.join_timeout_s:
            self._fail(f"close() took {close_s:.1f}s — unbounded teardown")
        if self.server._thread.is_alive():
            self.server._thread.join(timeout=10)
            if self.server._thread.is_alive():
                self._fail("decode thread still alive after close()")
        self._check_lock("after close")
        for t in threads:
            t.join(timeout=5)

        completed = sum(1 for s in subs if s.error is None)
        self.trace.append(
            f"[done] completed={completed} "
            f"failed={n_requests - completed} close={close_s:.2f}s"
        )
        return ServingFaultResult(
            requests=n_requests, completed=completed,
            failed=n_requests - completed, kind=self.plan.kind,
            fired_on=self.plan.fired_on, degraded=self.server.degraded,
            close_s=close_s, trace=self.trace,
        )

    def _drive(self, sub: _Submission) -> None:
        try:
            if sub.streaming:
                handle = self.server.submit_stream(
                    sub.prompt, sub.n_new, timeout=self.join_timeout_s
                )
                got = [tok for tok in handle]
                sub.tokens = sub.prompt + got
            else:
                sub.tokens = self.server.submit(
                    sub.prompt, sub.n_new, timeout=self.join_timeout_s
                )
        except Exception as e:
            sub.error = e
        finally:
            sub.finished.set()

    # ---- invariants -----------------------------------------------------

    def _fail(self, message: str) -> None:
        raise InvariantViolation(message, self.trace)

    def _check_outcomes(self, subs: list[_Submission]) -> None:
        for i, sub in enumerate(subs):
            if sub.error is not None:
                if not isinstance(sub.error, self._allowed):
                    self._fail(
                        f"request {i} died UNTYPED: "
                        f"{type(sub.error).__name__}: {sub.error}"
                    )
                self.trace.append(
                    f"[outcome {i}] {type(sub.error).__name__}"
                )
                continue
            want = len(sub.prompt) + sub.n_new
            if sub.tokens is None or len(sub.tokens) != want:
                got = None if sub.tokens is None else len(sub.tokens)
                self._fail(
                    f"request {i} over/under-emitted: {got} tokens, "
                    f"budget {want} — double emission or truncation"
                )
            self.trace.append(f"[outcome {i}] ok ({want} tokens)")

    def _check_lock(self, context: str) -> None:
        if not self.server._lock.acquire(timeout=10):
            self._fail(f"server lock orphaned ({context})")
        self.server._lock.release()
