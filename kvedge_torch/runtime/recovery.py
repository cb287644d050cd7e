"""The recovery half of the serving failure contract: heal in process.

The port's copy of the JAX package's ``kvedge_tpu/runtime/recovery.py``
with one change: step 4's params re-restore copies the checkpoint's
weights INTO the server's tensors (``PagedGenerationServer.load_params``)
instead of rebinding them, because every captured CUDA graph holds the
addresses of the tensors it was captured with. Recovery instants land
in the server's flight recorder (``server.tracer``) when tracing is on.
Step 2 runs for a multi-process slice's cache
(``runtime/sliceserve.SlicePagedKVCache.reform``); the single-host cache
has no ``reform``, so it is skipped there, as in the reference. A
slice's warm restart keeps its params (the serve wiring passes no
``restore_params``), as the reference's does.

runtime/failures.py is the *detection* half — typed taxonomy, a pool
that poisons instead of deadlocking. This module closes the loop with a
supervisor that owns an explicit state machine for the serving pool:

    healthy -> degraded -> recovering -> healthy
                              |
                              +-------> terminal (escalate: reschedule)

On a poisoning failure the supervisor, on its own worker thread:

1. **tears down** the dead decode loop — joins the exited thread;
2. **reforms the slice** (slice caches only): a fresh op stream and a
   deadline-bounded barrier SYNC the rejoined followers replay;
3. **warm-restarts** the pool: :meth:`PagedGenerationServer.revive`
   waits for the device, clears the poison and restarts the decode loop
   over a scrubbed pool with its journaled requests re-admitted, then
   the emergency prefix-cache dump reloads and the params re-restore
   from the latest checkpoint — captured graphs survive throughout, so
   no capture is paid again;
4. **retries with exponential backoff + jitter** under an attempt
   budget, and consults the state directory's ``init-events.jsonl``
   history as a **crash-loop breaker**: a volume that already witnessed
   repeated failed recoveries or supervisor give-ups escalates straight
   to the terminal 503 path instead of thrashing.

While recovering, /healthz stays 503 but NON-terminal
(``runtime/serve.py``), with a retry-after hint derived from the
measured recovery time. A device left unusable (a sticky CUDA error)
fails every attempt at its first device call and escalates: terminal
503, reschedule.

Every recovery outcome is appended to ``init-events.jsonl`` so the
breaker's memory survives pod generations.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass

from kvedge_torch.runtime import heartbeat

# State-machine states (plain strings: they travel through stats()/JSON).
HEALTHY = "healthy"
DEGRADED = "degraded"
RECOVERING = "recovering"
TERMINAL = "terminal"

# init-events.jsonl event names that count as crash-loop strikes: the
# native supervisor's give-up, plus this module's own failed outcomes.
_STRIKE_EVENTS = ("give-up",)


class RecoveryError(RuntimeError):
    """One recovery attempt failed (teardown/reform/revive stage)."""


@dataclass
class RecoveryPolicy:
    """Knobs for the supervisor's retry discipline.

    Defaults suit production (seconds-scale backoff against a slice
    whose follower pod needs time to restart); tests shrink everything.
    ``barrier_budget_s = None`` lets the reformation barrier use the op
    stream's own steady budget.
    """

    max_attempts: int = 3
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 30.0
    jitter: float = 0.25           # +/- fraction of the delay
    barrier_budget_s: float | None = None
    teardown_budget_s: float = 60.0
    # Crash-loop breaker: this many strikes (supervisor give-ups or
    # failed/escalated recoveries) within the recent init-events window
    # veto in-process recovery — the volume's history says this pod
    # lineage is thrashing, so escalate to the reschedule path at once.
    crash_loop_window: int = heartbeat.INIT_EVENTS_TAIL
    crash_loop_threshold: int = 3


def sweep_stranded_tmp(state_dir: str) -> list[str]:
    """Remove stranded ``*.tmp`` files from the state dir (boot time).

    Every atomic write in the state dir (prefix-cache dumps, heartbeat
    and failure records) stages through ``<name>.tmp`` + ``os.replace``;
    a SIGKILL mid-dump strands the tmp file — a multi-hundred-MB corpse
    for a prefix dump — and nothing cleaned it up. At boot no other
    writer exists yet, so every surviving tmp is garbage by definition.
    Returns the removed names (top level only; best-effort)."""
    if not state_dir or not os.path.isdir(state_dir):
        return []
    removed = []
    for name in sorted(os.listdir(state_dir)):
        if not name.endswith(".tmp"):
            continue
        path = os.path.join(state_dir, name)
        if not os.path.isfile(path):
            continue
        try:
            os.remove(path)
        except OSError:
            continue
        removed.append(name)
    return removed


class RecoverySupervisor:
    """Watches one :class:`PagedGenerationServer` and heals it in place.

    ``attach()`` chains onto the server's ``on_degraded`` observer (the
    existing failure-record writer keeps running first) and installs the
    measured retry-after hint; from then on every poisoning failure
    starts a recovery worker instead of ending the story at terminal.

    The server and its cache are driven through their public recovery
    seams — ``cache.reform()`` (slice) and ``server.revive()`` — so the
    supervisor holds no serving state of its own beyond the machine.
    """

    def __init__(self, server, *, policy: RecoveryPolicy | None = None,
                 state_dir: str = "", seed: int | None = None,
                 prefix_path: str = "", prefix_fingerprint: str = "",
                 restore_params=None):
        self.server = server
        self.policy = policy or RecoveryPolicy()
        self.state_dir = state_dir
        self.prefix_path = prefix_path
        self.prefix_fingerprint = prefix_fingerprint
        # Optional () -> params: re-restore from the latest checkpoint
        # during warm restart (workload wires StateCheckpointer via
        # _restore_latest_params; single-host only — a slice restore is
        # a collective the supervisor thread must not run alone).
        self.restore_params = restore_params
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.state = HEALTHY
        self._attempts_total = 0
        self._recoveries = 0
        self._failures = 0
        self._last_recovery_s: float | None = None
        self._recovering_since: float | None = None
        self._worker: threading.Thread | None = None
        self._stopped = threading.Event()
        # Set whenever the machine is at rest (healthy or terminal) —
        # what tests and drain paths wait on.
        self._settled = threading.Event()
        self._settled.set()

    # ---- wiring ----------------------------------------------------------

    def attach(self) -> "RecoverySupervisor":
        """Chain onto the server's degraded observer + retry-after hint."""
        prev = self.server.on_degraded

        def observer(reason, failure):
            if prev is not None:
                try:
                    prev(reason, failure)
                except Exception as e:
                    print(f"[kvedge-recover] chained on_degraded "
                          f"observer failed: {e!r}", flush=True)
            self._on_degraded(reason, failure)

        self.server.on_degraded = observer
        self.server.retry_after_hint = self.retry_after_hint
        return self

    def stop(self) -> None:
        """Abandon recovery (server shutdown): in-flight attempts abort
        at the next stage boundary and no new ones start."""
        self._stopped.set()
        self._settled.set()

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict:
        out = {
            "recovering": 1 if self.state == RECOVERING else 0,
            "recovery_state": self.state,
            "recovery_attempts_total": self._attempts_total,
            "recoveries_total": self._recoveries,
            "recovery_failures_total": self._failures,
        }
        if self._last_recovery_s is not None:
            out["last_recovery_s"] = round(self._last_recovery_s, 3)
        return out

    def health(self) -> dict:
        """The /healthz enrichment while not healthy (boot.py merges
        it): ``terminal`` only after escalation; while recovering the
        body says so and carries the measured retry-after hint."""
        doc = {"state": self.state, "terminal": self.state == TERMINAL}
        hint = self.retry_after_hint()
        if hint is not None:
            doc["retry_after_s"] = hint
        return doc

    def retry_after_hint(self) -> float | None:
        """Measured recovery time as the client's wait estimate, while
        a recovery is actually running: the last successful recovery's
        duration minus what this one has already spent (floored to 1 s).
        None otherwise — the server then falls back to its configured
        static hint (serving_retry_after_s)."""
        if self.state != RECOVERING:
            return None
        last = self._last_recovery_s
        if last is None:
            return None
        since = self._recovering_since
        elapsed = 0.0 if since is None else time.monotonic() - since
        return round(max(1.0, last - elapsed), 1)

    def wait_settled(self, timeout: float | None = None) -> str:
        """Block until the machine is at rest; returns the state."""
        self._settled.wait(timeout=timeout)
        return self.state

    # ---- crash-loop breaker ----------------------------------------------

    def _crash_loop_reason(self) -> str | None:
        """Non-None when the volume's history vetoes in-process
        recovery: count supervisor give-ups and failed/escalated
        recoveries in the recent init-events window."""
        if not self.state_dir:
            return None
        events = heartbeat.read_init_events(
            self.state_dir, tail=self.policy.crash_loop_window
        )
        strikes = sum(1 for e in events if self._is_strike(e))
        if strikes >= self.policy.crash_loop_threshold:
            boot = (heartbeat.read_heartbeat(self.state_dir)
                    or {}).get("boot_count", 0)
            return (f"{strikes} crash-loop strikes in the last "
                    f"{len(events)} init events (boot_count {boot}) — "
                    f"this lineage is thrashing")
        return None

    @staticmethod
    def _is_strike(event: dict) -> bool:
        if not isinstance(event, dict):
            return False
        name = event.get("event")
        if name in _STRIKE_EVENTS:
            return True
        return (name == "serve-recovery"
                and event.get("outcome") in ("failed", "escalated"))

    def _trace_event(self, name: str, detail: str = "") -> None:
        """Land a recovery instant in the server's flight recorder
        (runtime/tracing.py) so heal attempts and outcomes sit in the
        same timeline as the failure that started them."""
        tr = getattr(self.server, "tracer", None)
        if tr is not None:
            tr.event(name, "recovery",
                     args={"detail": detail[:160]} if detail else None)

    def _record(self, outcome: str, detail: str = "") -> None:
        """Append one recovery event to init-events.jsonl (best-effort;
        the breaker's cross-generation memory)."""
        self._trace_event(f"recovery-{outcome}", detail)
        if not self.state_dir:
            return
        doc = {"event": "serve-recovery", "outcome": outcome}
        if detail:
            doc["detail"] = detail
        try:
            heartbeat.append_init_event(self.state_dir, doc)
        except OSError as e:
            print(f"[kvedge-recover] init-event append failed: {e!r}",
                  flush=True)

    # ---- the state machine -----------------------------------------------

    def _on_degraded(self, reason, failure) -> None:
        """Runs on the dying decode thread (after _degrade), or on the
        submit thread for a submit-path poisoning — must not block:
        decide, then hand off to a worker thread."""
        with self._lock:
            if self.state in (RECOVERING, TERMINAL):
                return
            self.state = DEGRADED
            self._settled.clear()
            if self._stopped.is_set():
                self._escalate("supervisor stopped")
                return
            veto = self._crash_loop_reason()
            if veto is not None:
                print(f"[kvedge-recover] crash-loop breaker tripped: "
                      f"{veto}; escalating to terminal", flush=True)
                self._escalate(veto)
                return
            self.state = RECOVERING
            self._recovering_since = time.monotonic()
            self._trace_event("recovery-start", str(reason))
            self._worker = threading.Thread(
                target=self._recover, args=(reason,),
                name="kvedge-recover", daemon=True,
            )
            self._worker.start()

    def _escalate(self, detail: str) -> None:
        """Give up on in-process recovery: the pool stays poisoned, the
        terminal 503 path takes over (lock held or single-threaded)."""
        self.state = TERMINAL
        self._failures += 1
        self._record("escalated", detail)
        self._settled.set()

    def _backoff(self, attempt: int) -> float:
        base = min(self.policy.backoff_cap_s,
                   self.policy.backoff_base_s * (2 ** (attempt - 1)))
        return base * (1.0 + self.policy.jitter
                       * (2.0 * self._rng.random() - 1.0))

    def _recover(self, reason) -> None:
        start = time.monotonic()
        for attempt in range(1, self.policy.max_attempts + 1):
            if self._stopped.is_set():
                with self._lock:
                    self._escalate("supervisor stopped mid-recovery")
                return
            self._attempts_total += 1
            try:
                restored = self._attempt_once()
            except Exception as e:
                print(f"[kvedge-recover] attempt {attempt}/"
                      f"{self.policy.max_attempts} failed: {e!r}",
                      flush=True)
                self._record("failed",
                             f"attempt {attempt}: {type(e).__name__}")
                if attempt < self.policy.max_attempts:
                    time.sleep(self._backoff(attempt))
                continue
            took = time.monotonic() - start
            with self._lock:
                self._last_recovery_s = took
                self._recovering_since = None
                self._recoveries += 1
                self.state = HEALTHY
                self._settled.set()
            self._record("healed",
                         f"attempt {attempt} in {took:.2f}s, "
                         f"{restored} in-flight restored "
                         f"(was: {reason})")
            print(f"[kvedge-recover] pool healed in {took:.2f}s "
                  f"(attempt {attempt}; was: {reason})", flush=True)
            return
        with self._lock:
            self._escalate(
                f"{self.policy.max_attempts} recovery attempts "
                f"exhausted (was: {reason})"
            )
        print(f"[kvedge-recover] recovery exhausted after "
              f"{self.policy.max_attempts} attempts; pool is terminal "
              f"(was: {reason})", flush=True)

    def _attempt_once(self) -> int:
        """One teardown -> reform -> revive -> warm-restart pass. Any
        exception fails the attempt (the pool stays poisoned and the
        next attempt — or escalation — takes over). Returns the count
        of journaled in-flight requests revive() restored (rung 22)."""
        server = self.server
        # 1. Teardown: the decode loop exits on poison; wait for it so
        # revive() can install a fresh one. A loop still wedged past
        # the budget means the failure is NOT the deadline-bounded kind
        # this supervisor can heal (e.g. a single-host device hang
        # outside the watchdog) — fail the attempt.
        thread = server._thread
        thread.join(timeout=self.policy.teardown_budget_s)
        if thread.is_alive():
            raise RecoveryError(
                "decode thread still running after "
                f"{self.policy.teardown_budget_s:g}s — cannot revive"
            )
        # 2. Slice reformation (slice caches only): fresh DeadlineRunner
        # + barrier SYNC with a deadline. Raises SliceFollowerLost if
        # the followers are still gone — the attempt fails and backoff
        # buys the follower pod time to restart and rejoin.
        reform = getattr(server._cache, "reform", None)
        if reform is not None:
            reform(budget_s=self.policy.barrier_budget_s)
        if self._stopped.is_set():
            raise RecoveryError("supervisor stopped before revive")
        # 3. Warm restart: scrub + restart the pool in place (compiled
        # programs survive — this is the whole point vs rescheduling).
        # revive() also re-admits every journaled in-flight request
        # (rung 22 checkpoints) — the count rides into the healed
        # record so a post-mortem shows how many requests survived.
        restored = int(server.revive() or 0)
        # 4. Reload state: params from the latest checkpoint (best-
        # effort — the on-device params are intact unless the failure
        # corrupted them, and a missing checkpoint must not fail an
        # otherwise-good recovery) ...
        if self.restore_params is not None:
            try:
                params = self.restore_params()
                if params is not None:
                    # In place: every captured graph holds the addresses
                    # of the tensors it was captured with.
                    server.load_params(params)
            except Exception as e:
                print(f"[kvedge-recover] checkpoint re-restore skipped "
                      f"({e!r}); serving with in-memory params",
                      flush=True)
        # ... and the emergency prefix dump _degrade() wrote on the way
        # down (single-host only; the revive scrubbed every pin).
        if self.prefix_path:
            try:
                n = server.load_prefix_cache(
                    self.prefix_path, self.prefix_fingerprint
                )
                if n:
                    print(f"[kvedge-recover] re-pinned {n} prefix "
                          f"entries from the emergency dump", flush=True)
            except Exception as e:
                print(f"[kvedge-recover] prefix reload skipped "
                      f"({e!r})", flush=True)
        return restored
