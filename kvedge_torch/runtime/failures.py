"""Typed failure taxonomy + deadline-bounded device ops for serving.

The port's copy of the JAX package's ``kvedge_tpu/runtime/failures.py``
(it imports only ``queue``, ``threading``, ``dataclasses`` and
``typing``), unchanged below this docstring. Its pointers read for the
port: the serving layer is ``kvedge_torch/models/serving.py``, the
recovery half ``kvedge_torch/runtime/recovery.py``, the fault harness
``kvedge_torch/testing/servingfaults.py``, and the HTTP layer
``kvedge_torch/runtime/serve.py``. "XLA compilation" in the comments
below is, on the card, the first capture of a CUDA graph. The
multi-process slice (``runtime/sliceserve.py``) runs every leader op
through :class:`DeadlineRunner` with :class:`SliceFollowerLost` as its
failure; the single-host path does not use it, as in the reference.

The serving stack's failure story used to stop at "slice-fatal, by
policy": a follower wedged in a collective left the leader blocked
forever, holding the server's work lock, and close() documented the
hang rather than preventing it. This module is the DETECTION half of
the recovery contract — the RECOVERY half lives in runtime/recovery.py,
whose supervisor turns the degraded mode these types produce into slice
reformation and warm restart, escalating to the terminal/reschedule
path only when healing keeps failing:

* a small exception hierarchy every layer agrees on — what failed,
  whether a client should retry, and how soon;
* :class:`OpBudgets`, per-op deadlines that are *compile-aware*: the
  first execution of a given device program shape pays compilation, so
  it gets the compile budget; steady-state repeats of the same shape
  get the much tighter steady budget;
* :class:`DeadlineRunner`, a single-thread op pump that runs each
  device op with its budget. A collective blocked on a dead follower
  cannot be cancelled — the runner instead *orphans* it (the worker
  thread stays parked on the wedged op) and raises a typed error in
  the caller, so the serving thread gets its lock back and the server
  degrades instead of deadlocking. Once one op times out the stream is
  dead: every later op refuses immediately with the same typed error.

The taxonomy is the contract the serving layer threads through: it
poisons in-flight requests with these types, the HTTP layer maps
``retryable`` onto 503-with-retry-hint vs 500, and the fault-injection
harness asserts requests terminate in exactly these types.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Hashable

# Client guidance carried by retryable failures: how long a refused
# client should wait before retrying — roughly the reschedule window
# (or an in-process recovery, which is much faster). The operator knob
# is ``[payload] serving_retry_after_s`` (RuntimeConfig), threaded into
# PagedGenerationServer; when the recovery supervisor is active the
# hint is the MEASURED recovery time instead. This constant is only
# the last-resort default for failures raised outside that wiring.
DEFAULT_RETRY_AFTER_S = 30.0


class ServingFailure(RuntimeError):
    """Base of the serving failure taxonomy.

    ``retryable`` is the client-facing split: True means the request
    was refused or killed by a condition a *replacement* process will
    not have (retry against the rescheduled pod); False means the
    request itself cannot succeed. ``retry_after_s`` is the hint the
    HTTP layer surfaces for retryable failures.
    """

    retryable: bool = False
    retry_after_s: float | None = None


class DeviceOpTimeout(ServingFailure):
    """A deadline-bounded device op exceeded its budget.

    Terminal for the op stream that raised it: the wedged op cannot be
    cancelled, so the stream refuses all later ops with this same type.
    """

    retryable = False

    def __init__(self, message: str, *, op: Hashable | None = None,
                 budget_s: float | None = None, compiling: bool = False):
        super().__init__(message)
        self.op = op
        self.budget_s = budget_s
        self.compiling = compiling


class SliceFollowerLost(DeviceOpTimeout):
    """A slice op (header send / broadcast / exec) blew its deadline —
    a follower is dead or wedged. The leader's op stream is unusable
    from this point; recovery is slice reformation (a fresh op stream
    + barrier SYNC the rejoined follower replays — sliceserve.reform,
    driven by runtime/recovery.py), falling back to rescheduling the
    slice when reformation keeps failing."""


class PoolPoisoned(ServingFailure):
    """The serving pool's decode loop died; in-flight requests were
    poisoned and new submits are refused. Retryable — against the
    replacement pod, after the reschedule window."""

    retryable = True

    def __init__(self, message: str,
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class PageAccountingError(ServingFailure):
    """The page-conservation audit (``serving_debug_pages`` /
    testing/chaos.py invariant 1) found the pool's books broken at a
    quiescent boundary: free + live != pages_total, a negative
    refcount, or a page both free and referenced. NOT retryable — a
    leaked or double-freed page is a host-side bookkeeping bug, and a
    replacement process running the same code will leak the same way;
    the failure exists to be loud, not survivable."""

    retryable = False


def classify_failure(exc: BaseException) -> ServingFailure:
    """The typed error a failed decode loop hands its waiters.

    Already-typed failures pass through (a ``SliceFollowerLost`` tells
    the client more than a generic wrapper would); anything else is a
    ``PoolPoisoned`` chained to the cause so post-mortems keep the
    original traceback.
    """
    if isinstance(exc, ServingFailure):
        return exc
    wrapped = PoolPoisoned(f"serving pool poisoned by {type(exc).__name__}: "
                           f"{exc}")
    wrapped.__cause__ = exc
    return wrapped


@dataclass
class OpBudgets:
    """Compile-aware per-op deadlines.

    ``budget(key)`` returns ``(seconds, first_time)``. The first call
    for a given key — an op label including every shape-affecting
    parameter, e.g. ``("prefill", chunk_len)`` — gets ``compile_s``
    (XLA compiles the program on first execution); repeats get
    ``steady_s``. Defaults are deliberately generous: a false timeout
    poisons a healthy pool, while a true one merely trims minutes off
    an already-lost slice.
    """

    steady_s: float = 120.0
    compile_s: float = 900.0
    _seen: set = field(default_factory=set, repr=False)

    def budget(self, key: Hashable) -> tuple[float, bool]:
        first = key not in self._seen
        self._seen.add(key)
        return (self.compile_s if first else self.steady_s), first


class DeadlineRunner:
    """Run device ops on one dedicated thread, each bounded by a budget.

    Single-threaded by design: the slice protocol's soundness rests on
    a totally-ordered op stream, and one worker preserves submission
    order even though callers already serialize on the server lock.

    On timeout the worker is *orphaned* mid-op (a blocked collective
    has no cancellation path), ``dead`` latches to the failed op's
    label, and the configured failure type is raised; every subsequent
    ``run()`` refuses with the same type without touching the device.
    The orphaned thread is a daemon — it never blocks interpreter exit.
    """

    # NOT concurrent.futures: its workers are non-daemon and joined by
    # an atexit hook, so an orphaned (wedged) worker would hang
    # interpreter shutdown — the exact failure mode this runner exists
    # to remove. A plain daemon thread + queue has no such hook.

    _STOP = object()

    def __init__(self, budgets: OpBudgets | None = None, *,
                 failure: type[DeviceOpTimeout] = DeviceOpTimeout,
                 name: str = "kvedge-device-ops"):
        self._budgets = budgets or OpBudgets()
        self._failure = failure
        self._name = name
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.dead: str | None = None  # label of the op that wedged
        # Optional flight recorder (runtime/tracing.py), shared by the
        # serving layer: a timeout lands as an instant in the same
        # timeline the post-mortem embeds, so the op that killed the
        # stream is visible next to the spans it stranded.
        self.tracer = None

    @property
    def steady_s(self) -> float:
        return self._budgets.steady_s

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name=self._name, daemon=True,
                )
                self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is self._STOP:
                return
            fn, box, done = item
            try:
                box["result"] = fn()
            except BaseException as e:  # hand every outcome to the caller
                box["error"] = e
            done.set()

    def _refusal(self, detail: str, *, op=None, budget_s=None,
                 compiling=False) -> DeviceOpTimeout:
        return self._failure(detail, op=op, budget_s=budget_s,
                             compiling=compiling)

    def run(self, key: Hashable, fn: Callable,
            budget_s: float | None = None):
        """``fn()`` on the op thread, bounded by ``key``'s budget (or
        an explicit ``budget_s`` for ops that never compile, e.g. a
        bare STOP header)."""
        if self.dead is not None:
            raise self._refusal(
                f"device-op stream is dead (op {self.dead} timed out "
                f"earlier); refusing {key}", op=key,
            )
        if budget_s is None:
            budget_s, first = self._budgets.budget(key)
        else:
            first = False
        self._ensure_worker()
        box: dict = {}
        done = threading.Event()
        self._queue.put((fn, box, done))
        if not done.wait(timeout=budget_s):
            self.dead = str(key)
            if self.tracer is not None:
                self.tracer.event(
                    "op-timeout", "failure",
                    args={"op": str(key), "budget_s": budget_s,
                          "compiling": first},
                )
            raise self._refusal(
                f"device op {key} exceeded its "
                f"{'compile' if first else 'steady'} budget of "
                f"{budget_s:g}s — follower dead or wedged; op stream "
                f"is now poisoned", op=key, budget_s=budget_s,
                compiling=first,
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def shutdown(self) -> None:
        """Release the worker if it is idle; a wedged worker stays
        orphaned (the STOP sentinel queues behind the wedged op and is
        simply never consumed — the thread is a daemon)."""
        self._queue.put(self._STOP)
