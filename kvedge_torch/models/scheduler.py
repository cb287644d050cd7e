"""SLO-aware admission scheduling for the paged serving stack.

The port's copy of the JAX package's ``kvedge_tpu/models/scheduler.py``
(it imports only ``bisect``, ``threading`` and ``time``), unchanged but
for these pointers: the serving layer is ``kvedge_torch/models/
serving.py``, the swap is its ``PagedKVCache.swapout_pages``, and the
SERVING.md rungs named below are the JAX package's document. Its
``tracer`` is the server's flight recorder (``runtime/tracing.py``) or
None.

SERVING.md rung 17. The serving layer (models/serving.py) used to admit
through a bare ``Condition.notify_all`` wait: admission order was
whatever the lock handed out, a long batch job and a latency-critical
interactive request were indistinguishable, and the only overload
behavior was each caller burning its full timeout into ``ServerBusy``.
This module is the policy layer that turns the paged pool's existing
mechanisms (worst-case reservation, refcounted pages, boundary-only
mutation) into controlled behavior under contention. Three pillars:

* **Priority admission.** Every request carries a priority class
  (``interactive``/``batch`` by default — the class list is a
  constructor argument, so it is extensible) and an optional deadline.
  Waiters park on a per-class ticketed queue: each ticket gets its OWN
  condition variable on the server lock, and only the policy head is
  ever woken, so admission is FIFO within a class by construction —
  no thundering herd, no lock-convoy ordering races. Across classes
  the ``policy`` knob picks strict priority (head = best class with a
  waiter), weighted sharing (deficit-style weighted round-robin, so a
  flood of interactive work cannot starve batch forever), or plain
  global FIFO (the baseline the bench's overload leg compares
  against).

* **Preemptive KV swap.** When the head of the queue cannot admit and
  a strictly lower-class request holds a slot, the decode loop (at a
  non-overlapped window boundary — the only place cache state is
  quiescent) swaps the victim out: its live pages are snapshotted to
  host RAM AS STORED (``PagedKVCache.swapout_pages`` — verbatim pool
  bytes, including the int8 scale slabs, so restore is bit-identical),
  its slot and reservation are released, and a resume entry carrying
  its ORIGINAL ticket number re-enters the class queue. Resume re-runs
  admission (worst-case reservation first — the same invariant that
  makes normal admission safe makes swap-in safe), writes the bytes
  back, and the request continues from its saved length; the
  positional sampling-key schedule makes the resumed token stream
  bit-identical to a never-preempted run. Host memory for snapshots is
  bounded by ``swap_budget_mb``; 0 disables preemption entirely.

* **Overload shedding.** Queue-depth and measured-queue-wait
  watermarks reject at submit time with the measured ``retry_after``
  hint (an EWMA of recent per-class admission waits), instead of
  letting every caller burn its full timeout. A request whose own
  deadline is provably unmeetable (estimated wait exceeds
  ``deadline_ms``) is shed the same way. Two guards keep shedding
  honest: the depth watermark only counts tickets the policy would
  actually serve ahead of the arrival (a parked batch flood must not
  shed an interactive request it cannot delay), and the wait estimate
  ages toward zero between admissions — shed requests never enqueue,
  so without decay a transient spike would freeze the EWMA above the
  watermark and shed a class forever on an idle server.

The scheduler is pure policy + bookkeeping: it raises no serving
exceptions and touches no cache state. Every method that ends in
``_locked`` MUST be called with the server's work lock held — the
scheduler deliberately shares that one lock (SERVING.md invariant 5)
instead of adding its own, so queue state, slot state, and page
accounting mutate atomically together.

The reference has no serving at all (SURVEY.md §0); the scheduling
design follows vLLM's preempt-via-swap (Kwon et al., SOSP '23) and
Sarathi-Serve's SLO-aware admission (Agrawal et al., OSDI '24) adapted
to this repo's boundary-only, exactness-pinned serving loop.
"""

from __future__ import annotations

import bisect
import threading
import time

# Priority classes in RANK ORDER: index 0 is the most latency-critical.
# The serving layer passes this default; deployments with more tiers
# hand AdmissionScheduler a longer tuple.
DEFAULT_CLASSES = ("interactive", "batch")

# Queue-wait histogram buckets (milliseconds). Sub-ms admissions land
# in the first bucket; 120 s was the old cap (the default submit
# timeout) — the log-spaced tail past it keeps overload p99s
# measurable instead of clamped. Existing edges are unchanged so
# cumulative bucket deltas stay comparable across snapshots.
_WAIT_EDGES_MS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                  5000.0, 10000.0, 30000.0, 60000.0, 120000.0,
                  240000.0, 480000.0, 960000.0)

# EWMA smoothing for the measured per-class queue wait (the shed
# watermark and the retry_after hint): ~5 admissions of memory.
_EWMA_ALPHA = 0.2

# Prefix-affinity bypass bound (SERVING.md rung 24): at most this many
# consecutive hot (HBM-resident-prefix) admissions may jump past a
# head that does not fit before the head MUST admit next — bounded
# priority inversion, never starvation.
_BYPASS_CAP = 4


class _Hist:
    """Fixed-bucket histogram in Prometheus shape: ``edges`` are ``le``
    upper bounds, counts are stored PER bucket (last slot = +Inf) and
    cumulated at render time (runtime/status.py), so one observation
    touches one counter. Mutated only under the server lock; snapshots
    copy plain ints/floats."""

    __slots__ = ("edges", "counts", "total", "n")

    def __init__(self, edges: tuple):
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        # bisect_left: v == edge lands IN that edge's bucket (le means
        # "less than or equal", the Prometheus boundary convention).
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.total += v
        self.n += 1

    def snapshot(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self.total, "count": self.n}


class _Entry:
    """One queued admission unit.

    Either a parked ticket (a live submitter thread waiting on
    ``cond``) or a resume entry (a preempted request's swapped-out
    state, serviced by the decode loop at a boundary — no thread, no
    condition). ``no`` is the global arrival ticket: FIFO within a
    class orders by it, and a resume entry KEEPS the number it was
    first admitted under, so a preempted request re-enters ahead of
    everything that arrived after it.
    """

    __slots__ = ("no", "pclass", "req", "pages_needed", "cond",
                 "enqueued_at", "resume", "saved_len", "arrays",
                 "nbytes", "hot")

    def __init__(self, no: int, pclass: str, req, pages_needed: int,
                 cond, enqueued_at: float, *, resume: bool = False,
                 saved_len: int = 0, arrays: tuple = (),
                 nbytes: int = 0):
        self.no = no
        self.pclass = pclass
        self.req = req
        self.pages_needed = pages_needed
        self.cond = cond
        self.enqueued_at = enqueued_at
        self.resume = resume
        self.saved_len = saved_len
        self.arrays = arrays
        self.nbytes = nbytes
        # Prefix affinity (SERVING.md rung 24): the serving layer
        # refreshes this on each park-loop wake — True iff the
        # ticket's prompt currently matches an HBM-resident cached
        # prefix, making it cheaper to admit than its page count says.
        self.hot = False


class AdmissionScheduler:
    """Per-class ticketed admission queue + preemption bookkeeping.

    Owns WHO runs: queue order, the policy head, shed watermarks, the
    swapped-out set, and every scheduling counter/histogram exported
    through ``/metrics``. It does not own HOW anything runs — slot
    assignment, page reservation, and the actual swap device calls stay
    in the serving layer, which calls in under its own lock.
    """

    def __init__(self, lock, *, policy: str = "strict",
                 weights: dict | None = None,
                 classes: tuple = DEFAULT_CLASSES,
                 max_queue_depth: int = 0,
                 max_queue_wait_s: float = 0.0,
                 swap_budget_mb: int = 0,
                 tracer=None):
        if policy not in ("fifo", "strict", "weighted"):
            raise ValueError(
                f"scheduler policy must be 'fifo', 'strict' or "
                f"'weighted', got {policy!r}"
            )
        if not classes:
            raise ValueError("need at least one priority class")
        self._lock = lock
        self.policy = policy
        self.classes = tuple(classes)
        self._rank = {c: i for i, c in enumerate(self.classes)}
        self._weights = {c: 1.0 for c in self.classes}
        for c, w in (weights or {}).items():
            if c not in self._rank:
                raise ValueError(f"weight for unknown priority class "
                                 f"{c!r} (known: {self.classes})")
            if w <= 0:
                raise ValueError(f"priority weight for {c!r} must be "
                                 f"> 0, got {w}")
            self._weights[c] = float(w)
        self.max_queue_depth = int(max_queue_depth)
        self.max_queue_wait_s = float(max_queue_wait_s)
        self.swap_budget_bytes = int(swap_budget_mb) * (1 << 20)
        # Per-class queues of _Entry, kept sorted by ticket number
        # (resume entries re-enter with OLD numbers, so insertion is a
        # sorted insert, not an append).
        self._queues: dict[str, list] = {c: [] for c in self.classes}
        self._next_no = 0
        # Admission sequence: victim selection preempts the LATEST
        # admitted request of the lowest class (least progress lost).
        self._next_admit_seq = 0
        # Weighted policy state: admissions served per class; the head
        # is the nonempty class minimizing (served+1)/weight, which is
        # deterministic and stable between admissions.
        self._served = {c: 0 for c in self.classes}
        # Measured queue wait per class (seconds, EWMA) — the shed
        # watermark input and the retry_after hint — plus the time of
        # the class's last admission, which ages the estimate: shed
        # decisions happen BEFORE enqueue, so a shed request never
        # feeds a sample back, and an undecayed estimate would keep
        # shedding long after the overload passed.
        self._wait_ewma: dict[str, float | None] = {
            c: None for c in self.classes
        }
        self._last_admit = {c: time.monotonic() for c in self.classes}
        self._hist_wait = {c: _Hist(_WAIT_EDGES_MS)
                           for c in self.classes}
        # Swap residency (swap-out to resume) is observed separately:
        # folding it into the queue-wait histogram would inflate the
        # admission p99 operators read, while the EWMA deliberately
        # excludes it — the two consumers must measure the same thing.
        self._hist_swap = {c: _Hist(_WAIT_EDGES_MS)
                           for c in self.classes}
        # Request-scoped tracing (SERVING.md rung 18): an optional
        # runtime/tracing.py Tracer shared with the serving layer. All
        # emissions here run under the server lock and are one ring
        # append each — lock-cheap by the tracer's contract.
        self.tracer = tracer
        # Host bytes currently held by swap snapshots.
        self.swap_bytes = 0
        # Counters (cumulative; survive revive()).
        self.preemptions = 0
        self.resumes = 0
        self.shed = 0
        # Prefix-affinity bypass (rung 24): consecutive hot admissions
        # taken past a non-fitting head. Bounded (_BYPASS_CAP) so a
        # stream of cache-hitting arrivals cannot starve a cold head —
        # the streak resets every time the true head admits.
        self.hot_bypasses = 0
        self._bypass_streak = 0
        # Error-budget burn gate (SERVING.md rung 25, knob-gated via
        # [payload] serving_slo_shed): a () -> bool the serving layer
        # installs when the knob is on — True while the SLO engine's
        # multi-window burn-rate alert fires, at which point non-top
        # classes shed at the door (batch work is the error budget's
        # cheapest relief valve). None (the default) keeps every shed
        # path byte-for-byte the rung-17 one.
        self.burn_input = None

    # ---- ranks & small queries ------------------------------------------

    def rank(self, pclass: str) -> int:
        """Smaller = more latency-critical. Raises on unknown class."""
        try:
            return self._rank[pclass]
        except KeyError:
            raise ValueError(
                f"unknown priority class {pclass!r} "
                f"(known: {self.classes})"
            ) from None

    def next_admit_seq_locked(self) -> int:
        seq = self._next_admit_seq
        self._next_admit_seq += 1
        return seq

    def depth_locked(self, pclass: str | None = None) -> int:
        """Parked tickets (resume entries excluded — those hold no
        caller thread and are invisible to the shed watermark)."""
        qs = ([self._queues[pclass]] if pclass is not None
              else self._queues.values())
        return sum(1 for q in qs for e in q if not e.resume)

    def depths_locked(self) -> dict:
        return {c: self.depth_locked(c) for c in self.classes}

    def depth_text_locked(self) -> str:
        """Per-class queue depth for refusal messages: satellite 2 —
        a shed or busy caller learns WHAT it is queued behind."""
        return ", ".join(f"{c}={self.depth_locked(c)}"
                         for c in self.classes)

    def swapped_locked(self) -> list:
        return [e for q in self._queues.values() for e in q if e.resume]

    def resume_pending_locked(self) -> bool:
        return any(e.resume for q in self._queues.values() for e in q)

    @property
    def preemption_enabled(self) -> bool:
        """Preemption needs both a class ordering to act on (FIFO has
        none) and host memory to park victims in."""
        return self.policy != "fifo" and self.swap_budget_bytes > 0

    # ---- the policy head -------------------------------------------------

    def head_locked(self):
        """The ONE entry eligible to admit next, or None.

        * ``fifo``: global ticket order — the scheduler degenerates to
          a fair FIFO (still fixes the notify_all ordering race).
        * ``strict``: best-ranked class with a waiter, FIFO within.
        * ``weighted``: deficit-style weighted round-robin — the
          nonempty class minimizing (served+1)/weight, rank breaking
          ties — so every class with weight > 0 makes progress.

        Head-of-line is intentional: a later, smaller request never
        bypasses the head (bypass would starve large requests — the
        fairness bug this module exists to fix). Preemption, not
        bypass, is how a blocked high-class head gets capacity.
        """
        nonempty = [c for c in self.classes if self._queues[c]]
        if not nonempty:
            return None
        if self.policy == "fifo":
            return min((self._queues[c][0] for c in nonempty),
                       key=lambda e: e.no)
        if self.policy == "strict":
            return self._queues[nonempty[0]][0]
        best = min(nonempty,
                   key=lambda c: ((self._served[c] + 1)
                                  / self._weights[c], self._rank[c]))
        return self._queues[best][0]

    def bypass_ok_locked(self, entry: _Entry) -> bool:
        """Prefix-affinity exception to head-of-line (rung 24): may
        ``entry`` admit even though it is not the policy head?

        Yes iff it is the FIRST hot parked ticket of the HEAD's class
        (same class — cross-class bypass would reintroduce the priority
        inversion this module removed) and the bypass streak is under
        ``_BYPASS_CAP``. The serving layer additionally requires that
        the head itself does NOT fit — bypass fills capacity the head
        cannot use, it never delays a head that could run."""
        if entry.resume or not entry.hot:
            return False
        if self._bypass_streak >= _BYPASS_CAP:
            return False
        head = self.head_locked()
        if head is None or head is entry or head.pclass != entry.pclass:
            return False
        for e in self._queues[entry.pclass]:
            if e.resume or e is head:
                continue
            if e.hot:
                return e is entry
        return False

    # ---- overload shedding -----------------------------------------------

    def wait_estimate_locked(self, pclass: str) -> float | None:
        """Measured queue wait for ``pclass``, aged for staleness.

        Shed rejections happen BEFORE enqueue, so a shed request never
        admits and never feeds a sample back into the EWMA. Without
        decay, a transient overload that drains would freeze the
        estimate above the watermark and shed the class forever on an
        idle server (and spuriously fail the deadline check for
        requests that would admit instantly). Instead the raw EWMA is
        aged from the class's last admission: unchanged for one
        estimate-width of silence, then halving per estimate-width."""
        est = self._wait_ewma[pclass]
        if not est:
            return est
        age = time.monotonic() - self._last_admit[pclass]
        if age > est:
            est *= 0.5 ** (age / est - 1.0)
        return est

    def shed_depth_locked(self, pclass: str) -> int:
        """Parked tickets the depth watermark weighs against a
        ``pclass`` arrival. Under ``fifo`` every ticket is ahead of
        it; under ``strict``/``weighted`` parked work of strictly
        lower classes cannot hold it back (the policy serves the
        better rank first), so counting it would let a flood of parked
        batch requests shed an interactive arrival the policy would
        admit ahead of all of them — priority inversion in the
        shedding path."""
        if self.policy == "fifo":
            return self.depth_locked()
        r = self.rank(pclass)
        return sum(self.depth_locked(c) for c in self.classes
                   if self._rank[c] <= r)

    def shed_check_locked(self, pclass: str, deadline_ms: int | None,
                          rid: str = "") -> dict | None:
        """Reject-early decision BEFORE enqueue. Returns None (admit to
        the queue) or ``{"reason", "retry_after_s"}`` — the serving
        layer turns the latter into a typed refusal carrying the
        measured hint (satellite 2), so an overloaded server costs a
        client one RTT, not its full timeout."""
        est = self.wait_estimate_locked(pclass)
        depth = self.shed_depth_locked(pclass)
        if self.max_queue_depth and depth >= self.max_queue_depth:
            return self._note_shed(pclass, rid, est,
                                   f"admission queue is full "
                                   f"({depth} tickets ahead of class "
                                   f"{pclass!r} >= watermark "
                                   f"{self.max_queue_depth})")
        # Burn-rate gate (rung 25): while BOTH SLO burn windows run
        # hot, protect the interactive error budget by shedding every
        # lower class up front. The top class never burn-sheds — the
        # alert exists to keep ITS latency inside objective.
        if (self.burn_input is not None and self.rank(pclass) > 0
                and self.burn_input()):
            return self._note_shed(pclass, rid, est,
                                   f"error-budget burn-rate alert is "
                                   f"firing; class {pclass!r} sheds "
                                   f"until the budget recovers")
        # Wait-based sheds only apply while same-class work is parked:
        # with an empty class queue the arrival becomes the class head
        # immediately, and letting it park is the only way the wait
        # estimate ever gets a fresh sample (shed requests never
        # admit) — the second half of the anti-livelock guard.
        if self.depth_locked(pclass) == 0:
            return None
        if self.max_queue_wait_s and est is not None \
                and est > self.max_queue_wait_s:
            return self._note_shed(pclass, rid, est,
                                   f"measured {pclass} queue wait "
                                   f"{est:.2f}s exceeds watermark "
                                   f"{self.max_queue_wait_s:.2f}s")
        if deadline_ms is not None and est is not None \
                and est > deadline_ms / 1000.0:
            return self._note_shed(pclass, rid, est,
                                   f"deadline {deadline_ms}ms is "
                                   f"unmeetable (measured {pclass} "
                                   f"queue wait {est:.2f}s)")
        return None

    def _note_shed(self, pclass: str, rid: str, est, reason: str) -> dict:
        self.shed += 1
        tr = self.tracer
        if tr is not None:
            # Sheds always record (they are rare and diagnostic gold),
            # carrying the rid so a refused request's trace says why.
            tr.event("shed", "sched", rid=rid,
                     args={"class": pclass, "reason": reason})
        return {"reason": reason, "retry_after_s": est}

    # ---- ticket lifecycle ------------------------------------------------

    def enqueue_locked(self, req, pclass: str,
                       pages_needed: int) -> _Entry:
        """Park a submitter: a fresh ticket at the class tail. The
        caller waits on ``entry.cond`` until it is the head AND
        capacity fits (serving.py's admission loop)."""
        self.rank(pclass)  # validates
        e = _Entry(self._next_no, pclass, req, pages_needed,
                   threading.Condition(self._lock), time.monotonic())
        self._next_no += 1
        self._queues[pclass].append(e)  # fresh no == max -> tail
        tr = self.tracer
        if tr is not None and getattr(req, "trace", False):
            tr.event("enqueue", "sched", rid=getattr(req, "rid", ""),
                     args={"class": pclass, "ticket": e.no})
        return e

    def admit_locked(self, entry: _Entry) -> None:
        """The head ticket won capacity: dequeue, record its measured
        queue wait (histogram + EWMA — the shed/hint input), charge the
        weighted policy, and wake whoever is head now. A non-head
        admission is a prefix-affinity bypass (``bypass_ok_locked``):
        counted, and the streak advances so the cap can bite."""
        if self.head_locked() is entry:
            self._bypass_streak = 0
        else:
            self._bypass_streak += 1
            self.hot_bypasses += 1
        self._remove(entry)
        self._served[entry.pclass] += 1
        now = time.monotonic()
        wait = now - entry.enqueued_at
        self._hist_wait[entry.pclass].observe(wait * 1000.0)
        prev = self._wait_ewma[entry.pclass]
        self._wait_ewma[entry.pclass] = (
            wait if prev is None
            else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * wait
        )
        self._last_admit[entry.pclass] = now
        tr = self.tracer
        if tr is not None and getattr(entry.req, "trace", False):
            # The queue span: enqueue -> admit, anchored on the tracer
            # clock (the wait itself was measured on time.monotonic —
            # both clocks are monotonic, only the epoch differs).
            t1 = tr.now()
            tr.span("queue", "sched", t1 - wait, t1,
                    rid=getattr(entry.req, "rid", ""),
                    args={"class": entry.pclass, "ticket": entry.no,
                          "wait_ms": round(wait * 1000.0, 3)})
        self.wake_head_locked()

    def remove_locked(self, entry: _Entry) -> None:
        """Abandon a ticket (timeout, cancel, refusal). Idempotent."""
        self._remove(entry)
        self.wake_head_locked()

    def _remove(self, entry: _Entry) -> None:
        q = self._queues[entry.pclass]
        for i, e in enumerate(q):
            if e is entry:
                del q[i]
                return

    # ---- wakeups ---------------------------------------------------------

    def wake_head_locked(self) -> None:
        """Targeted wakeup: only the policy head's waiter stirs — the
        ticketed replacement for notify_all's thundering herd. Resume
        entries have no thread; the decode loop is woken by the serving
        layer's own ``notify_all`` on the work condition."""
        h = self.head_locked()
        if h is None:
            return
        if not h.resume:
            h.cond.notify_all()
        # Also stir the head class's first hot ticket (rung 24): its
        # park predicate may pass via bypass_ok_locked even while the
        # head's cannot. Bounded: one extra notify, same class only.
        if self._bypass_streak >= _BYPASS_CAP:
            return
        for e in self._queues[h.pclass]:
            if e.resume or e is h:
                continue
            if e.hot:
                e.cond.notify_all()
                return

    def wake_all_locked(self) -> None:
        """Every parked waiter re-evaluates (close/drain/poison/cancel:
        the predicate changed for reasons other than queue order)."""
        for q in self._queues.values():
            for e in q:
                if not e.resume:
                    e.cond.notify_all()

    # ---- preemptive swap bookkeeping ------------------------------------

    def swap_fits_locked(self, nbytes: int) -> bool:
        return (self.swap_budget_bytes > 0
                and self.swap_bytes + nbytes <= self.swap_budget_bytes)

    def record_swapout_locked(self, req, pclass: str, ticket_no: int,
                              pages_needed: int, saved_len: int,
                              arrays: tuple, *,
                              restore: bool = False) -> _Entry:
        """A victim left the device: park its as-stored page bytes and
        re-queue it under its ORIGINAL ticket number, so it resumes
        ahead of later arrivals of its class. ``restore`` marks a
        rung-22 journal re-queue (revive found more checkpoints than
        slots): same parking, but it is not a preemption — the counter
        and its trace event stay honest."""
        nbytes = sum(a.nbytes for a in arrays)
        e = _Entry(ticket_no, pclass, req, pages_needed, None,
                   time.monotonic(), resume=True, saved_len=saved_len,
                   arrays=arrays, nbytes=nbytes)
        bisect.insort(self._queues[pclass], e, key=lambda x: x.no)
        self.swap_bytes += nbytes
        if not restore:
            self.preemptions += 1
        tr = self.tracer
        if tr is not None:
            # Preemptions always record: they reshape every timeline on
            # the pool, not just the victim's.
            tr.event("journal-requeue" if restore else "swap-out",
                     "sched", rid=getattr(req, "rid", ""),
                     args={"class": pclass, "ticket": ticket_no,
                           "saved_len": saved_len, "bytes": nbytes})
        return e

    def pop_resume_locked(self, entry: _Entry) -> None:
        """The decode loop re-admitted a swapped request: drop the host
        snapshot accounting and charge the policy like any admission.
        The swapped-out residency (``enqueued_at`` was reset at
        swap-out) goes to its OWN histogram: it is not an admission
        wait, and the queue-wait histogram must keep measuring the same
        thing the EWMA does."""
        self._remove(entry)
        self.swap_bytes -= entry.nbytes
        entry.arrays = ()
        self._served[entry.pclass] += 1
        self.resumes += 1
        wait = time.monotonic() - entry.enqueued_at
        self._hist_swap[entry.pclass].observe(wait * 1000.0)
        tr = self.tracer
        if tr is not None:
            tr.event("swap-in", "sched",
                     rid=getattr(entry.req, "rid", ""),
                     args={"class": entry.pclass, "ticket": entry.no,
                           "residency_ms": round(wait * 1000.0, 3)})
        self.wake_head_locked()

    def drop_swapped_locked(self, req) -> _Entry | None:
        """Cancel-while-swapped-out (satellite 3): free the host
        snapshot and forget the entry. Returns it (the serving layer
        fails the waiter) or None if ``req`` is not swapped out."""
        for q in self._queues.values():
            for i, e in enumerate(q):
                if e.resume and e.req is req:
                    del q[i]
                    self.swap_bytes -= e.nbytes
                    e.arrays = ()
                    self.wake_head_locked()
                    return e
        return None

    def take_swapped_locked(self) -> list:
        """Remove and return EVERY resume entry (degraded mode / hard
        close: swapped-out requests fail like active ones — rung 14's
        contract extends to the swap set). The snapshots ride along
        INTACT: the caller either journals them (rung 22 — the host
        bytes are already a verbatim checkpoint) or zeroes
        ``entry.arrays`` to free them."""
        out = []
        for c, q in self._queues.items():
            keep = []
            for e in q:
                if e.resume:
                    self.swap_bytes -= e.nbytes
                    out.append(e)
                else:
                    keep.append(e)
            self._queues[c] = keep
        return out

    def reset_locked(self) -> None:
        """Revive/reform: queues and the swap set restart empty (any
        straggler tickets were woken into the refusal path; snapshots
        were failed by take_swapped_locked). Cumulative counters and
        histograms survive — they are observability, not state."""
        for c in self._queues:
            self._queues[c] = []
        self.swap_bytes = 0

    # ---- observability ---------------------------------------------------

    def stats_locked(self) -> dict:
        out = {
            "sched_policy": self.policy,
            "sched_swapped_out": len(self.swapped_locked()),
            "sched_swap_bytes_host": self.swap_bytes,
            "sched_preemptions_total": self.preemptions,
            "sched_resumes_total": self.resumes,
            "sched_shed_total": self.shed,
            "sched_hot_bypass_total": self.hot_bypasses,
        }
        for c in self.classes:
            out[f"sched_queue_depth_{c}"] = self.depth_locked(c)
            out[f"sched_queue_wait_ms_{c}"] = (
                self._hist_wait[c].snapshot()
            )
            out[f"sched_swap_residency_ms_{c}"] = (
                self._hist_swap[c].snapshot()
            )
        return out
