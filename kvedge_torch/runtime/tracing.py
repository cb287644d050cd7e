"""Request-scoped tracing: request ids, a bounded flight recorder, and
its Chrome / Perfetto export.

The port's copy of the JAX package's ``kvedge_tpu/runtime/tracing.py``
(it imports only ``collections``, ``time``, ``uuid`` and ``zlib``),
unchanged below this docstring. Its pointers read for the port: the
serving layer is ``kvedge_torch/models/serving.py`` (spans under the
server lock, one ``deque.append`` each), the HTTP surface is
``kvedge_torch/runtime/status.py`` (``GET /trace`` returns
:meth:`Tracer.export_chrome`), and the serve payload
(``kvedge_torch/runtime/serve.py``) mints request ids at ingress and
embeds :meth:`Tracer.last_events` in ``<state_dir>/last-failure.json``
at a poison.

* **Lock-cheap and bounded**: a record is one append of a plain tuple
  onto a fixed-size ring; the newest ``capacity`` events win and
  ``dropped`` counts the rest.
* **Monotonic clocks**: every stamp is ``time.perf_counter()``; the
  export rebases on the tracer's epoch.
* **Deterministic sampling**: ``serving_trace`` is off, on or a rate in
  (0, 1]; the decision is a hash of the request id, made once at
  submit, so every span of a request shares its fate. Global spans
  (windows, boundaries, failure and recovery events) record whenever
  the tracer is on.
* **Zero effect on tokens**: the tracer touches no device state and
  survives ``revive()`` unchanged.
"""

from __future__ import annotations

import collections
import time
import uuid
import zlib

# Record layout (plain tuple — cheap to build under the work lock):
#   (ph, t0, dur, name, cat, rid, args)
# ph is "X" (complete span, dur in seconds) or "i" (instant, dur 0.0).
# rid is "" for global events; args is a small JSON-safe dict or None.

# Flight-recorder tail embedded in the last-failure.json post-mortem.
POSTMORTEM_EVENTS = 64

# Request-id hygiene: caller-supplied X-Request-Id values ride into
# logs, JSON and trace exports; cap length and restrict the alphabet so
# a hostile header cannot smuggle structure anywhere downstream.
_RID_MAX_LEN = 64
_RID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:"
)


def new_request_id() -> str:
    """Mint a request ID at HTTP ingress (workload.py). Random, not
    sequential: IDs must not collide across pods behind one
    LoadBalancer, and must not leak request volume."""
    return "req-" + uuid.uuid4().hex[:16]


def clean_request_id(raw) -> str:
    """A caller-supplied request ID, sanitized; "" when unusable."""
    if not isinstance(raw, str) or not raw:
        return ""
    rid = raw[:_RID_MAX_LEN]
    if all(c in _RID_OK for c in rid):
        return rid
    return ""


class Tracer:
    """A lock-cheap, bounded span recorder (the flight recorder).

    One instance per serving pool, shared by reference with the
    scheduler, the cache (slice op stream) and the recovery machinery.
    All methods are safe to call from any thread without additional
    locking: the only mutation is an append on a bounded deque (atomic
    under the GIL) and a few monotonically-increasing counters whose
    races are benign (observability, not accounting).
    """

    def __init__(self, sample: float = 1.0, capacity: int = 4096):
        self.sample = float(sample)
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._appended = 0
        self.epoch = time.perf_counter()
        # Counter-track source (SERVING.md rung 25): a callable
        # ``epoch -> [event dict]`` returning fully-formed Chrome
        # counter events (ph="C") to merge into export_chrome — the
        # serving layer hangs its occupancy timeline ring here
        # (runtime/slo.py OccupancyRing.chrome_counters) so Perfetto
        # draws HBM/page/bucket occupancy under the span timeline.
        # None = no counter tracks; export is unchanged.
        self.counter_source = None

    # ---- construction from the config knob -------------------------------

    @staticmethod
    def from_knob(value, capacity: int = 4096) -> "Tracer | None":
        """``serving_trace`` (off / on / rate in (0,1]) -> a tracer or
        None. None is the off state: every call site guards with
        ``if tracer is not None`` so off costs one attribute read."""
        if value in ("off", "", None, False):
            return None
        if value in ("on", True):
            return Tracer(sample=1.0, capacity=capacity)
        rate = float(value)
        if not (0.0 < rate <= 1.0):
            raise ValueError(
                f"serving_trace sample rate must be in (0, 1], got {rate!r}"
            )
        return Tracer(sample=rate, capacity=capacity)

    # ---- recording --------------------------------------------------------

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def sampled(self, rid: str) -> bool:
        """Deterministic per-request sampling decision: a pure hash of
        the ID, so all spans of one request share fate and a replayed
        ``X-Request-Id`` traces (or not) identically everywhere."""
        if self.sample >= 1.0:
            return True
        bucket = zlib.crc32(rid.encode("utf-8", "replace")) % 10_000
        return bucket < int(self.sample * 10_000)

    def span(self, name: str, cat: str, t0: float, t1: float | None = None,
             rid: str = "", args: dict | None = None) -> None:
        """Record a complete span [t0, t1] (tracer clock)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._ring.append(("X", t0, max(0.0, t1 - t0), name, cat, rid, args))
        self._appended += 1

    def event(self, name: str, cat: str, rid: str = "",
              args: dict | None = None) -> None:
        """Record an instant event at now()."""
        self._ring.append(
            ("i", time.perf_counter(), 0.0, name, cat, rid, args)
        )
        self._appended += 1

    # ---- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events that fell off the ring (flight-recorder overwrite)."""
        return max(0, self._appended - len(self._ring))

    def stats(self) -> dict:
        return {
            "trace_events": len(self._ring),
            "trace_events_total": self._appended,
            "trace_dropped_total": self.dropped,
            "trace_sample": self.sample,
        }

    def _snapshot(self) -> list:
        """A consistent copy of the ring. deque iteration can raise
        RuntimeError if a writer appends concurrently; retry a few
        times, then settle for list() (which copies atomically enough
        for observability purposes)."""
        for _ in range(4):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        return list(self._ring)

    def last_events(self, n: int = POSTMORTEM_EVENTS) -> list[dict]:
        """The newest ``n`` events as JSON-safe dicts, oldest first —
        the post-mortem embed for ``last-failure.json``."""
        out = []
        for ph, t0, dur, name, cat, rid, args in self._snapshot()[-n:]:
            doc = {
                "name": name,
                "cat": cat,
                "t_ms": round((t0 - self.epoch) * 1000.0, 3),
            }
            if ph == "X":
                doc["dur_ms"] = round(dur * 1000.0, 3)
            if rid:
                doc["rid"] = rid
            if args:
                doc["args"] = args
            out.append(doc)
        return out

    # ---- Chrome/Perfetto export -------------------------------------------

    def export_chrome(self) -> dict:
        """The ring as Chrome trace-event JSON (``GET /trace``).

        One process (pid 1), one track (tid) per span category, named
        with ph="M" thread_name metadata so Perfetto labels the rows.
        Timestamps are microseconds from the tracer's epoch (perf
        counter — monotonic, so the timeline cannot fold)."""
        tids: dict[str, int] = {}
        events = []
        for ph, t0, dur, name, cat, rid, args in self._snapshot():
            tid = tids.get(cat)
            if tid is None:
                tid = tids[cat] = len(tids) + 1
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": round((t0 - self.epoch) * 1e6, 1),
                "pid": 1,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 1)
            else:
                ev["s"] = "t"  # instant scope: thread
            a = dict(args) if args else {}
            if rid:
                a["rid"] = rid
            if a:
                ev["args"] = a
            events.append(ev)
        if self.counter_source is not None:
            # Occupancy counter tracks (ph="C", rung 25). Best-effort:
            # a broken source must never take /trace down with it.
            try:
                events.extend(self.counter_source(self.epoch) or [])
            except Exception:
                pass
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": cat},
            }
            for cat, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "kvedge-tpu flight recorder",
                "dropped": self.dropped,
                "sample": self.sample,
            },
        }
