"""Rolling SLO engine: multi-window SLIs, error-budget burn rates, and
the occupancy timeline ring.

The port's copy of the JAX package's ``kvedge_tpu/runtime/slo.py`` (it
imports only ``collections`` and ``dataclasses``), unchanged below this
docstring. The serving layer (``kvedge_torch/models/serving.py``) hands
the engine one snapshot of its cumulative histograms and counters at
each quiescent boundary (``_observe_boundary_locked``); every SLI is
computed here from the DELTA between two ring entries: p99s by
histogram-bucket interpolation, goodput from the token counter over
wall time, the shed rate from the scheduler's shed counter.

* **Deltas, not samples**: a window's SLI comes from ``newest -
  (newest entry at least W old)``, so missed boundaries only stretch
  the window.
* **Reset-safe**: a counter going backwards rebases the ring
  (``resets_total``); a plain ``revive()`` keeps its counters and is
  not a reset.
* **Bounded and lock-free here**: ``observe`` runs under the serving
  lock, readers (``GET /slo``, ``/metrics``, the flight bundle) copy.
* **Zero effect on tokens**: the engine's only output the serving path
  reads is the knob-gated burn-rate shed input (``serving_slo_shed``).

Burn rate: with a compliance target T the error budget is ``1 - T``;
a window's burn is its worst bad fraction (latency SLIs over their
objectives, and the shed rate) over ``1 - T``; the alert fires only
while BOTH the fast and the slow window burn hot.
"""

from __future__ import annotations

import collections
import dataclasses

# Default ring depth: at the boundary-throttled snapshot cadence this
# covers hours of history in a few hundred small dicts.
DEFAULT_RING = 256

# Multi-window alert thresholds (Google SRE workbook's fast/slow page
# pair). Objectives are knobs; these multipliers are the convention.
BURN_FAST_ALERT = 14.0
BURN_SLOW_ALERT = 6.0


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """The configured objectives ([payload] serving_slo_* knobs)."""

    target: float = 0.99        # compliance target; budget = 1 - target
    ttft_ms: float = 1000.0     # TTFT p99 objective
    itl_ms: float = 250.0       # inter-token p99 objective
    queue_ms: float = 1000.0    # queue-wait p99 objective
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0

    def validate(self) -> None:
        if not 0.0 < self.target < 1.0:
            raise ValueError("slo target must be in (0, 1)")
        for name in ("ttft_ms", "itl_ms", "queue_ms"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"slo {name} objective must be > 0")
        if not 0.0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError(
                "slo windows must satisfy 0 < fast <= slow"
            )


# ---- histogram-delta math -------------------------------------------------
#
# Snapshots are models/serving._Hist.snapshot() dicts:
#   {"edges": [e0..e{n-1}], "counts": [c0..cn], "sum": s, "count": n}
# counts are PER-BUCKET (not cumulative); counts[i] falls in
# (edges[i-1], edges[i]], the final slot is the +Inf bucket.


def hist_delta(cur: dict, prev: dict) -> dict | None:
    """``cur - prev`` as a snapshot-shaped dict, or None on a reset
    (shape changed, or any count went backwards — the caller rebases)."""
    if (not isinstance(cur, dict) or not isinstance(prev, dict)
            or list(cur.get("edges", ())) != list(prev.get("edges", ()))
            or len(cur.get("counts", ())) != len(prev.get("counts", ()))):
        return None
    if cur["count"] < prev["count"]:
        return None
    counts = [c - p for c, p in zip(cur["counts"], prev["counts"])]
    if any(c < 0 for c in counts):
        return None
    return {
        "edges": list(cur["edges"]),
        "counts": counts,
        "sum": cur["sum"] - prev["sum"],
        "count": cur["count"] - prev["count"],
    }


def hist_quantile(snap: dict, q: float) -> float | None:
    """Bucket-interpolated quantile of a snapshot (None when empty).

    Linear interpolation inside the containing bucket, Prometheus
    ``histogram_quantile`` style; a quantile landing in the +Inf bucket
    clamps to the highest finite edge (the honest answer a bounded
    histogram can give)."""
    total = snap["count"]
    if total <= 0:
        return None
    edges = snap["edges"]
    rank = q * total
    cum = 0.0
    for i, c in enumerate(snap["counts"]):
        if c <= 0:
            continue
        if cum + c >= rank:
            if i >= len(edges):          # +Inf bucket
                return float(edges[-1])
            lo = edges[i - 1] if i > 0 else 0.0
            frac = (rank - cum) / c
            return float(lo + (edges[i] - lo) * frac)
        cum += c
    return float(edges[-1])


def hist_frac_over(snap: dict, threshold: float) -> float | None:
    """Fraction of observations ABOVE ``threshold`` (None when empty),
    interpolating linearly inside the bucket the threshold splits —
    the per-window error fraction of a latency SLI."""
    total = snap["count"]
    if total <= 0:
        return None
    edges = snap["edges"]
    over = 0.0
    for i, c in enumerate(snap["counts"]):
        if c <= 0:
            continue
        lo = edges[i - 1] if i > 0 else 0.0
        hi = edges[i] if i < len(edges) else float("inf")
        if threshold <= lo:
            over += c
        elif threshold < hi:
            if hi == float("inf"):
                # Can't interpolate into +Inf: count the whole bucket
                # as over (conservative — alerts early, never late).
                over += c
            else:
                over += c * (hi - threshold) / (hi - lo)
    return min(1.0, over / total)


class SloEngine:
    """Bounded ring of boundary snapshots -> rolling SLIs + burn rate.

    ``observe`` is the single-writer feed (serving decode loop, lock
    held); everything else is a pure reader over ring copies.
    """

    def __init__(self, objectives: SloObjectives,
                 ring: int = DEFAULT_RING):
        objectives.validate()
        self.objectives = objectives
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self.snapshots_total = 0
        self.resets_total = 0
        # Snapshot throttle: a boundary-happy idle loop must not churn
        # the ring; one entry per ~1/32 of the fast window is plenty of
        # resolution for a window-delta computation.
        self.min_interval_s = min(
            5.0, max(0.01, objectives.fast_window_s / 32.0)
        )

    def __len__(self) -> int:
        return len(self._ring)

    # ---- writer (serving decode loop, work lock held) -------------------

    def observe(self, t: float, snap: dict) -> bool:
        """Append one cumulative snapshot ``snap`` stamped ``t``
        (tracer clock — ``time.perf_counter()``). Returns False when
        throttled. A snapshot whose counters went backwards rebases
        the ring (reset semantics above)."""
        if self._ring:
            t_last, last = self._ring[-1]
            if t - t_last < self.min_interval_s:
                return False
            if self._is_reset(snap, last):
                self._ring.clear()
                self.resets_total += 1
        self._ring.append((t, snap))
        self.snapshots_total += 1
        return True

    @staticmethod
    def _is_reset(cur: dict, prev: dict) -> bool:
        for key in ("tokens_total", "done_total", "shed_total"):
            if cur.get(key, 0) < prev.get(key, 0):
                return True
        for key in ("ttft_ms", "itl_ms", "queue_ms"):
            if hist_delta(cur.get(key, {}), prev.get(key, {})) is None:
                return True
        return False

    # ---- readers ---------------------------------------------------------

    def _entries(self) -> list:
        return list(self._ring)

    def _window_pair(self, entries: list, now: float,
                     window_s: float) -> tuple | None:
        """(base, head) snapshot pair covering ~``window_s`` ending at
        the newest entry; None when fewer than two entries exist. The
        base is the NEWEST entry at least ``window_s`` older than
        ``now`` (so the delta covers the whole window), falling back to
        the oldest entry when history is still shorter than the
        window."""
        if len(entries) < 2:
            return None
        head = entries[-1]
        base = entries[0]
        cutoff = now - window_s
        for t, snap in entries:
            if t <= cutoff:
                base = (t, snap)
            else:
                break
        if base[0] >= head[0]:
            return None
        return base, head

    def slis(self, window_s: float, now: float | None = None) -> dict:
        """The window's SLIs, or {} when the window is empty (fewer
        than two snapshots, or a reset just rebased the ring)."""
        entries = self._entries()
        if now is None:
            now = entries[-1][0] if entries else 0.0
        pair = self._window_pair(entries, now, window_s)
        if pair is None:
            return {}
        (t0, prev), (t1, cur) = pair
        span = t1 - t0
        out: dict = {"window_s": round(span, 3)}
        for key, objective in (
            ("ttft_ms", self.objectives.ttft_ms),
            ("itl_ms", self.objectives.itl_ms),
            ("queue_ms", self.objectives.queue_ms),
        ):
            delta = hist_delta(cur.get(key, {}), prev.get(key, {}))
            if delta is None or delta["count"] <= 0:
                continue
            out[key.replace("_ms", "_p99_ms")] = round(
                hist_quantile(delta, 0.99), 3
            )
            out[key.replace("_ms", "_frac_over")] = round(
                hist_frac_over(delta, objective), 6
            )
        d_tokens = cur.get("tokens_total", 0) - prev.get("tokens_total", 0)
        d_done = cur.get("done_total", 0) - prev.get("done_total", 0)
        d_shed = cur.get("shed_total", 0) - prev.get("shed_total", 0)
        out["requests_done"] = max(0, d_done)
        out["requests_shed"] = max(0, d_shed)
        out["goodput_tps"] = round(max(0, d_tokens) / span, 3) \
            if span > 0 else 0.0
        offered = max(0, d_done) + max(0, d_shed)
        out["shed_rate"] = round(max(0, d_shed) / offered, 6) \
            if offered else 0.0
        return out

    def error_fraction(self, window_s: float,
                       now: float | None = None) -> float | None:
        """The window's worst bad-event fraction: max of each latency
        SLI's over-objective fraction and the shed rate. None = no
        data (an empty window burns nothing)."""
        s = self.slis(window_s, now)
        if not s:
            return None
        fracs = [v for k, v in s.items() if k.endswith("_frac_over")]
        fracs.append(s.get("shed_rate", 0.0))
        return max(fracs) if fracs else None

    def burn(self, window_s: float,
             now: float | None = None) -> float | None:
        ef = self.error_fraction(window_s, now)
        if ef is None:
            return None
        return ef / (1.0 - self.objectives.target)

    def alert(self, now: float | None = None) -> bool:
        """The multi-window page condition: both windows burning hot.
        Missing data in either window is healthy (no alert) — an idle
        or freshly-rebased pool must not page anyone."""
        fast = self.burn(self.objectives.fast_window_s, now)
        slow = self.burn(self.objectives.slow_window_s, now)
        return (fast is not None and slow is not None
                and fast >= BURN_FAST_ALERT and slow >= BURN_SLOW_ALERT)

    def doc(self, now: float | None = None) -> dict:
        """The ``GET /slo`` document (and the flight bundle's SLO/burn
        state): objectives, both windows' SLIs and burn, the alert."""
        obj = self.objectives
        fast = self.slis(obj.fast_window_s, now)
        slow = self.slis(obj.slow_window_s, now)
        return {
            "objectives": dataclasses.asdict(obj),
            "burn_alert_thresholds": {
                "fast": BURN_FAST_ALERT, "slow": BURN_SLOW_ALERT,
            },
            "windows": {
                "fast": {**fast, "burn": self.burn(obj.fast_window_s,
                                                   now)},
                "slow": {**slow, "burn": self.burn(obj.slow_window_s,
                                                   now)},
            },
            "alert": self.alert(now),
            "snapshots": len(self._ring),
            "snapshots_total": self.snapshots_total,
            "resets_total": self.resets_total,
        }

    def metrics(self) -> dict:
        """Flat numeric gauges for ``/metrics`` (0.0 = no data — a
        Prometheus series must exist even before the first window
        fills, or recording rules break on the gap)."""
        obj = self.objectives
        fast = self.slis(obj.fast_window_s)
        burn_fast = self.burn(obj.fast_window_s)
        burn_slow = self.burn(obj.slow_window_s)
        return {
            "slo_ttft_p99_ms": fast.get("ttft_p99_ms", 0.0),
            "slo_itl_p99_ms": fast.get("itl_p99_ms", 0.0),
            "slo_queue_p99_ms": fast.get("queue_p99_ms", 0.0),
            "slo_goodput_tps": fast.get("goodput_tps", 0.0),
            "slo_shed_rate": fast.get("shed_rate", 0.0),
            "slo_burn_fast": burn_fast if burn_fast is not None else 0.0,
            "slo_burn_slow": burn_slow if burn_slow is not None else 0.0,
            "slo_alert": 1 if self.alert() else 0,
            "slo_snapshots_total": self.snapshots_total,
            "slo_resets_total": self.resets_total,
        }


class OccupancyRing:
    """Bounded timeline of occupancy samples (HBM pages, bucket,
    prefix residency, journal bytes) taken at quiescent boundaries.

    Single writer (decode loop, lock held); readers copy. Exported two
    ways: the latest sample flattens into ``/metrics`` gauges
    (``serve_occupancy_*``), and the whole tail merges into the Chrome
    trace as counter tracks (ph="C") so Perfetto draws the pool's
    occupancy under the span timeline it already shows."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("occupancy ring capacity must be >= 1")
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity)
        )
        self.samples_total = 0

    def __len__(self) -> int:
        return len(self._ring)

    def sample(self, t: float, fields: dict) -> None:
        self._ring.append((t, fields))
        self.samples_total += 1

    def last(self) -> dict | None:
        if not self._ring:
            return None
        return dict(self._ring[-1][1])

    def tail(self, n: int = 64) -> list[dict]:
        """The newest ``n`` samples, oldest first, JSON-safe — the
        flight bundle's occupancy timeline."""
        return [
            {"t": round(t, 6), **fields}
            for t, fields in list(self._ring)[-n:]
        ]

    def chrome_counters(self, epoch: float) -> list[dict]:
        """The ring as Chrome counter events (ph="C"), stacked per
        sample under one 'occupancy' track; ts microseconds from the
        tracer ``epoch`` (both clocks are ``time.perf_counter()``)."""
        return [
            {
                "name": "occupancy",
                "cat": "occupancy",
                "ph": "C",
                "ts": round((t - epoch) * 1e6, 1),
                "pid": 1,
                "tid": 0,
                "args": dict(fields),
            }
            for t, fields in list(self._ring)
        ]
