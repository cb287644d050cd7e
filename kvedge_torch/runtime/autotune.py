"""Online window / spec-depth controller.

The port's copy of the JAX package's ``kvedge_tpu/runtime/autotune.py``
(it imports nothing), unchanged below this docstring. The overlap
pipeline moves ``W / max(R, W * t)`` steps a second, where ``W`` is the
dispatched window, ``t`` the device time a step and ``R`` the host's
turnaround a window; past ``W * t >= R`` a larger window buys nothing
but staleness, so the pick is the SMALLEST power of two with ``W * t >=
R`` inside ``[lo, hi]``.

The serving layer (``kvedge_torch/models/serving.py``) feeds it at each
harvest: ``device_ms`` is the harvested window's device time (on the
card the CUDA events around its graph replay, read once the harvest
has waited; on the CPU the eager run's host time), ``rtt_ms`` the
dispatch-to-harvest wall time and ``host_ms`` the harvest's host
bookkeeping. ``R = max(rtt_ms - device_ms, 0) + host_ms``; ``R`` and
``t`` are EWMAs. The window is scheduling only: the greedy argmax and
the positional ``fold_in(seed, t)`` key schedule give the same tokens
at every W. The controller is plain data mutated under the serving
lock and survives ``revive()``.
"""

from __future__ import annotations

__all__ = ["pick_window", "WindowController"]


def _pow2_floor(w: int) -> int:
    return 1 if w <= 1 else 1 << (int(w).bit_length() - 1)


def pick_window(r_ms: float, t_ms: float, lo: int, hi: int) -> int:
    """Smallest power-of-two ``W`` in ``[lo, hi]`` with ``W*t >= R``.

    Pure function of the two EWMA'd measurements — the controller law,
    separated out so the convergence tests can drive it against a
    synthetic (R, t) schedule without a server. ``lo``/``hi`` are
    clamped to powers of two (floor), matching the serving layer's
    compiled-program set {1, 2, 4, ...}. Degenerate measurements
    (``t <= 0``: the device looks free) pin to ``hi`` — the largest
    window amortizes an unmeasurably-fast device best.
    """
    lo = _pow2_floor(max(1, int(lo)))
    hi = _pow2_floor(max(1, int(hi)))
    if hi < lo:
        hi = lo
    if t_ms <= 0.0:
        return hi
    w = lo
    while w < hi and w * t_ms < r_ms:
        w <<= 1
    return w


class WindowController:
    """EWMA state + the :func:`pick_window` law for one serving loop.

    One instance can drive several channels (the plain decode window
    and the spec-window depth) — each channel keeps its own (R, t)
    estimate because verify passes and decode steps have different
    per-step device costs. All methods are plain-data and called with
    the serving work lock held; the instance itself takes no locks.
    """

    __slots__ = ("lo", "hi", "alpha", "_r", "_t", "_updates")

    def __init__(self, lo: int = 1, hi: int = 256,
                 alpha: float = 0.2):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self.lo = _pow2_floor(max(1, int(lo)))
        self.hi = _pow2_floor(max(1, int(hi)))
        if self.hi < self.lo:
            raise ValueError("window bounds inverted: "
                             f"[{lo}, {hi}]")
        self.alpha = float(alpha)
        self._r: dict[str, float] = {}
        self._t: dict[str, float] = {}
        self._updates: dict[str, int] = {}

    def observe(self, *, rtt_ms: float, device_ms: float,
                host_ms: float, window: int,
                channel: str = "decode") -> None:
        """Feed one harvested window's measurements (lock held).

        ``window`` is the size that was actually dispatched — the
        per-step device time is ``device_ms / window``. The first
        observation seeds the EWMAs directly (no warm-up bias toward
        zero)."""
        if window <= 0:
            return
        r = max(float(rtt_ms) - float(device_ms), 0.0) + float(host_ms)
        t = max(float(device_ms), 0.0) / float(window)
        a = self.alpha
        if channel in self._updates:
            self._r[channel] += a * (r - self._r[channel])
            self._t[channel] += a * (t - self._t[channel])
            self._updates[channel] += 1
        else:
            self._r[channel] = r
            self._t[channel] = t
            self._updates[channel] = 1

    def window(self, channel: str = "decode",
               default: int | None = None) -> int:
        """Current recommendation: :func:`pick_window` on the EWMAs.
        Before the first observation returns ``default`` (clamped) —
        the operator's static seed — or ``hi`` when none given."""
        if channel not in self._updates:
            if default is None:
                return self.hi
            return max(self.lo, min(self.hi,
                                    _pow2_floor(max(1, default))))
        return pick_window(self._r[channel], self._t[channel],
                           self.lo, self.hi)

    def snapshot(self, channel: str = "decode") -> dict:
        """Plain-dict state for /status + the flight recorder."""
        return {
            "window": self.window(channel),
            "r_ms": self._r.get(channel, 0.0),
            "t_ms": self._t.get(channel, 0.0),
            "updates": self._updates.get(channel, 0),
            "lo": self.lo,
            "hi": self.hi,
        }
