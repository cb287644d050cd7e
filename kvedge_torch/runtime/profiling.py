"""On-demand profiler trace capture, persisted through the state volume.

The counterpart of the JAX package's ``kvedge_tpu/runtime/profiling.py``
on ``torch.profiler``: ``POST /profile?seconds=N`` records the CPU and,
on the card, the CUDA activity of the whole process for a bounded
window and writes it as a Chrome trace, ``trace.json.gz`` (loads in
Perfetto or ``chrome://tracing``), under
``<state_dir>/traces/trace-NNNN/``, so traces survive a reschedule as
heartbeats and checkpoints do. Kernels replayed inside a CUDA graph
(the serving windows and prefill chunks) appear in it by name.

Turning the profiler on or off while another thread launches device
work can deadlock the process: on the card a stop racing a window
graph's replay hung both for good (the stop holding the interpreter
lock inside CUPTI, the replay inside the driver). So the two toggles,
and only they, run inside the context manager ``quiet()`` returns,
which holds the payload's device work off: the serve payload's is its
server's work lock, under which every window, prefill chunk, graph
capture and swap runs. The start is the profiler's prepare and enable,
made on the autograd profiler's own calls (``torch.profiler.profile``'s
start also imports ``torch._inductor``, seconds the first time); the
stop is a device sync and the disable, which hands back kineto's raw
results. The trace is written from those results (the Chrome JSON,
then its gzip) after ``quiet()`` is released. The disable and the
JSON's writing still hold the interpreter lock, so every Python thread
of the process, the decode loop's and the status server's included,
waits for them: seconds at the flagship's width, growing with the
kernel events the window saw. The serve payload therefore caps a
window at :data:`SERVE_MAX_SECONDS`. The trace holds the device's
kernels from every thread and the CPU operators of the capturing
thread.
"""

from __future__ import annotations

import contextlib
import functools
import os
import shutil
import threading
import time
from typing import Callable, ContextManager

import torch

from kvedge_torch.runtime.devicecheck import resolve_device

TRACE_FILE = "trace.json.gz"

# The serve payload's longest capture window. On one H100 80GB HBM3
# (700 W) the flagship's 4 slots in solid decode made 124k-166k kernel
# events in a 0.5 s window and 411k in a 2 s one, and the stop and the
# writing paused every row 3.3-6.5 s and 22.5 s (``tools/profile_pause.py``);
# the reference's 60 s window would make a JSON of ~15 GB.
SERVE_MAX_SECONDS = 1.0


class CaptureBusy(RuntimeError):
    """A trace capture is already in progress (only one at a time)."""


class CaptureUnavailable(RuntimeError):
    """The runtime cannot profile right now (e.g. still booting)."""


def default_activity(device=None) -> None:
    """A small device workload so a capture is never empty: one bf16
    matmul on ``device`` (the card unless the CPU is asked for),
    waited for."""
    dev = resolve_device(device)
    x = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
    (x @ x).sum().item()


def _profiler_on(cuda: bool):
    """Prepare and enable a kineto session with CPU and, on the card,
    CUDA activity (the toggle ``torch.profiler.profile.start`` makes)."""
    from torch.autograd import profiler as autograd_profiler

    session = autograd_profiler.profile(
        use_device="cuda" if cuda else None, use_kineto=True)
    session._prepare_trace()
    session._start_trace()
    return session


def _profiler_off(cuda: bool):
    """The toggle half of a stop: wait for the card, then disable the
    session and return kineto's raw results, unparsed. The profiler's own
    ``stop()`` may go on to parse every event into Python objects, which
    a trace file does not need."""
    from torch.autograd import profiler as autograd_profiler

    if cuda:
        torch.cuda.synchronize()
    results = torch.autograd._disable_profiler()
    # The module flag the profiler's own stop clears (absent in older
    # releases).
    getattr(autograd_profiler, "_run_on_profiler_stop", lambda: None)()
    return results


def _write_trace(results, path: str) -> None:
    """The Chrome trace at ``path`` (``.json.gz``): kineto writes the JSON
    beside it, then it is compressed at level 1 in 1 MiB blocks. The
    profiler's own ``.gz`` export compresses at level 9 line by line, ten
    times slower on a flagship decode's hundreds of MB."""
    import gzip

    raw = path[:-len(".gz")]
    results.save(raw)
    try:
        with open(raw, "rb") as src, gzip.open(path, "wb",
                                               compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 20)
    finally:
        os.remove(raw)


class TraceCapture:
    """Bounded, serialized ``torch.profiler`` captures into the state dir.

    Trace directories are numbered past any that already exist on the
    state volume (the volume outlives the pod), and only the newest
    ``keep`` traces are retained — the traces dir shares its volume with
    heartbeats and checkpoints, and the capture endpoint is reachable
    through the LoadBalancer, so unbounded growth would let repeated
    captures fill the volume and degrade the runtime. ``activity`` runs
    at a 0.5 s cadence inside the window (None: nothing);
    :func:`default_activity` runs on ``device``. ``quiet()`` returns the
    context manager the profiler's two toggles run in (module doc).
    """

    def __init__(self, state_dir: str, *, max_seconds: float = 60.0,
                 keep: int = 8,
                 activity: Callable[[], None] | None = default_activity,
                 device=None,
                 quiet: Callable[[], ContextManager] = contextlib.nullcontext):
        self._traces_dir = os.path.join(state_dir, "traces")
        self._max_seconds = max_seconds
        self._keep = max(1, keep)
        # Resolved at each capture: a runtime whose card is missing
        # still lists its traces.
        self._device = device
        self._activity = (functools.partial(default_activity, device)
                          if activity is default_activity else activity)
        self._quiet = quiet
        self._lock = threading.Lock()

    @staticmethod
    def _trace_seq(name: str) -> int:
        try:
            return int(name.split("-", 1)[1])
        except (IndexError, ValueError):
            return -1

    def _existing_traces(self) -> list[str]:
        """Trace dir names, oldest first by *numeric* sequence.

        Lexicographic order would break past trace-9999 (``trace-10000``
        sorts before ``trace-1001``), making retention delete the capture
        it just wrote.
        """
        try:
            names = os.listdir(self._traces_dir)
        except FileNotFoundError:
            return []
        return sorted(
            (n for n in names if n.startswith("trace-")), key=self._trace_seq
        )

    def _next_trace_dir(self) -> str:
        seq = max(
            (self._trace_seq(n) for n in self._existing_traces()), default=0
        )
        return os.path.join(self._traces_dir, f"trace-{max(seq, 0) + 1:04d}")

    def _sweep_retention(self) -> None:
        for name in self._existing_traces()[:-self._keep]:
            shutil.rmtree(os.path.join(self._traces_dir, name),
                          ignore_errors=True)

    def list(self) -> list[dict]:
        """The on-disk captures, oldest first — ``GET /profile/traces``.

        Pure filesystem walk (no profiler, no lock): safe to call from
        the status server's handler threads at any time, including
        while a capture is running (the in-progress dir just shows its
        bytes-so-far).
        """
        out = []
        for name in self._existing_traces():
            trace_dir = os.path.join(self._traces_dir, name)
            files = [
                os.path.join(root, f)
                for root, _, fs in os.walk(trace_dir) for f in fs
            ]
            try:
                size = sum(os.path.getsize(f) for f in files)
                mtime = os.path.getmtime(trace_dir)
            except OSError:
                continue  # swept by retention mid-walk
            out.append({
                "name": name,
                "seq": self._trace_seq(name),
                "age_s": round(max(0.0, time.time() - mtime), 3),
                "files": len(files),
                "bytes": size,
            })
        return out

    def capture(self, seconds: float = 3.0) -> dict:
        """Trace the process's activity for ``seconds``; return a summary
        doc (the reference's ``trace_dir``, ``duration_s``, ``files``,
        ``bytes``; and the port's ``start_s`` and ``stop_s``, the seconds
        each toggle held ``quiet()``, waiting for it included, and
        ``export_s``, the trace's writing after it)."""
        seconds = min(max(float(seconds), 0.1), self._max_seconds)
        if not self._lock.acquire(blocking=False):
            raise CaptureBusy("a trace capture is already running")
        try:
            cuda = resolve_device(self._device).type == "cuda"
            t0 = time.perf_counter()
            with self._quiet():
                if torch.autograd._profiler_enabled():
                    # Another profiler runs in this process: starting
                    # this one would end it.
                    raise CaptureBusy("a profiler is already running in "
                                      "this process")
                _profiler_on(cuda)
            start_s = time.perf_counter() - t0
            started = time.time()
            trace_dir = self._next_trace_dir()
            try:
                os.makedirs(trace_dir, exist_ok=True)
                # The activity only needs to guarantee the trace is never
                # empty — run it at a slow cadence and sleep the rest of
                # the window, so a long capture records the *payload's*
                # device work instead of drowning it in synthetic matmuls
                # (and doesn't peg a host thread for the whole window).
                deadline = started + seconds
                activity_cadence = 0.5
                next_activity = started
                while True:
                    now = time.time()
                    if now >= deadline:
                        break
                    if self._activity is not None and now >= next_activity:
                        self._activity()
                        next_activity = time.time() + activity_cadence
                    wakeup = deadline if self._activity is None else min(
                        deadline, next_activity
                    )
                    time.sleep(max(0.0, min(0.1, wakeup - time.time())))
            finally:
                t0 = time.perf_counter()
                with self._quiet():
                    results = _profiler_off(cuda)
                stop_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _write_trace(results, os.path.join(trace_dir, TRACE_FILE))
            export_s = time.perf_counter() - t0
            self._sweep_retention()
            files = [
                os.path.join(root, f)
                for root, _, fs in os.walk(trace_dir) for f in fs
            ]
            return {
                "trace_dir": trace_dir,
                "duration_s": round(time.time() - started, 3),
                "files": len(files),
                "bytes": sum(os.path.getsize(f) for f in files),
                # The port's: the pauses of device work, and the writing.
                "start_s": round(start_s, 3),
                "stop_s": round(stop_s, 3),
                "export_s": round(export_s, 3),
            }
        finally:
            self._lock.release()
