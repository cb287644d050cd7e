"""What a profile capture costs the requests it overlaps, on one card.

    python -m kvedge_torch.tools.profile_pause [--seconds S] [--rows R]
        [--n-new N] [--modes none,none,capture,stop_locked,capture]
        [--preset flagship] [--device cuda|cpu] [--out PATH]

Boots the ``serve`` payload through ``start_runtime`` at the main path's
settings (``--preset``, bf16 on the card, 4 slots, max_seq 2048, page 16,
prefill chunk 64, window 64, the status server on a free port), makes a
0.1 s capture as a warm-up (the process's first profiler start
initializes CUPTI), then for each mode in ``--modes`` streams ``--rows``
greedy requests of ``--n-new`` tokens at once over ``POST /generate``
while a thread reads ``GET /status`` every 20 ms (the first run also
captures the graphs its shapes need). Once every request has its first
token:

* ``none`` profiles nothing;
* ``capture`` runs the runtime's capture for ``--seconds``, as
  ``POST /profile`` runs it (``runtime/profiling.py``: the toggles alone
  hold the server's work lock, the trace is written after);
* ``stop_locked`` runs ``torch.profiler.profile`` for ``--seconds`` and
  calls its ``stop()`` with the work lock held, then exports the trace:
  the capture as it was before its stop was split.

Per mode it prints one JSON line, and writes all of them with the card's
name and power limit to ``--out``: each request's TTFT and its longest
gap between two token records (over the run and inside the capture's
window), the longest ``/status`` answer (over the run and inside the
window), the capture's ``start_s``, ``stop_s`` (the work lock's holds;
the stop's ``sync_s`` and ``disable_s`` apart) and ``export_s``, its
trace's kernel events and bytes. The runtime runs
on the card unless ``--device cpu`` is given (with ``--preset probe``,
to try the tool on a host with no card).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
import urllib.request


def _toml(state_dir: str, preset: str, device: str) -> str:
    return (
        "[runtime]\n"
        'name = "profile-pause"\n'
        f"state_dir = {json.dumps(state_dir)}\n"
        "[tpu]\n"
        f'platform = "{"gpu" if device == "cuda" else "cpu"}"\n'
        "[model]\n"
        f'preset = "{preset}"\n'
        "[payload]\n"
        'kind = "serve"\nserving = "paged"\n'
        "seq = 2048\nserving_slots = 4\nserving_page_size = 16\n"
        "serving_prefill_chunk = 64\nserving_window = 64\n"
        "[status]\n"
        'port = 0\nbind = "127.0.0.1"\n')


def _stream(port: int, doc: dict, out: dict) -> None:
    """One streamed request: the times its token records arrived."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    arrivals: list = []
    out.update(t0=time.perf_counter(), arrivals=arrivals)
    conn.request("POST", "/generate", json.dumps(doc),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    for line in resp:
        rec = json.loads(line)
        if "token" in rec:
            arrivals.append(time.perf_counter())
        elif rec.get("done"):
            break
    conn.close()
    out["status"] = resp.status


def _poll_status(base: str, stop: threading.Event, out: list) -> None:
    while not stop.is_set():
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + "/status", timeout=600) as r:
            r.read()
        out.append((t0, time.perf_counter() - t0))
        time.sleep(0.02)


def _stop_in_lock(quiet, cuda: bool, seconds: float, trace_dir: str) -> dict:
    """``torch.profiler.profile`` with its whole ``stop()`` under the
    work lock, as the capture ran before its stop was split."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    prof = profile(activities=acts)
    t0 = time.perf_counter()
    with quiet():
        prof.start()
    start_s = time.perf_counter() - t0
    time.sleep(seconds)
    t0 = time.perf_counter()
    with quiet():
        prof.stop()
    stop_s = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    return {"trace_dir": trace_dir, "start_s": round(start_s, 3),
            "stop_s": round(stop_s, 3),
            "export_s": round(time.perf_counter() - t0, 3),
            "bytes": os.path.getsize(path)}


def _timed_capture(trace_capture, seconds: float) -> dict:
    """The runtime's capture, its stop's device sync and disable timed
    apart (both inside the work lock's hold, ``stop_s``)."""
    import torch

    from kvedge_torch.runtime import profiling

    parts: dict = {}
    off = profiling._profiler_off

    def timed_off(cuda: bool):
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = off(False)
        parts.update(sync_s=round(t1 - t0, 4),
                     disable_s=round(time.perf_counter() - t1, 4))
        return results

    profiling._profiler_off = timed_off
    try:
        return dict(trace_capture.capture(seconds), **parts)
    finally:
        profiling._profiler_off = off


def _kernel_events(trace_dir: str) -> int:
    import gzip

    for name in ("trace.json.gz", "trace.json"):
        path = os.path.join(trace_dir, name)
        if os.path.exists(path):
            opener = gzip.open if name.endswith(".gz") else open
            with opener(path, "rt") as fh:
                events = json.load(fh).get("traceEvents", [])
            return sum(ev.get("cat") == "kernel" for ev in events)
    return 0


def _run(handle, mode: str, args, prompts) -> dict:
    base = f"http://127.0.0.1:{handle.status_port}"
    reqs = [dict() for _ in prompts]
    threads = [threading.Thread(target=_stream, args=(
        handle.status_port, {"tokens": [p], "n_new": args.n_new,
                             "stream": True}, r)) for p, r in
        zip(prompts, reqs)]
    polls: list = []
    stop = threading.Event()
    poller = threading.Thread(target=_poll_status, args=(base, stop, polls))
    poller.start()
    for t in threads:
        t.start()
    while not all(r.get("arrivals") or r.get("status") for r in reqs):
        if not any(t.is_alive() for t in threads):
            break
        time.sleep(0.005)
    window = None
    cap: dict = {}
    if mode != "none":
        time.sleep(0.1)  # every row in decode
        t0 = time.perf_counter()
        if mode == "capture":
            cap = _timed_capture(handle.trace_capture, args.seconds)
        else:
            cap = _stop_in_lock(
                handle.serve_fn.device_quiet,
                handle.check.platform == "gpu", args.seconds,
                os.path.join(handle.cfg.state_dir, "traces",
                             f"stop-locked-{time.time_ns()}"))
        window = (t0, time.perf_counter())
        cap["kernel_events"] = _kernel_events(cap["trace_dir"])
    for t in threads:
        t.join()
    stop.set()
    poller.join()

    def gap(arr, lo=None, hi=None):
        gaps = [(b - a) for a, b in zip(arr, arr[1:])
                if lo is None or (b >= lo and a <= hi)]
        return round(max(gaps), 4) if gaps else None

    out = {"mode": mode, "seconds": args.seconds if window else 0.0,
           "rows": len(prompts), "n_new": args.n_new,
           "statuses": [r.get("status") for r in reqs],
           "tokens": [len(r.get("arrivals", [])) for r in reqs],
           "ttft_s": [round(r["arrivals"][0] - r["t0"], 4)
                      if r.get("arrivals") else None for r in reqs],
           "max_gap_s": [gap(r.get("arrivals", [])) for r in reqs],
           "status_polls": len(polls),
           "status_max_s": round(max(d for _, d in polls), 4)
           if polls else None}
    if window is not None:
        lo, hi = window
        out["window_s"] = round(hi - lo, 3)
        out["max_gap_in_window_s"] = [gap(r.get("arrivals", []), lo, hi)
                                      for r in reqs]
        inside = [d for t, d in polls if lo <= t <= hi]
        out["status_max_in_window_s"] = (round(max(inside), 4)
                                         if inside else None)
        out["capture"] = {k: cap.get(k) for k in (
            "start_s", "stop_s", "sync_s", "disable_s", "export_s",
            "bytes", "kernel_events", "duration_s")}
    return out


def _card() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--n-new", type=int, default=1500)
    ap.add_argument("--modes",
                    default="none,none,capture,stop_locked,capture")
    ap.add_argument("--preset", default="flagship")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="build/profile_pause.json")
    args = ap.parse_args(argv)

    import numpy as np

    from kvedge_torch.runtime import boot
    from kvedge_torch.runtime.config import RuntimeConfig

    state = tempfile.mkdtemp(prefix="profile-pause-")
    try:
        cfg = RuntimeConfig.parse(_toml(state, args.preset, args.device))
        handle = boot.start_runtime(
            cfg, device=args.device,
            dtype="bfloat16" if args.device == "cuda" else "float32")
        try:
            if not handle.check.ok:
                print(f"profile_pause: boot failed: {handle.check.error}")
                return 1
            card = _card() if args.device == "cuda" else "cpu"
            vocab = cfg.model_config().vocab
            rng = np.random.default_rng(15)
            prompts = [rng.integers(0, vocab, 40).tolist()
                       for _ in range(args.rows)]
            warm = handle.trace_capture.capture(0.1)
            lines = [{"mode": "warm-up", "card": card,
                      "capture": {k: warm[k] for k in (
                          "start_s", "stop_s", "export_s", "bytes")}}]
            print(json.dumps(lines[0]), flush=True)
            for mode in args.modes.split(","):
                doc = dict(_run(handle, mode, args, prompts), card=card)
                print(json.dumps(doc), flush=True)
                lines.append(doc)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as fh:
                    json.dump(lines, fh, indent=1)
        finally:
            handle.shutdown()
    finally:
        shutil.rmtree(state, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
