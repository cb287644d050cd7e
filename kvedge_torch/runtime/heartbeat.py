"""Durable heartbeats and lifecycle files in the state directory.

The port's copy of the JAX package's ``kvedge_tpu/runtime/heartbeat.py``
(its training-progress file lives in ``runtime/train.py``), unchanged
but for this docstring. The runtime (``runtime/boot.py``) writes
``heartbeat.json`` through :class:`HeartbeatWriter`, each record
carrying a ``seq`` that keeps counting and the ``boot_count`` that
:func:`next_boot_count` advances once a boot: after a reschedule onto
the same volume the new runtime's heartbeat shows ``boot_count``
incremented, not reset. The file name and schema are the reference's,
so a state directory the JAX runtime booted in goes on counting under
the port, and the reverse. Beside it: ``init-events.jsonl`` (the
lifecycle log the native PID-1 supervisor and the recovery supervisor
append to), ``last-failure.json``, the post-mortem of the last serving
failure, and ``flight-bundle.json``, the serving flight bundle written
beside it when ``serving_bundle`` is on. Every write is tmp +
``os.replace`` or a one-line append.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

HEARTBEAT_FILE = "heartbeat.json"

# Written by the native PID-1 supervisor (native/kvedge-init.cc) when the
# pod command wraps the entrypoint with it; one JSON object per lifecycle
# event, appended across pod generations. This module owns the filename so
# the renderer (which wires the supervisor's --events flag) and the status
# server (which tails the file) cannot drift.
INIT_EVENTS_FILE = "init-events.jsonl"
INIT_EVENTS_TAIL = 20
# The file is append-only and never truncated; /status must stay O(1) no
# matter how long a crash-loop history the volume carries, so only this
# many trailing bytes are ever read.
_INIT_EVENTS_READ_BYTES = 64 * 1024


def read_init_events(state_dir: str, tail: int = INIT_EVENTS_TAIL) -> list:
    """Last ``tail`` supervisor events, oldest first ([] if never written).

    Reads a bounded tail of the file and skips unparseable lines rather
    than failing: the first line of the window is usually cut mid-record,
    and a crash can truncate the final line mid-write.
    """
    path = os.path.join(state_dir, INIT_EVENTS_FILE)
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - _INIT_EVENTS_READ_BYTES))
            window = fh.read().decode("utf-8", errors="replace")
    except OSError:
        return []
    events = []
    for line in window.splitlines()[-tail:]:
        try:
            events.append(json.loads(line))
        except ValueError:
            continue
    return events


def append_init_event(state_dir: str, doc: dict) -> dict:
    """Append one lifecycle event to ``init-events.jsonl``, stamped with
    ts and the current boot_count.

    The native PID-1 supervisor is the file's primary author; the
    in-process recovery supervisor (runtime/recovery.py) appends its
    own outcomes here so its crash-loop breaker shares the same
    cross-generation memory. Append-only single-line writes are atomic
    enough for the tail reader above (a torn final line is skipped).
    """
    os.makedirs(state_dir, exist_ok=True)
    record = dict(doc)
    record["ts"] = time.time()
    record.setdefault("boot_count", int(
        (read_heartbeat(state_dir) or {}).get("boot_count", 0)
    ))
    path = os.path.join(state_dir, INIT_EVENTS_FILE)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(record) + "\n")
    return record


def _read_json_doc(path: str) -> dict | None:
    """One JSON object from ``path``, or None if absent/corrupt."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def _write_json_atomic(path: str, doc: dict, **dump_kwargs) -> None:
    """tmp + os.replace so readers never observe a half-written file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, **dump_kwargs)
    os.replace(tmp, path)


def read_heartbeat(state_dir: str) -> dict | None:
    """Read the last heartbeat, or None if absent/corrupt (fresh volume)."""
    return _read_json_doc(os.path.join(state_dir, HEARTBEAT_FILE))


# Post-mortem record of the last serving-path failure (typed taxonomy,
# runtime/failures.py): written when the serving pool degrades, read
# back into /status by boot.snapshot(). On the PVC so the REPLACEMENT
# pod — the whole point of degrading is to be rescheduled — can report
# why its predecessor died, the same boot_count-style continuity the
# heartbeat itself proves.
FAILURE_FILE = "last-failure.json"


def write_failure_record(state_dir: str, doc: dict) -> dict:
    """Atomically persist a failure record, stamped with ts and the
    current boot_count (the generation that failed)."""
    os.makedirs(state_dir, exist_ok=True)
    record = dict(doc)
    record["ts"] = time.time()
    record["boot_count"] = int(
        (read_heartbeat(state_dir) or {}).get("boot_count", 0)
    )
    _write_json_atomic(
        os.path.join(state_dir, FAILURE_FILE), record,
        indent=2, sort_keys=True,
    )
    return record


def read_failure_record(state_dir: str) -> dict | None:
    """The last persisted failure, or None (absent/corrupt/never failed)."""
    return _read_json_doc(os.path.join(state_dir, FAILURE_FILE))


# Flight-recorder bundle (SERVING.md rung 25): the full post-mortem
# document — metrics snapshot, SLO/burn state, occupancy timeline
# tail, journal summary, page books, config fingerprint, trace tail —
# written next to last-failure.json when [payload] serving_bundle is
# on. The failure record stays the small human-first summary; the
# bundle is the machine-complete one a tool (or the chaos harness's
# completeness invariant) consumes.
BUNDLE_FILE = "flight-bundle.json"


def write_flight_bundle(state_dir: str, doc: dict) -> dict:
    """Atomically persist a flight-recorder bundle, stamped with ts
    and the current boot_count like the failure record it rides with."""
    os.makedirs(state_dir, exist_ok=True)
    record = dict(doc)
    record["ts"] = time.time()
    record["boot_count"] = int(
        (read_heartbeat(state_dir) or {}).get("boot_count", 0)
    )
    _write_json_atomic(
        os.path.join(state_dir, BUNDLE_FILE), record,
        indent=2, sort_keys=True,
    )
    return record


def read_flight_bundle(state_dir: str) -> dict | None:
    """The last persisted bundle, or None (absent/corrupt/knob off)."""
    return _read_json_doc(os.path.join(state_dir, BUNDLE_FILE))


def write_heartbeat(state_dir: str, payload: dict) -> dict:
    """Atomically write a heartbeat, advancing seq and preserving boot_count."""
    os.makedirs(state_dir, exist_ok=True)
    previous = read_heartbeat(state_dir) or {}
    doc = dict(payload)
    doc["ts"] = time.time()
    doc["seq"] = int(previous.get("seq", 0)) + 1
    doc.setdefault("boot_count", int(previous.get("boot_count", 0)))
    _write_json_atomic(
        os.path.join(state_dir, HEARTBEAT_FILE), doc,
        indent=2, sort_keys=True,
    )
    return doc


def next_boot_count(state_dir: str) -> int:
    """The boot counter for a (re)starting runtime: persisted count + 1."""
    previous = read_heartbeat(state_dir) or {}
    return int(previous.get("boot_count", 0)) + 1


class HeartbeatWriter(threading.Thread):
    """Background heartbeat loop; ``build`` supplies each record's payload."""

    def __init__(self, state_dir: str, interval_s: float,
                 build: Callable[[], dict]):
        super().__init__(name="kvedge-heartbeat", daemon=True)
        self._state_dir = state_dir
        self._interval_s = interval_s
        self._build = build
        self._stop = threading.Event()
        self.last: dict | None = None

    def beat_once(self) -> dict:
        self.last = write_heartbeat(self._state_dir, self._build())
        return self.last

    def run(self) -> None:
        while not self._stop.is_set():
            self.beat_once()
            self._stop.wait(self._interval_s)

    def stop(self) -> None:
        self._stop.set()
