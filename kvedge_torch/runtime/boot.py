"""Runtime boot orchestration: applied config -> payload -> heartbeat + status.

The counterpart of the JAX package's ``kvedge_tpu/runtime/boot.py``, and
what ``kvedge-runtime boot`` (the last ``runcmd`` of the boot document,
``bootstrap/commands.py``) runs. :func:`start_runtime` keeps the
reference's order: the status server first, answering in the
``booting`` state; the sweep of stranded tmp files; a heartbeat (with
this boot's ``boot_count``) before the server answers; the topology
check; the count of the cards the pod sees and the mesh resolved over
``num_processes`` x that count (``parallel/launch.visible_cards``,
``RuntimeConfig.check_world``); the local ranks, one a further card,
and the join of the world (``parallel/launch.join_world``; with one
card a pod ``parallel/distributed.maybe_initialize``, a no-op for one
pod); the payload; a second heartbeat. A payload that fails or raises,
a mesh the cards cannot hold, a local rank that exits or a join that
fails degrades the runtime (``/status`` answers, ``/healthz`` is 503
with the reason) instead of crashing it; a mesh that does not resolve
starts no local rank. ``/status``'s
``distributed`` is the joined state and its ``check`` the mesh over the
whole world. This process is local rank 0: only it runs the status
server and the heartbeat. ``POST /profile`` is refused until the payload
has run.

:func:`boot` never returns in a pod: it beats every
``heartbeat_interval_s`` on the main thread until SIGTERM or SIGINT,
then shuts the runtime down (the serve payload dumps its prefix
registry there); ``once=True`` performs a single cycle for tests and
local verification. Payloads run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import Callable

from kvedge_torch.parallel import launch
from kvedge_torch.parallel.distributed import (
    DistributedState,
    maybe_initialize,
    shutdown_world,
)
from kvedge_torch.runtime import heartbeat, recovery
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.runtime.devicecheck import (
    DeviceCheckResult,
    run_device_check,
)
from kvedge_torch.runtime.profiling import (
    SERVE_MAX_SECONDS,
    CaptureUnavailable,
    TraceCapture,
)
from kvedge_torch.runtime.status import GenerateUnavailable, StatusServer
from kvedge_torch.runtime.train import read_train_progress


@dataclasses.dataclass
class RuntimeHandle:
    """A started runtime: payload result, heartbeat writer, status server."""

    cfg: RuntimeConfig
    check: DeviceCheckResult
    writer: heartbeat.HeartbeatWriter
    server: StatusServer
    boot_count: int
    started_at: float
    trace_capture: TraceCapture
    # Set by the ``serve`` payload once its model is restored; the status
    # server's POST /generate routes through it.
    serve_fn: Callable[[dict], dict] | None = None
    # The train and eval payloads' own result (train.PayloadResult).
    result: object = None
    # The world this runtime joined at boot (inactive for one pod of one
    # card), and this pod's other local ranks (None without).
    distributed: DistributedState = DistributedState(active=False)
    local: launch.LocalWorld | None = None

    @property
    def status_port(self) -> int:
        return self.server.port

    def snapshot(self) -> dict:
        """The ``GET /status`` document (and ``/metrics``' source): the
        reference's ``RuntimeHandle.snapshot()`` keys."""
        last = heartbeat.read_heartbeat(self.cfg.state_dir) or {}
        return {
            "name": self.cfg.name,
            "ok": self.check.ok,
            "payload": self.cfg.payload,
            "check": self.check.to_dict(),
            "boot_count": self.boot_count,
            "uptime_s": round(time.time() - self.started_at, 3),
            "heartbeat_seq": last.get("seq", 0),
            "heartbeat_age_s": (
                round(time.time() - last["ts"], 3) if "ts" in last else None
            ),
            "distributed": self.distributed.to_dict(),
            # Supervision history from the native PID-1 supervisor and the
            # recovery supervisor, across pod generations.
            "init_events": heartbeat.read_init_events(self.cfg.state_dir),
            # Live (or last-known) train-payload progress; None unless a
            # train payload has written it.
            "train_progress": read_train_progress(self.cfg.state_dir),
            # Serving request/pool stats; None unless the serve payload is
            # live.
            "serving": (
                self.serve_fn.stats()
                if getattr(self.serve_fn, "stats", None) is not None
                else None
            ),
            # Post-mortem of the last serving failure, on the state volume,
            # so a replacement pod reports why its predecessor died.
            "last_failure": heartbeat.read_failure_record(self.cfg.state_dir),
        }

    def shutdown(self) -> None:
        self.writer.stop()
        self.server.shutdown()
        # The serve payload's backend owns a decode thread and the
        # device page pool; release them with the runtime.
        closer = getattr(self.serve_fn, "close", None)
        if closer is not None:
            closer()
        if self.local is not None:
            self.local.close()
        if self.distributed.active:
            shutdown_world()


def serve_routes(cfg: RuntimeConfig,
                 serve_fn: Callable[[], object],
                 check: Callable[[], DeviceCheckResult]) -> dict:
    """The :class:`StatusServer` callbacks that read the serve payload:
    ``healthy``, ``health_detail``, ``generator``, ``trace_doc``,
    ``slo_doc`` and ``bundle_doc``. ``serve_fn()`` returns the payload's
    ``serve_fn`` (None until it is live) and ``check()`` the runtime's
    check, both read at request time."""

    def generate(doc: dict) -> dict:
        # The handler thread reads serve_fn at request time: it is None
        # until the serve payload finishes restoring its model.
        fn = serve_fn()
        if fn is None:
            raise GenerateUnavailable(
                "no generation backend yet (payload is not 'serve', it "
                "failed, or the runtime is still booting)"
            )
        return fn(doc)

    def optional_doc(name: str) -> Callable[[], dict | None]:
        # GET /trace, /slo and /debug/bundle: read at request time — None
        # (404) until the serve payload is live AND its knob is on.
        def doc() -> dict | None:
            fn = getattr(serve_fn(), name, None)
            return fn() if fn is not None else None
        return doc

    def trace_doc() -> dict | None:
        tracer = getattr(serve_fn(), "tracer", None)
        return tracer.export_chrome() if tracer is not None else None

    def serve_degraded() -> str | None:
        # Lock-free by contract: /healthz is hit by liveness probes every
        # few seconds and must never queue behind the serving work lock.
        fn = getattr(serve_fn(), "degraded", None)
        return fn() if fn is not None else None

    def health_detail() -> dict | None:
        # A poisoned serving pool under active recovery reports 503
        # NON-terminal with a retry-after hint, so probes
        # (healthcheck.wait_healthy) keep polling through the heal;
        # without a supervisor — or after its escalation — the poison is
        # terminal (it only clears by rescheduling).
        reason = serve_degraded()
        if reason is not None:
            rec = getattr(serve_fn(), "recovery", None)
            if rec is not None:
                try:
                    doc = rec()
                except Exception:
                    doc = None
                if doc and doc.get("state") == "recovering":
                    out = {"reason": reason, "terminal": False,
                           "recovering": True}
                    # Always a retry hint: the supervisor's measured
                    # estimate when it has one, else the configured one.
                    out["retry_after_s"] = (
                        doc["retry_after_s"]
                        if doc.get("retry_after_s") is not None
                        else cfg.serving_retry_after_s
                    )
                    # The lock-free capacity probe rides along.
                    cap = getattr(serve_fn(), "capacity", None)
                    if cap is not None:
                        try:
                            out.update(cap())
                        except Exception:
                            pass
                    return out
            return {"reason": reason, "terminal": True}
        if not check().ok and check().error:
            return {"reason": check().error}
        return None

    return {
        "healthy": lambda: check().ok and serve_degraded() is None,
        "health_detail": health_detail,
        "generator": generate,
        "trace_doc": trace_doc,
        "slo_doc": optional_doc("slo"),
        "bundle_doc": optional_doc("bundle"),
    }


def _degraded(error: str) -> DeviceCheckResult:
    """A failed check that still serves /status (degraded, debuggable from
    outside) instead of crash-looping the pod with a raw traceback."""
    return DeviceCheckResult(
        ok=False, platform="unknown", device_count=0, device_kinds=(),
        mesh_axes=(), mesh_shape=(), probe_ms=0.0, probe_checksum=0.0,
        error=error,
    )


def _topology_mismatch(cfg: RuntimeConfig, device=None) -> str:
    """Non-empty iff the chart topology and the config TOML, or the
    chart and the cards this pod sees, disagree.

    The multi-host chart re-states its replica count as
    ``KVEDGE_EXPECTED_PROCESSES``; plain Helm cannot parse the config
    TOML at install time, so this boot-time check is what catches a TOML
    whose ``[distributed]`` section is missing or wrong — otherwise N
    pods would boot as N healthy, *independent* single-host runtimes.
    A chart of several cards a pod states them as
    ``KVEDGE_EXPECTED_CARDS``, held to the cards visible
    (``parallel/launch.visible_cards``).
    """
    expected_raw = os.environ.get("KVEDGE_EXPECTED_PROCESSES", "")
    if expected_raw:
        try:
            expected = int(expected_raw)
        except ValueError:
            return (f"KVEDGE_EXPECTED_PROCESSES={expected_raw!r} is not an "
                    "integer")
        if expected != cfg.num_processes:
            return (
                f"topology mismatch: the chart was rendered for {expected} "
                f"hosts (KVEDGE_EXPECTED_PROCESSES) but the runtime config "
                f"declares [distributed] num_processes="
                f"{cfg.num_processes}; fix the config TOML"
            )
    cards_raw = os.environ.get(launch.CARDS_ENV, "")
    if not cards_raw:
        return ""
    try:
        cards = int(cards_raw)
    except ValueError:
        return f"{launch.CARDS_ENV}={cards_raw!r} is not an integer"
    visible = launch.visible_cards(cfg, device)
    if cards != visible:
        return (
            f"topology mismatch: the chart was rendered for {cards} cards "
            f"a host ({launch.CARDS_ENV}) but this pod sees {visible}; fix "
            "gpusPerHost or the pod's cards"
        )
    return ""


def _booting() -> DeviceCheckResult:
    """The pre-payload state served while boot work is still in flight."""
    return DeviceCheckResult(
        ok=False, platform="booting", device_count=0, device_kinds=(),
        mesh_axes=(), mesh_shape=(), probe_ms=0.0, probe_checksum=0.0,
        error="boot in progress (multi-host join / payload not finished)",
    )


def _payload_check(base: DeviceCheckResult, result) -> DeviceCheckResult:
    """A train or eval ``PayloadResult`` as the check boot reports: its
    time and loss, or its error."""
    if not result.ok:
        return dataclasses.replace(base, ok=False, error=result.error)
    return dataclasses.replace(base, probe_ms=result.elapsed_ms,
                               probe_checksum=result.loss)


def _run_payload(cfg: RuntimeConfig, handle: "RuntimeHandle", device=None,
                 dtype: str = "bfloat16", seed: int = 0, params=None
                 ) -> DeviceCheckResult:
    if cfg.payload == "none":
        return DeviceCheckResult(
            ok=True, platform="skipped", device_count=0, device_kinds=(),
            mesh_axes=(), mesh_shape=(), probe_ms=0.0, probe_checksum=0.0,
        )
    try:
        if cfg.payload == "transformer-probe":
            from kvedge_torch.runtime import probes

            return probes.run_transformer_probe(cfg, device, dtype)
        if cfg.payload == "inference-probe":
            from kvedge_torch.runtime import probes

            return probes.run_inference_probe(cfg, device, dtype)
        if cfg.payload in ("train", "eval"):
            from kvedge_torch.runtime import train

            base = run_device_check(cfg, device)
            if not base.ok:
                return base
            run = (train.run_train_payload if cfg.payload == "train"
                   else train.run_eval_payload)
            handle.result = run(cfg, device=device, dtype=dtype, check=base)
            return _payload_check(base, handle.result)
        if cfg.payload == "serve":
            from kvedge_torch.runtime import serve

            check, serve_fn = serve.run_serve_payload(
                cfg, device, dtype, seed, params=params)
            handle.serve_fn = serve_fn
            return check
        return run_device_check(cfg, device)
    except Exception as e:
        return _degraded(f"payload {cfg.payload!r} failed: {e!r}")


def _boot_world(cfg: RuntimeConfig, handle: RuntimeHandle, device,
                dtype: str, seed: int, params) -> DeviceCheckResult:
    """The boot work after the status server is up (module doc): the
    topology and config checks, the cards and the mesh over them, the
    local ranks and the join, the payload. Returns the runtime's
    check; ``handle`` gets the joined state and the local world."""
    try:
        topo_error = _topology_mismatch(cfg, device)
        if topo_error:
            return _degraded(topo_error)
        # A config built in code skipped the parser: what it refuses
        # (serve over a stage axis, ...) degrades the runtime here, with
        # the same message; so does a mesh the pods' cards cannot hold.
        cfg.validate()
        cards = launch.visible_cards(cfg, device)
        cfg.check_world(cfg.num_processes * cards)
        if params is not None and cards > 1:
            raise RuntimeConfigError(
                "weights given in code reach local rank 0 only; a pod of "
                f"{cards} cards serves a checkpoint or the seeded init")
    except (RuntimeConfigError, RuntimeError) as e:  # or no card at all
        return _degraded(str(e))
    # Join the world BEFORE the payload, so the payload's mesh spans it.
    # A failed join degrades the pod (status stays queryable) instead of
    # crash-looping it.
    try:
        if cards == 1:  # one rank a pod: the pods' world, if any
            handle.distributed = maybe_initialize(cfg.distributed,
                                                  device=device)
        else:
            handle.distributed, handle.local = launch.join_world(
                cfg, cards, device, dtype, seed)
    except launch.LocalRankFailed as e:
        return _degraded(str(e))
    except Exception as e:
        return _degraded(f"multi-host join failed "
                         f"(num_processes={cfg.num_processes}): {e!r}")
    if handle.local is None:
        return _run_payload(cfg, handle, device, dtype, seed, params)

    def rank_failed(why: str) -> None:
        # /healthz turns 503 within a poll of a local rank's exit, even
        # while this rank still waits in a collective with it.
        if handle.check.ok or handle.check.platform == "booting":
            handle.check = _degraded(why)

    handle.local.watch(rank_failed)
    check = _run_payload(cfg, handle, device, dtype, seed, params)
    why = handle.local.failure()
    if not check.ok or why is not None:
        # The world is of no use without every rank: free the cards.
        handle.local.close(grace_s=0.0)
        return check if not check.ok else _degraded(why)
    return check


def start_runtime(cfg: RuntimeConfig, device=None, dtype: str = "bfloat16",
                  seed: int = 0, *, params=None) -> RuntimeHandle:
    """Start the status server, run the boot work, keep the heartbeat going.

    The status server starts FIRST, serving the ``booting`` state,
    because the boot work can take long (the serve payload restores,
    warms and captures its graphs): if the server only came up
    afterwards, kubelet's liveness probe (which targets /version) would
    kill and restart the pod mid-boot. ``device`` is the card unless
    "cpu" is asked for; ``dtype`` the payloads' compute dtype; ``seed``
    the serve payload's weights when there is no checkpoint, and
    ``params`` a numpy tree it serves instead of the checkpoint's
    (``serve.boot_serve`` boots through here).
    """
    started_at = time.time()
    boot_count = heartbeat.next_boot_count(cfg.state_dir)

    handle: RuntimeHandle = None  # assigned below; closures capture it

    # Every consumer (heartbeat, /healthz, /status) reads handle.check —
    # one source of truth, so a later update cannot leave the endpoints
    # disagreeing about health.
    def build_heartbeat() -> dict:
        return {
            "name": cfg.name,
            "ok": handle.check.ok,
            "payload": cfg.payload,
            "boot_count": boot_count,
            "check": handle.check.to_dict(),
        }

    writer = heartbeat.HeartbeatWriter(
        cfg.state_dir, cfg.heartbeat_interval_s, build_heartbeat
    )

    # The profiler must not run before boot completes: a capture touches
    # the device from the handler thread while the payload is still
    # building (and capturing) on it.
    boot_complete = threading.Event()

    def device_quiet():
        # The profiler's two toggles run with the serve payload's device
        # work held off (runtime/profiling.py).
        fn = getattr(handle.serve_fn, "device_quiet", None)
        return fn() if fn is not None else contextlib.nullcontext()

    trace_capture = TraceCapture(
        cfg.state_dir, device=device, quiet=device_quiet,
        max_seconds=SERVE_MAX_SECONDS if cfg.payload == "serve" else 60.0)

    def profile(seconds: float) -> dict:
        if not boot_complete.is_set():
            raise CaptureUnavailable(
                "runtime is still booting; retry once /status shows the "
                "payload check"
            )
        return trace_capture.capture(seconds)

    server = StatusServer(
        cfg.status_bind, cfg.status_port,
        snapshot=lambda: handle.snapshot(),
        profiler=profile,
        token=cfg.status_token,
        profile_traces=trace_capture.list,
        **serve_routes(cfg, lambda: handle.serve_fn, lambda: handle.check),
    )
    handle = RuntimeHandle(
        cfg=cfg, check=_booting(), writer=writer, server=server,
        boot_count=boot_count, started_at=started_at,
        trace_capture=trace_capture,
    )
    # Sweep atomic-write leftovers before anything writes to the state
    # dir: a SIGKILL mid-dump strands `<name>.tmp` (a prefix dump can be
    # hundreds of MB) and no other writer exists this early, so every
    # surviving tmp is garbage by definition.
    swept = recovery.sweep_stranded_tmp(cfg.state_dir)
    if swept:
        print(f"[kvedge-boot] swept {len(swept)} stranded tmp file(s) "
              f"from the state dir: {', '.join(swept)}", flush=True)
    writer.beat_once()  # heartbeat visible before the server answers
    server.start()

    handle.check = _boot_world(cfg, handle, device, dtype, seed, params)
    boot_complete.set()  # safe to profile from handler threads now
    writer.beat_once()  # refresh: the booting heartbeat is now stale
    return handle


def boot(config_path: str, once: bool = False, root: str = "/",
         device=None) -> None:
    """Entry for ``kvedge-runtime boot --config <path>``.

    ``root`` is accepted for signature symmetry with the other boot
    commands; paths inside the config were already rebased when
    ``kvedge-bootstrap apply`` wrote it.
    """
    del root
    with open(config_path, "r", encoding="utf-8") as fh:
        cfg = RuntimeConfig.parse(fh.read())
    handle = start_runtime(cfg, device=device)
    print(
        f"[kvedge-runtime] {cfg.name}: payload={cfg.payload} "
        f"ok={handle.check.ok} devices={handle.check.device_count} "
        f"status=:{handle.status_port} boot_count={handle.boot_count}",
        flush=True,
    )
    if not handle.check.ok:
        # Degraded: keep serving /status (debuggable from outside), but
        # say so loudly.
        print(f"[kvedge-runtime] DEGRADED: {handle.check.error}", flush=True)
    if once:
        handle.shutdown()
        return
    if threading.current_thread() is threading.main_thread():
        # A pod is stopped by SIGTERM: end the heartbeat loop so the
        # shutdown below runs (the serve payload closes its pool and
        # dumps its prefix registry) instead of dying mid-write.
        signal.signal(signal.SIGTERM, lambda *_: handle.writer.stop())
    try:
        handle.writer.run()  # heartbeat loop on the main thread
    finally:
        handle.shutdown()
