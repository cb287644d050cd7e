"""The port's HTTP surface: the reference's status server, its routes and
its Prometheus rendering.

The counterpart of the JAX package's ``kvedge_tpu/runtime/status.py``,
on one host. Routes:

* ``GET /healthz`` (200 ``{"status": "ok"}``, or 503 with the degraded
  detail the serve payload gives), ``GET /status`` (the runtime's
  snapshot, with the ``serving`` sub-document: the request counters and
  the paged server's stats), ``GET /metrics`` (that snapshot in
  Prometheus text format, :func:`render_metrics`, whose tables and
  rendering are the reference's below this docstring: the same
  ``kvedge_*`` names, types and HELP lines), ``GET /version``;
* ``GET /trace`` (the flight recorder as Chrome trace-event JSON),
  ``GET /slo`` (the SLO engine's document) and ``GET /debug/bundle``
  (the flight bundle), each a 404 naming its knob while that is off;
* ``POST /generate`` (the serve payload; a caller's ``X-Request-Id``
  rides in as ``"_request_id"`` and the response echoes the request id
  in its body and header);
* ``POST /profile?seconds=N`` (a ``torch.profiler`` capture into
  ``<state_dir>/traces/``, ``runtime/profiling.py``: 200 with its
  summary, 400 for a bad ``seconds``, 409 while another capture runs,
  503 while the runtime boots) and ``GET /profile/traces`` (the
  captures on disk) through the ``profiler`` and ``profile_traces`` the
  runtime wires (``runtime/boot.py``); without them both answer 503
  "profiler not available". ``GET /profile`` is a 405.

A non-empty ``token`` (``[status] token``) gates every POST route behind
``Authorization: Bearer <token>``, 401 otherwise; the GET surface is
read-only and never gated.
"""

from __future__ import annotations

import hmac
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlsplit

from kvedge_torch import __version__
from kvedge_torch.runtime.profiling import CaptureBusy, CaptureUnavailable


class GenerateUnavailable(RuntimeError):
    """Capacity or lifecycle refusal of ``POST /generate``: the client
    should retry (503), after ``retry_after_s`` when the refusal carried
    a hint."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# Request-body ceiling for POST /generate: a token grid is small, so
# anything bigger is refused before json.loads.
_MAX_GENERATE_BODY = 1 << 20

_METRIC_FIELDS = (
    # (snapshot key, metric suffix, help text)
    ("ok", "up", "1 if the runtime payload check passed"),
    ("boot_count", "boot_count", "boots observed on this state volume"),
    ("uptime_s", "uptime_seconds", "seconds since this runtime booted"),
    ("heartbeat_seq", "heartbeat_seq", "monotonic heartbeat sequence"),
    ("heartbeat_age_s", "heartbeat_age_seconds", "age of the last heartbeat"),
)

# Serving observability (the ``serving`` sub-document of /status, fed by
# the serve payload's request accounting + the paged server's pool
# stats). Counter buckets mirror the HTTP classes POST /generate answers
# with: rejected = 400, unavailable = 503, errors = 500.
_SERVE_METRIC_FIELDS = (
    # (serving key, metric suffix, TYPE, help text)
    ("requests_total", "serve_requests_total", "counter",
     "generate requests reaching the serving backend (transport-level "
     "400s — bad framing/JSON — are rejected before it)"),
    ("completed_total", "serve_completed_total", "counter",
     "generate requests completed"),
    ("rejected_total", "serve_rejected_total", "counter",
     "invalid generate requests (HTTP 400)"),
    ("unavailable_total", "serve_unavailable_total", "counter",
     "capacity-refused generate requests (HTTP 503)"),
    ("errors_total", "serve_errors_total", "counter",
     "failed generate requests (HTTP 500)"),
    ("tokens_generated_total", "serve_tokens_generated_total", "counter",
     "tokens generated for clients"),
    ("last_latency_ms", "serve_last_latency_ms", "gauge",
     "latency of the most recently completed request"),
    # _total, not _sum: Prometheus counters end in _total, and a bare
    # _sum suffix collides with the histogram exposition grammar (the
    # /metrics conformance test pins both rules).
    ("latency_ms_sum", "serve_latency_ms_total", "counter",
     "summed latency of completed requests in ms (divide by "
     "kvedge_serve_completed_total for the mean)"),
    # Paged backend only: live pool occupancy.
    ("in_flight", "serve_in_flight", "gauge",
     "requests currently decoding (paged backend)"),
    ("free_slots", "serve_free_slots", "gauge",
     "free decode slots (paged backend)"),
    ("free_pages", "serve_free_pages", "gauge",
     "unreferenced KV pages in the pool (paged backend)"),
    ("reserved_pages", "serve_reserved_pages", "gauge",
     "worst-case pages reserved by in-flight requests (paged backend)"),
    # Capacity semantics (SERVING.md rung 21): total pool size, the
    # compile bucket the device batch dim currently runs at, and the
    # free-page watermarks the scheduler's shed/resume decisions key on.
    ("pages_total", "serve_pages_total", "gauge",
     "total KV pages in the pool (paged backend; HBM-budget- or "
     "serving_pages-sized)"),
    ("slots_total", "serve_slots_total", "gauge",
     "configured decode slots — the bucket ladder's ceiling (paged "
     "backend)"),
    ("bucket", "serve_bucket", "gauge",
     "device batch rows currently compiled for — the active compile "
     "bucket (paged backend; equals slots when bucketing is off)"),
    ("bucket_min", "serve_bucket_min", "gauge",
     "smallest compile bucket (serving_min_bucket; 0 = bucketing off, "
     "batch dim pinned to slots)"),
    ("page_low_watermark", "serve_page_low_watermark", "gauge",
     "free-page fraction below which non-top-priority admissions shed "
     "(0 = off)"),
    ("page_high_watermark", "serve_page_high_watermark", "gauge",
     "free-page fraction swapped requests wait for before resuming "
     "(0 = off)"),
    ("prefix_entries", "serve_prefix_entries", "gauge",
     "registered prefix-cache entries (paged backend)"),
    ("prefix_hits", "serve_prefix_hits_total", "counter",
     "admissions that reused a cached prompt prefix (paged backend)"),
    ("prefix_tokens_saved", "serve_prefix_tokens_saved_total", "counter",
     "prompt tokens whose prefill was skipped via prefix sharing "
     "(paged backend)"),
    # Copy-on-write radix prefix cache (SERVING.md rung 24): hit rate
    # (hits / lookups), HBM bytes the sharing avoided recomputing, COW
    # divergence copies, and the tiered host residency gauges.
    ("prefix_lookups", "serve_prefix_lookups_total", "counter",
     "admission-time prefix-cache lookups — hit rate is "
     "serve_prefix_hits_total / this (paged backend)"),
    ("prefix_bytes_saved", "serve_prefix_bytes_saved_total", "counter",
     "KV-pool bytes the shared prefix pages avoided re-prefilling "
     "(tokens_saved x per-token page bytes; paged backend)"),
    ("prefix_cow_copies", "serve_prefix_cow_copies_total", "counter",
     "device-side copy-on-write page copies taken when an admission "
     "shared a partially-matching last page (paged backend)"),
    ("prefix_host_entries", "serve_prefix_host_entries", "gauge",
     "prefix entries resident in the host RAM tier "
     "(serving_prefix_host_mb; paged backend)"),
    ("prefix_host_bytes", "serve_prefix_host_bytes", "gauge",
     "host RAM bytes held by demoted prefix entries, counted against "
     "serving_prefix_host_mb (paged backend)"),
    ("prefix_demotions", "serve_prefix_demotions_total", "counter",
     "prefix entries demoted HBM -> host tier on eviction "
     "(paged backend)"),
    ("prefix_promotions", "serve_prefix_promotions_total", "counter",
     "host-resident prefix entries swapped back into HBM at an "
     "admission hit (paged backend)"),
    # Journal refcounts (rung 24c): shadow snapshots of shared prefix
    # bytes cited by (not duplicated into) checkpoint entries.
    ("journal_shadow_nodes", "serve_journal_shadow_nodes", "gauge",
     "shared-prefix shadow snapshots the journal holds — each backs "
     "one or more checkpoint entries by reference (paged backend)"),
    ("journal_shadow_bytes", "serve_journal_shadow_bytes", "gauge",
     "host RAM bytes held by shared-prefix shadow snapshots, counted "
     "ONCE against the journal budget however many entries cite them"),
    ("window", "serve_window", "gauge",
     "device decode window cap in steps (paged backend, "
     "serving_window)"),
    # Overlapped window pipeline (serving_overlap): whether the
    # double-buffered decode loop is active, how many windows it has
    # harvested, and whether one is in flight right now.
    ("overlap", "serve_overlap", "gauge",
     "1 if the overlapped (double-buffered) window pipeline is "
     "enabled (paged backend, serving_overlap)"),
    ("overlap_windows_total", "serve_overlap_windows_total", "counter",
     "decode windows harvested by the overlapped pipeline"),
    ("overlap_inflight_depth", "serve_overlap_inflight_depth", "gauge",
     "dispatched-but-unharvested windows right now (0 or 1 — the "
     "pipeline is double-buffered, never deeper)"),
    ("spec_passes", "serve_spec_passes_total", "counter",
     "speculative verify passes run (paged backend, "
     "serving_speculative > 0)"),
    ("spec_emitted_per_pass", "serve_spec_emitted_per_pass", "gauge",
     "mean greedy tokens emitted per verify pass — the realized "
     "speculative acceleration (paged backend)"),
    # Device-resident spec windows (SERVING.md rung 20): W draft+
    # verify passes per dispatch, so the host RTT amortizes over up to
    # W*(1+K) tokens instead of taxing every pass.
    ("spec_window", "serve_spec_window", "gauge",
     "speculative passes batched per device dispatch (paged backend, "
     "serving_spec_window > 0; absent = windows off)"),
    ("spec_windows_total", "serve_spec_windows_total", "counter",
     "device-resident speculative windows harvested (paged backend, "
     "serving_spec_window)"),
    # Device-resident endgame (SERVING.md rung 23): whether mixed
    # greedy+sampled batches stay on the windowed spec path, and how
    # many finishes the device-side stop detection completed.
    ("spec_window_sampled", "serve_spec_window_sampled", "gauge",
     "1 if sampled co-tenants ride the windowed spec path on device "
     "(serving_spec_sampled_window; 0 = mixed batches fall back to "
     "the legacy per-pass program)"),
    ("stop_finishes_total", "serve_stop_finishes_total", "counter",
     "requests finished by per-row stop-token detection inside the "
     "device scan (paged backend; stop_token set on the request)"),
    # Failure surface (runtime/failures.py): 1 once the pool has been
    # poisoned by a serving failure. With the recovery supervisor active
    # (runtime/recovery.py) this clears again after a successful heal —
    # alert on degraded AND NOT recovering for the reschedule signal.
    ("degraded", "serve_degraded", "gauge",
     "1 if the serving pool is poisoned/degraded (clears after an "
     "in-process recovery; without one, the pod should be rescheduled)"),
    # Recovery machine (runtime/recovery.py): attempt/outcome counters
    # plus the in-flight gauge /healthz keys its non-terminal 503 off.
    ("recovering", "serve_recovering", "gauge",
     "1 while the recovery supervisor is actively healing the pool "
     "(degrade is not terminal yet)"),
    ("recovery_attempts_total", "serve_recovery_attempts_total",
     "counter",
     "individual heal attempts (teardown + reformation + warm restart) "
     "the recovery supervisor has made"),
    ("recoveries_total", "serve_recoveries_total", "counter",
     "successful in-process recoveries (pool returned to healthy)"),
    ("recovery_failures_total", "serve_recovery_failures_total",
     "counter",
     "recoveries that escalated to the terminal path (attempt budget "
     "exhausted or crash-loop breaker tripped)"),
    ("last_recovery_s", "serve_last_recovery_seconds", "gauge",
     "wall-clock seconds the most recent successful recovery took "
     "(also the basis of the degraded-refusal retry-after hint)"),
    # SLO-aware admission scheduler (models/scheduler.py, SERVING.md
    # rung 17): per-class queue depth, the preemptive-swap ledger, and
    # the shed counter the overload watermarks drive.
    ("sched_queue_depth_interactive", "serve_sched_queue_depth_interactive",
     "gauge",
     "interactive-class requests parked in the admission queue "
     "(paged backend)"),
    ("sched_queue_depth_batch", "serve_sched_queue_depth_batch", "gauge",
     "batch-class requests parked in the admission queue "
     "(paged backend)"),
    ("sched_swapped_out", "serve_sched_swapped_out", "gauge",
     "preempted requests whose KV pages currently live in host RAM "
     "awaiting resume (paged backend)"),
    ("sched_swap_bytes_host", "serve_sched_swap_bytes_host", "gauge",
     "host RAM bytes held by swapped-out KV snapshots, counted "
     "against serving_sched_swap_budget_mb (paged backend)"),
    ("sched_preemptions_total", "serve_sched_preemptions_total",
     "counter",
     "requests preempted (KV swapped to host) to admit a "
     "higher-class request (paged backend)"),
    ("sched_resumes_total", "serve_sched_resumes_total", "counter",
     "preempted requests swapped back in and resumed — matches "
     "preemptions at idle unless a failure dropped the swap set "
     "(paged backend)"),
    ("sched_shed_total", "serve_sched_shed_total", "counter",
     "requests rejected early by the overload watermarks "
     "(serving_sched_max_queue_depth / _wait_s) with a measured "
     "retry-after hint (paged backend)"),
    # Durability (models/serving.py + runtime/journal.py, SERVING.md
    # rung 22): boundary-checkpoint journal occupancy and the restores
    # revive()/reformation performed — the coverage story for
    # in-flight requests (paged backend, serving_checkpoint_every).
    ("checkpoint_every", "serve_checkpoint_every", "gauge",
     "configured checkpoint cadence in quiescent boundaries "
     "(0 = durability off; paged backend)"),
    ("journal_entries", "serve_journal_entries", "gauge",
     "live requests with a resumable checkpoint in the host-side "
     "journal (paged backend, serving_checkpoint_every)"),
    ("journal_bytes", "serve_journal_bytes", "gauge",
     "host RAM bytes held by journaled checkpoints (KV snapshots + "
     "token logs), counted against the journal budget"),
    ("checkpoints_total", "serve_checkpoints_total", "counter",
     "per-request boundary checkpoints taken since boot"),
    ("checkpoint_skipped_total", "serve_checkpoint_skipped_total",
     "counter",
     "checkpoints refused by the journal byte budget — those "
     "requests degrade to fail-and-retry on the next outage"),
    ("checkpoint_unchanged_total", "serve_checkpoint_unchanged_total",
     "counter",
     "checkpoints delta-skipped at a boundary because the request's "
     "standing journal entry already matched (gen_len, next_token) — "
     "zero device work spent re-serializing identical state "
     "(SERVING.md rung 26)"),
    ("journal_restores_total", "serve_journal_restores_total",
     "counter",
     "journaled in-flight requests re-admitted by revive()/"
     "reformation (direct slot restores + swap-set re-queues)"),
    # Online window controller (runtime/autotune.py, SERVING.md rung
    # 26, serving_window=auto): the per-boundary pick and its EWMA
    # inputs. Present only when the controller is on.
    ("autotune_window", "serve_autotune_window", "gauge",
     "decode window the online controller currently picks — the "
     "smallest power of two with window*t >= R (paged backend, "
     "serving_window=auto)"),
    ("autotune_r_ms", "serve_autotune_r_ms", "gauge",
     "EWMA host turnaround per window (dispatch+harvest bookkeeping "
     "the device window must hide), the controller's R input"),
    ("autotune_t_ms", "serve_autotune_t_ms", "gauge",
     "EWMA per-step device time, the controller's t input"),
    ("autotune_updates", "serve_autotune_updates_total", "counter",
     "harvested windows the controller has learned from"),
    # Request-scoped tracing (runtime/tracing.py, [payload]
    # serving_trace): flight-recorder occupancy and loss. Present only
    # while tracing is enabled.
    ("trace_events", "serve_trace_events", "gauge",
     "trace events currently held in the flight-recorder ring "
     "(paged backend, serving_trace)"),
    ("trace_events_total", "serve_trace_events_total", "counter",
     "trace events recorded since boot (paged backend, "
     "serving_trace)"),
    ("trace_dropped_total", "serve_trace_dropped_total", "counter",
     "trace events that fell off the bounded flight-recorder ring "
     "(paged backend, serving_trace)"),
    ("trace_sample", "serve_trace_sample", "gauge",
     "per-request trace sampling rate in (0, 1] (paged backend, "
     "serving_trace)"),
    # Completion counters (SERVING.md rung 25): normal finishes and
    # the tokens they realized — the goodput numerator.
    ("requests_done_total", "serve_requests_done_total", "counter",
     "requests that finished normally (cancels and failures "
     "excluded; paged backend)"),
    ("tokens_done_total", "serve_tokens_done_total", "counter",
     "generated tokens realized by normally-finished requests "
     "(paged backend)"),
    # SLO engine (runtime/slo.py, [payload] serving_slo): rolling
    # fast-window SLIs and the fast/slow error-budget burn rates.
    # Present only while the engine is on; 0.0 = window not yet
    # filled (the series must exist for recording rules).
    ("slo_ttft_p99_ms", "serve_slo_ttft_p99_ms", "gauge",
     "rolling fast-window TTFT p99 in ms (serving_slo)"),
    ("slo_itl_p99_ms", "serve_slo_itl_p99_ms", "gauge",
     "rolling fast-window per-request mean inter-token gap p99 in ms "
     "(serving_slo)"),
    ("slo_queue_p99_ms", "serve_slo_queue_p99_ms", "gauge",
     "rolling fast-window admission queue-wait p99 in ms "
     "(serving_slo)"),
    ("slo_goodput_tps", "serve_slo_goodput_tps", "gauge",
     "rolling fast-window goodput in generated tokens/s from "
     "normally-finished requests (serving_slo)"),
    ("slo_shed_rate", "serve_slo_shed_rate", "gauge",
     "rolling fast-window shed fraction: shed / (shed + done) "
     "(serving_slo)"),
    ("slo_burn_fast", "serve_slo_burn_fast", "gauge",
     "fast-window error-budget burn rate: worst bad-event fraction "
     "/ (1 - serving_slo_target); 1.0 = budget spent at exactly "
     "sustainable pace"),
    ("slo_burn_slow", "serve_slo_burn_slow", "gauge",
     "slow-window error-budget burn rate (the multi-window alert's "
     "is-it-real half)"),
    ("slo_alert", "serve_slo_alert", "gauge",
     "1 while BOTH burn windows exceed the alert thresholds "
     "(14x fast / 6x slow — the page condition, and the burn-gated "
     "shed input when serving_slo_shed is on)"),
    ("slo_snapshots_total", "serve_slo_snapshots_total", "counter",
     "boundary snapshots accepted into the SLO ring (serving_slo)"),
    ("slo_resets_total", "serve_slo_resets_total", "counter",
     "SLO ring rebases after a counter reset (pool replaced — plain "
     "revive() preserves counters and does not reset)"),
    # Occupancy timeline ring (runtime/slo.py OccupancyRing,
    # [payload] serving_occupancy_ring): the LATEST quiescent-boundary
    # sample, flattened; the full timeline exports as Chrome counter
    # tracks in GET /trace and the flight bundle's tail.
    ("occupancy_samples_total", "serve_occupancy_samples_total",
     "counter",
     "occupancy samples taken at quiescent boundaries "
     "(serving_occupancy_ring)"),
    ("occupancy_pages_total", "serve_occupancy_pages_total", "gauge",
     "pool pages at the last occupancy sample"),
    ("occupancy_pages_live", "serve_occupancy_pages_live", "gauge",
     "referenced (live) pool pages at the last occupancy sample"),
    ("occupancy_pages_free", "serve_occupancy_pages_free", "gauge",
     "free-list pages at the last occupancy sample"),
    ("occupancy_hbm_bytes_used", "serve_occupancy_hbm_bytes_used",
     "gauge",
     "HBM bytes held by live KV pages at the last occupancy sample "
     "(live pages x per-page pool bytes incl. int8 scales)"),
    ("occupancy_bucket", "serve_occupancy_bucket", "gauge",
     "active compile bucket at the last occupancy sample"),
    ("occupancy_slots_admitted", "serve_occupancy_slots_admitted",
     "gauge",
     "slots with admitted page tables at the last occupancy sample"),
    ("occupancy_slots_active", "serve_occupancy_slots_active", "gauge",
     "slots actively decoding at the last occupancy sample"),
    ("occupancy_reserved_pages", "serve_occupancy_reserved_pages",
     "gauge",
     "worst-case reserved pages at the last occupancy sample"),
    ("occupancy_prefix_entries", "serve_occupancy_prefix_entries",
     "gauge",
     "HBM-resident prefix-cache entries at the last occupancy sample"),
    ("occupancy_prefix_host_bytes",
     "serve_occupancy_prefix_host_bytes", "gauge",
     "host-tier prefix bytes at the last occupancy sample"),
    ("occupancy_journal_bytes", "serve_occupancy_journal_bytes",
     "gauge",
     "journal bytes at the last occupancy sample"),
    ("occupancy_queue_depth", "serve_occupancy_queue_depth", "gauge",
     "parked admission tickets at the last occupancy sample"),
)

# Latency histograms from the serving path (models/scheduler.py _Hist
# snapshots: {"edges", "counts", "sum", "count"} with per-bucket
# counts — cumulated into Prometheus ``le`` buckets here, at render
# time). The window_* series come from the overlapped decode loop, the
# sched_* series from the admission scheduler's per-class queue-wait
# tracking.
_SERVE_HISTOGRAM_FIELDS = (
    # (serving key, metric suffix, help text)
    ("window_dispatch_harvest_ms", "serve_window_dispatch_harvest_ms",
     "per-window dispatch-to-harvest wall time in ms (the device "
     "execution + host-device RTT leg the pipeline overlaps)"),
    ("window_host_ms", "serve_window_host_ms",
     "per-window host processing time in ms (emission, stops, "
     "bookkeeping — the work hidden under the next window)"),
    ("window_inflight_depth", "serve_window_inflight_depth",
     "pipeline depth observed at each window dispatch (0 = boundary "
     "dispatch, 1 = overlapped dispatch)"),
    ("spec_window_emitted_tokens", "serve_spec_window_emitted_tokens",
     "tokens a request realized from one device-resident speculative "
     "window (serving_spec_window; low buckets mean drafts are not "
     "landing and the window is mostly frozen passes)"),
    ("sched_queue_wait_ms_interactive",
     "serve_sched_queue_wait_ms_interactive",
     "admission queue wait in ms for interactive-class requests "
     "(enqueue to admit; swap residency is tracked separately)"),
    ("sched_queue_wait_ms_batch", "serve_sched_queue_wait_ms_batch",
     "admission queue wait in ms for batch-class requests "
     "(enqueue to admit; swap residency is tracked separately)"),
    ("sched_swap_residency_ms_interactive",
     "serve_sched_swap_residency_ms_interactive",
     "time preempted interactive-class requests spent swapped out to "
     "host RAM in ms (swap-out to resume)"),
    ("sched_swap_residency_ms_batch",
     "serve_sched_swap_residency_ms_batch",
     "time preempted batch-class requests spent swapped out to "
     "host RAM in ms (swap-out to resume)"),
    # Per-stage request latency split (models/serving.py, SERVING.md
    # rung 18): submit->first-token, the queue leg, and the decode leg.
    # Always on — fed from the same span boundaries tracing uses, but
    # independent of the serving_trace knob.
    ("ttft_ms", "serve_ttft_ms",
     "time to first token in ms (submit to the first emitted token, "
     "queue wait + prefill included)"),
    ("queue_ms", "serve_queue_ms",
     "admission queue wait in ms (submit to slot admission — the "
     "queue leg of the TTFT split)"),
    ("decode_ms", "serve_decode_ms",
     "admission-to-completion time in ms (the prefill + decode leg "
     "of the latency split)"),
    # Device-time attribution (SERVING.md rung 25): the device-side
    # slice of the dispatch->harvest window, timed around the forcing
    # read at each sync point. serve_window_host_ms is its host
    # complement; together they split serve_window_dispatch_harvest_ms.
    ("window_device_ms", "serve_device_ms_window",
     "device-side time per window in ms (dispatch to the forcing "
     "harvest read; the host bookkeeping half is "
     "serve_window_host_ms)"),
    ("itl_ms", "serve_itl_ms",
     "per-request mean inter-token gap in ms (first token to finish "
     "over generated tokens - 1; observed once per normal finish)"),
)


def _render_histogram(lines: list, name: str, help_text: str,
                      hist: dict) -> None:
    edges = hist.get("edges") or []
    counts = hist.get("counts") or []
    if len(counts) != len(edges) + 1:
        return  # malformed snapshot; skip rather than lie
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    cum = 0
    for edge, count in zip(edges, counts):
        cum += count
        lines.append(f'{name}_bucket{{le="{edge:g}"}} {cum}')
    cum += counts[-1]
    lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
    lines.append(f"{name}_sum {hist.get('sum', 0)}")
    lines.append(f"{name}_count {hist.get('count', 0)}")


def render_metrics(snapshot: dict) -> str:
    """Render a /status snapshot as Prometheus text exposition format."""
    lines = []
    for key, suffix, help_text in _METRIC_FIELDS:
        value = snapshot.get(key)
        if isinstance(value, bool):
            value = int(value)
        if value is None:
            continue
        name = f"kvedge_{suffix}"
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    check = snapshot.get("check", {})
    if check.get("probe_ms") is not None:
        lines.append("# HELP kvedge_probe_ms payload probe duration")
        lines.append("# TYPE kvedge_probe_ms gauge")
        lines.append(f"kvedge_probe_ms {check['probe_ms']}")
    if check.get("device_count") is not None:
        lines.append("# HELP kvedge_devices visible accelerator devices")
        lines.append("# TYPE kvedge_devices gauge")
        lines.append(f"kvedge_devices {check['device_count']}")
    progress = snapshot.get("train_progress") or {}
    if progress.get("step") is not None:
        lines.append("# HELP kvedge_train_step last completed training step")
        lines.append("# TYPE kvedge_train_step gauge")
        lines.append(f"kvedge_train_step {progress['step']}")
    if progress.get("target_steps") is not None:
        lines.append("# HELP kvedge_train_target_steps training step target")
        lines.append("# TYPE kvedge_train_target_steps gauge")
        lines.append(f"kvedge_train_target_steps {progress['target_steps']}")
    if progress.get("loss") is not None:
        lines.append("# HELP kvedge_train_loss last training loss")
        lines.append("# TYPE kvedge_train_loss gauge")
        lines.append(f"kvedge_train_loss {progress['loss']}")
    if progress.get("ts") is not None:
        # Staleness signal: the progress file persists across pod
        # generations by design, so consumers need the write time to
        # tell a live run from one that finished long ago.
        lines.append("# HELP kvedge_train_progress_ts unix time of the "
                     "last training-progress write")
        lines.append("# TYPE kvedge_train_progress_ts gauge")
        lines.append(f"kvedge_train_progress_ts {progress['ts']}")
    serving = snapshot.get("serving") or {}
    for key, suffix, mtype, help_text in _SERVE_METRIC_FIELDS:
        value = serving.get(key)
        if value is None:
            continue
        name = f"kvedge_{suffix}"
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value}")
    # Labelled counter (the one non-scalar serving metric): spec-window
    # fallbacks by cause. "sampled" must pin to 0 in mixed steady state
    # once serving_spec_sampled_window is on — that is rung 23's
    # acceptance gate, so the cause label is load-bearing, not garnish.
    fallbacks = serving.get("spec_window_fallbacks")
    if isinstance(fallbacks, dict) and fallbacks:
        name = "kvedge_serve_spec_window_fallbacks_total"
        lines.append(
            f"# HELP {name} decode rounds that fell off the windowed "
            "spec path, by cause (sampled = mixed batch with "
            "serving_spec_sampled_window off; spec_off = speculation "
            "disabled mid-flight; overlap_off = serial loop with "
            "spec windows configured)")
        lines.append(f"# TYPE {name} counter")
        for cause in sorted(fallbacks):
            lines.append(
                f'{name}{{cause="{cause}"}} {fallbacks[cause]}')
    # Prefix-cache evictions by cause (rung 24): admission = LRU sweep
    # to fit an arrival; pressure = mid-decode pool-relief callback;
    # revive = post-poison scrub (device bytes untrusted, never
    # demoted); host_lru / host_over = host-tier budget evictions.
    evictions = serving.get("prefix_evictions")
    if isinstance(evictions, dict) and evictions:
        name = "kvedge_serve_prefix_evictions_total"
        lines.append(
            f"# HELP {name} prefix-cache entries evicted from their "
            "tier, by cause (admission/pressure/revive = HBM "
            "entries; host_lru/host_over = host-tier records)")
        lines.append(f"# TYPE {name} counter")
        for cause in sorted(evictions):
            lines.append(
                f'{name}{{cause="{cause}"}} {evictions[cause]}')
    # Per-op broadcast attribution (rung 25): the slice transport's
    # cumulative frame count and milliseconds by op kind ({op:
    # [frames, ms]}). OP_MULTI frames show up under their own label,
    # so coalescing wins read directly as fewer frames per step.
    op_ms = serving.get("slice_op_ms")
    if isinstance(op_ms, dict) and op_ms:
        frames_name = "kvedge_serve_device_broadcast_frames_total"
        ms_name = "kvedge_serve_device_ms_broadcast_total"
        lines.append(
            f"# HELP {frames_name} control-plane broadcast frames "
            "sent to the slice pool, by op kind (multi = coalesced "
            "OP_MULTI envelopes)")
        lines.append(f"# TYPE {frames_name} counter")
        for op in sorted(op_ms):
            cell = op_ms[op]
            lines.append(f'{frames_name}{{op="{op}"}} {cell[0]}')
        lines.append(
            f"# HELP {ms_name} cumulative milliseconds spent inside "
            "slice broadcasts (send + per-shard run + gather), by op "
            "kind")
        lines.append(f"# TYPE {ms_name} counter")
        for op in sorted(op_ms):
            cell = op_ms[op]
            lines.append(f'{ms_name}{{op="{op}"}} {cell[1]:.3f}')
    for key, suffix, help_text in _SERVE_HISTOGRAM_FIELDS:
        hist = serving.get(key)
        if isinstance(hist, dict):
            _render_histogram(lines, f"kvedge_{suffix}", help_text, hist)
    return "\n".join(lines) + "\n"


class StatusServer:
    """Threaded HTTP server over the routes in the module docstring.

    ``snapshot`` supplies the /status document; ``healthy`` is a cheap,
    lock-free check for /healthz and ``health_detail`` the body of an
    unhealthy answer; ``generator`` answers ``POST /generate`` (a
    ``ValueError`` is a 400, :class:`GenerateUnavailable` a 503, anything
    else a 500; a result with ``"_stream"`` streams newline-delimited
    JSON); ``trace_doc``, ``slo_doc`` and ``bundle_doc`` answer their
    routes, None meaning the feature is off (404); ``profiler(seconds)``
    answers ``POST /profile`` and ``profile_traces`` ``GET
    /profile/traces``. ``token`` gates POST.
    """

    def __init__(self, bind: str, port: int, snapshot: Callable[[], dict],
                 healthy: Callable[[], bool] | None = None,
                 profiler: Callable[[float], dict] | None = None,
                 token: str = "",
                 generator: Callable[[dict], dict] | None = None,
                 health_detail: Callable[[], dict | None] | None = None,
                 trace_doc: Callable[[], dict | None] | None = None,
                 profile_traces: Callable[[], list] | None = None,
                 slo_doc: Callable[[], dict | None] | None = None,
                 bundle_doc: Callable[[], dict | None] | None = None):
        outer = self
        self._snapshot = snapshot
        self._healthy = healthy or (
            lambda: bool(snapshot().get("ok", False)))
        self._health_detail = health_detail
        self._profiler = profiler
        self._profile_traces = profile_traces
        self._token = token
        self._generator = generator
        # The documents that exist only while their feature is on: the
        # route's callable (None, or returning None: off) and the 404's
        # pointer at the knob.
        optional = {
            "/trace": (trace_doc,
                       "tracing is off — enable [payload] serving_trace "
                       "(on, or a sample rate in (0, 1])"),
            "/slo": (slo_doc,
                     "SLO engine is off — enable [payload] serving_slo "
                     "= true"),
            "/debug/bundle": (bundle_doc,
                              "flight recorder is off — enable [payload] "
                              "serving_bundle = true"),
        }

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # keep the server quiet
                pass

            def _send(self, code: int, doc: dict,
                      extra_headers: dict | None = None) -> None:
                body = json.dumps(doc, sort_keys=True).encode()
                self._send_raw(code, body, "application/json", extra_headers)

            def _send_raw(self, code: int, body: bytes, ctype: str,
                          extra_headers: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (extra_headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlsplit(self.path).path
                if path == "/metrics":
                    self._send_raw(200,
                                   render_metrics(outer._snapshot()).encode(),
                                   "text/plain; version=0.0.4")
                elif path == "/healthz":
                    healthy = outer._healthy()
                    doc = {"status": "ok" if healthy else "degraded"}
                    if not healthy and outer._health_detail is not None:
                        try:
                            doc.update(outer._health_detail() or {})
                        except Exception:
                            pass  # detail is best-effort; 503 already says it
                    self._send(200 if healthy else 503, doc)
                elif path == "/status":
                    self._send(200, outer._snapshot())
                elif path == "/version":
                    self._send(200, {"version": __version__})
                elif path in optional:
                    fn, knob = optional[path]
                    doc = fn() if fn is not None else None
                    if doc is None:
                        self._send(404, {"error": knob})
                    else:
                        self._send(200, doc)
                elif path == "/profile/traces":
                    if outer._profile_traces is None:
                        self._send(503, {"error": "profiler not available"})
                    else:
                        self._send(200,
                                   {"traces": outer._profile_traces()})
                elif path == "/profile":
                    self._send(405, {
                        "error": "use POST /profile?seconds=N to capture"})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _authorized(self) -> bool:
                """Bearer-token check for POST routes: constant-time,
                compared as bytes (a non-ASCII header gets a 401, not a
                dead handler); an unset token leaves POST open."""
                if not outer._token:
                    return True
                auth = self.headers.get("Authorization", "")
                scheme, _, presented = auth.partition(" ")
                return scheme.lower() == "bearer" and hmac.compare_digest(
                    presented.strip().encode("utf-8", "surrogateescape"),
                    outer._token.encode("utf-8"))

            def do_POST(self):
                url = urlsplit(self.path)
                path = url.path
                if path not in ("/profile", "/generate"):
                    self._send(404, {"error": f"no route {path}"})
                    return
                if not self._authorized():
                    self._send(
                        401, {"error": f"POST {path} requires "
                                       "Authorization: Bearer <status "
                                       "token>"},
                        extra_headers={"WWW-Authenticate": "Bearer"})
                    return
                if path == "/generate":
                    self._handle_generate()
                    return
                if outer._profiler is None:
                    self._send(503, {"error": "profiler not available"})
                    return
                try:
                    seconds = float(
                        parse_qs(url.query).get("seconds", ["3"])[0])
                except ValueError:
                    self._send(400, {"error": "seconds must be a number"})
                    return
                try:
                    self._send(200, outer._profiler(seconds))
                except CaptureBusy as e:
                    self._send(409, {"error": str(e)})
                except CaptureUnavailable as e:
                    self._send(503, {"error": str(e)})
                except Exception as e:  # capture failed; stay serving
                    self._send(500, {"error": f"capture failed: {e!r}"})

            def _handle_generate(self):
                if outer._generator is None:
                    self._send(503, {"error": "no generation backend "
                                              "(boot the 'serve' payload)"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = 0
                if not 0 < length <= _MAX_GENERATE_BODY:
                    self._send(400, {"error": "POST /generate needs a JSON "
                                     f"body (1..{_MAX_GENERATE_BODY} bytes)"})
                    return
                try:
                    doc = json.loads(self.rfile.read(length))
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    self._send(400, {"error": f"invalid JSON body: {e}"})
                    return
                if not isinstance(doc, dict):
                    self._send(400, {"error": "body must be a JSON object"})
                    return
                # A caller's request id rides in as "_request_id"; the
                # serve payload cleans it (or mints one) and echoes it.
                rid_in = self.headers.get("X-Request-Id")
                if rid_in:
                    doc.setdefault("_request_id", rid_in)
                try:
                    result = outer._generator(doc)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                except GenerateUnavailable as e:
                    body = {"error": str(e)}
                    if e.retry_after_s is not None:
                        body["retry_after_s"] = e.retry_after_s
                    self._send(503, body)
                    return
                except Exception as e:  # generation failed; stay serving
                    self._send(500, {"error": f"generate failed: {e!r}"})
                    return
                rid_out = result.get("request_id")
                rid_headers = ({"X-Request-Id": str(rid_out)} if rid_out
                               else None)
                stream = result.get("_stream")
                if stream is None:
                    self._send(200, result, extra_headers=rid_headers)
                    return
                # ndjson, one record a token, the end of the body
                # delimited by the connection closing; a failure after the
                # 200 is a final error record.
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                for name, value in (rid_headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.close_connection = True
                try:
                    for item in stream:
                        self.wfile.write((json.dumps(item) + "\n").encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # The client is gone: closing the stream cancels its
                    # rows, or detaches them for a reconnect.
                    stream.close()
                except Exception as e:  # reported in-band, stay serving
                    err = {"error": f"generate failed: {e!r}"}
                    row = getattr(e, "stream_row", None)
                    if row is not None:
                        err["row"] = row
                    try:
                        self.wfile.write((json.dumps(err) + "\n").encode())
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer((bind, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="kvedge-torch-http",
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._server.server_port

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=30)
