"""The ``serve`` payload: ``POST /generate`` over the paged server or the
contiguous backend.

The counterpart of the JAX package's ``run_serve_payload`` /
``_build_serve`` (``runtime/workload.py``) and of the ``/generate``
route of its status server, on one host. ``[payload] serving = "paged"``
serves through the continuous-batching server over one page pool (its
``serving_overlap`` knob picks the decode loop); ``""`` or
``"contiguous"`` decodes one request at a time through
``models/decode.generate``, all its rows as one batch (or, for a
one-row greedy request with ``"speculative": K``, through
``models/speculative.generate_speculative``), and refuses ``stream``,
``priority`` and ``deadline_ms`` as the reference does. On the paged
backend ``priority`` (a class of the scheduler's, ``interactive`` by
default) and ``deadline_ms`` go to the server's admission scheduler,
which the ``serving_sched_*`` and ``serving_page_*_watermark`` knobs
set, beside the prefix cache (``serving_prefix_cache``,
``serving_prefix_host_mb``; with ``serving_prefix_persist`` and a
state directory its registry reloads from
``<state_dir>/prefix-cache.npz`` at boot and is dumped there every 30 s
and after shutdown) and the bucketed batch (``serving_min_bucket``);
the pool holds ``serving_pages`` pages, or as many as
``serving_hbm_budget_mb`` buys. A decode failure poisons the paged pool
(``runtime/failures.py``): it writes ``<state_dir>/last-failure.json``
and, with ``serving_recovery_attempts`` > 0 (2 by default), the recovery
supervisor (``runtime/recovery.py``) revives the pool in place, with the
requests ``serving_checkpoint_every`` journaled resumed; meanwhile
``/healthz`` answers 503 with ``recovering: true`` and a retry hint,
and after escalation (or with no supervisor) with ``terminal: true``;
a poisoned pool refuses ``/generate`` with a 503 carrying
``retry_after_s``. The paged
backend speculates server-wide instead (``serving_speculative``,
``serving_spec_window``, ``serving_spec_sampled_window``): a draft
length > 0 runs the boot probe (``resolve_speculation``), which turns
speculation off under "auto" when plain windows beat its best case. The
request contract is the reference's::

    {"tokens": [[int, ...], ...], "n_new": int,
     "temperature": float = 0, "top_p": float = 1, "seed": int = 0,
     "speculative": int = 0}
    -> {"tokens": [[prompt + generated], ...], "n_new": N,
        "restored_step": step | null}
       (+ "accepted_per_step": the mean tokens a verify pass emitted,
        for a speculative request)

On the paged backend each row of a request is its own request into the
shared page pool, submitted concurrently so rows (and other clients'
rows) ride the same batched decode window, with the request's
``priority`` and ``deadline_ms``. Token ids wrap modulo the
vocabulary. Sampling (``temperature > 0``) is seeded: row r's key is
``fold_in(PRNGKey(seed), r)``, so the same request returns the same
tokens. Errors map as the reference's: 400 for a malformed body or an
unknown priority class, 503 when capacity does not free up, when the
scheduler sheds the request (the refusal's text, with its retry hint),
when the pool is poisoned (a retryable failure; ``retry_after_s`` in the
body) or when the server is closing, 500 for a failure. ``"stream": true`` answers newline-delimited JSON instead: one
``{"row": r, "token": t}`` record per token as it lands, rows
interleaved, then ``{"done": true, "tokens": ..., "n_new": N,
"restored_step": null}``; a failure after the 200 is a final
``{"error": ...}`` record, and a client that disconnects cancels its
rows.

Every response carries ``request_id``: the caller's ``X-Request-Id``
(``"_request_id"`` in the body), cleaned, or one minted here; it keys
the request's spans in the flight recorder (``serving_trace``). With
``serving_checkpoint_every`` > 0 on the paged backend a delivery log
(``_ResumeLog``) keeps each request's tokens: a client that disconnects
DETACHES instead of cancelling, and a ``POST /generate`` body with
``"emitted_offset"`` (an int, or one per row) and the original request
id reconnects, buffered or streamed, to exactly the tokens past its
offsets (``resumed_at`` names them), across a poison and revive too; an
unknown or evicted id is a 400, and so is ``emitted_offset`` with
checkpoints off. The request counters (``requests_total``, completed,
rejected = 400, unavailable = 503, errors = 500, tokens, latency) join
the server's and the supervisor's stats under ``/status``'s
``serving`` and in ``/metrics``; ``serving_trace``, ``serving_slo`` and
``serving_bundle`` turn on ``GET /trace``, ``GET /slo`` and ``GET
/debug/bundle`` (each a 404 while off), and at a poison
``last-failure.json`` carries the recorder's tail and, with the bundle
on, ``flight-bundle.json`` lands beside it. ``serving_window = "auto"``,
``serving_occupancy_ring`` and ``serving_debug_locks`` reach the
server; ``[status] token`` gates the POST routes.

In a world of more than one rank (several pods, or one pod's local
ranks, ``parallel/launch.py``) the payload is
the reference's leader-serves: every rank holds its ``[mesh]`` slices of
the same weights (heads over ``model``, whole layers over ``stage``,
whole experts over ``expert``); global rank 0 serves, over a
``runtime/sliceserve.SlicePagedKVCache`` whose device ops every rank
replays (paged) or by relaying each request to every rank's
sharded ``generate`` (contiguous); local rank 0 of the other
pods answers 503 naming the leader, and a pod's other local ranks
follow the leader's stream on their main thread (:func:`_join_slice`,
:func:`follow_slice`).

``ServeRuntime`` builds the data path (device check, weights, the
server); :func:`run_serve_payload` is the ``serve`` payload the runtime
boots (``runtime/boot.py``): the device check against the config, a
``ServeRuntime``, one self-check generation, and the ``serve_fn`` the
runtime's status server routes ``POST /generate`` through.
:func:`boot_serve` boots that runtime: ``start_runtime`` with a
``serve`` payload on a given port, which starts the status server,
writes the heartbeats (with this boot's ``boot_count``), runs the
payload and serves ``/profile``; it returns the payload's
``ServeRuntime``, with ``http`` the runtime's status server and
``handle`` its ``RuntimeHandle``. ``python -m
kvedge_torch serve`` (``cli.py``) and ``kvedge-runtime boot`` run it
until stopped. The weights are the params of the latest
checkpoint that ``train`` wrote under the state directory
(``restored_step`` in every response names its step), as the
reference's serve restores them, or else the seeded numpy init.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import queue
import threading
import time

import numpy as np

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.sampling import as_key_tensor, fold_in, prng_key
from kvedge_torch.models.speculative import generate_speculative
from kvedge_torch.models.serving import (
    PagedGenerationServer,
    ServerBusy,
    ServerClosed,
)
from kvedge_torch.models.transformer import torch_dtype
from kvedge_torch.models.weights import params_from_numpy, sharded_params
from kvedge_torch.parallel.distributed import world_size
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.runtime import heartbeat
from kvedge_torch.runtime.config import (
    RuntimeConfigError,
    ServeConfig,
    _spec_draft_len,
)
from kvedge_torch.runtime.devicecheck import (
    DeviceCheckResult,
    resolve_device,
    run_device_check,
)
from kvedge_torch.runtime.failures import ServingFailure
from kvedge_torch.runtime.recovery import (
    RecoveryPolicy,
    RecoverySupervisor,
)
from kvedge_torch.runtime.slo import SloObjectives
from kvedge_torch.runtime.status import GenerateUnavailable
from kvedge_torch.runtime.tracing import (
    Tracer,
    clean_request_id,
    new_request_id,
)
from kvedge_torch.runtime.train import restore_latest_params


def _serving_page_bytes(cfg: ServeConfig, tcfg: TransformerConfig) -> int:
    """Device bytes ONE pool page costs: the K and V slabs of every
    layer (``[n_layers, page_size, kv_heads, d_head]`` each) at the
    pool's dtype, plus the two fp32 scale slabs of an int8 pool; what
    ``PagedKVCache`` allocates a page, the reference's arithmetic."""
    itemsize = (1 if cfg.serving_kv_dtype == "int8"
                else torch_dtype(tcfg.dtype).itemsize)
    row = tcfg.n_layers * cfg.serving_page_size * tcfg.kv_heads
    per_page = row * tcfg.d_head * itemsize * 2  # K + V
    if cfg.serving_kv_dtype == "int8":
        per_page += row * 4 * 2  # fp32 scale_k + scale_v
    return per_page


def _serving_pool_dims(cfg: ServeConfig, tcfg: TransformerConfig
                       ) -> tuple[int, int, int, int]:
    """``(slots, pages, page_size, max_pages_per_seq)``, the reference's
    derivation, so both packages admit the same traffic. ``serving_pages
    = 0`` sizes the pool so every slot can hold a max_seq request plus
    the draft slack a verify pass writes past a greedy request's budget.
    ``serving_hbm_budget_mb`` sizes it from a byte budget instead: the
    pages the budget buys at :func:`_serving_page_bytes`, floored; fewer
    than ``slots`` worst-case requests is deliberate oversubscription
    (admission waits on pages), fewer than ONE fails here. The port's
    pool holds one page more than these, the sink non-live rows write
    to, so it takes one page's bytes past the budget."""
    slots, page_size = cfg.serving_slots, cfg.serving_page_size
    mpps = -(-(tcfg.max_seq + _spec_draft_len(cfg)) // page_size)
    if cfg.serving_hbm_budget_mb:
        pages = ((cfg.serving_hbm_budget_mb * 2**20)
                 // _serving_page_bytes(cfg, tcfg))
        if pages < mpps:
            raise RuntimeConfigError(
                f"serving_hbm_budget_mb = {cfg.serving_hbm_budget_mb} "
                f"buys {pages} pages, but one worst-case request needs "
                f"{mpps} (max_seq {tcfg.max_seq} + draft slack at page "
                f"size {page_size}); raise the budget or shrink max_seq"
            )
    else:
        pages = cfg.serving_pages or slots * mpps
    return slots, pages, page_size, mpps


def _serve_max_rows(cfg: ServeConfig, tcfg: TransformerConfig) -> int:
    """Row ceiling of one request: 4 waves of the pool's worst-case
    concurrency (the full-length requests the pages hold at once,
    capped at the slots)."""
    slots, pages, _, mpps = _serving_pool_dims(cfg, tcfg)
    return 4 * max(1, min(slots, pages // mpps))


def _parse_generate_request(doc: dict, tcfg, *, max_rows: int, paged: bool):
    """Validate a ``POST /generate`` body (a copy of the reference's
    parser, same rules and messages). Returns ``(tokens, n_new,
    temperature, top_p, seed, stream, spec, priority, deadline_ms)``;
    raises ``ValueError`` (the HTTP 400) for anything malformed."""
    tokens = doc.get("tokens")
    if (not isinstance(tokens, list) or not tokens
            or not all(isinstance(r, list) and r for r in tokens)):
        raise ValueError(
            "body must carry 'tokens': a non-empty list of "
            "non-empty token-id rows"
        )
    if len({len(r) for r in tokens}) != 1:
        raise ValueError("all token rows must have equal length")
    if len(tokens) > max_rows:
        raise ValueError(
            f"request carries {len(tokens)} token rows > the "
            f"runtime's ceiling of {max_rows} (4 x the page pool's "
            "worst-case request capacity); split the request"
        )
    try:
        n_new = int(doc.get("n_new", 16))
    except (TypeError, ValueError):
        raise ValueError("'n_new' must be an integer") from None
    if not 1 <= n_new <= tcfg.max_seq:
        raise ValueError(f"'n_new' must be in [1, {tcfg.max_seq}]")
    if len(tokens[0]) + n_new > tcfg.max_seq:
        raise ValueError(
            f"prompt ({len(tokens[0])}) + n_new ({n_new}) exceeds "
            f"the model's max_seq ({tcfg.max_seq})"
        )
    if not all(isinstance(t, int) and not isinstance(t, bool)
               for row in tokens for t in row):
        raise ValueError("token rows must contain integers")
    raw_t = doc.get("temperature", 0.0)
    raw_p = doc.get("top_p", 1.0)
    raw_seed = doc.get("seed", 0)
    if (not isinstance(raw_t, (int, float)) or isinstance(raw_t, bool)
            or not isinstance(raw_p, (int, float)) or isinstance(raw_p, bool)
            or not isinstance(raw_seed, int) or isinstance(raw_seed, bool)):
        raise ValueError(
            "'temperature'/'top_p' must be numbers and 'seed' an integer"
        )
    temperature, top_p, seed = float(raw_t), float(raw_p), raw_seed
    stream = doc.get("stream", False)
    if not isinstance(stream, bool):
        raise ValueError("'stream' must be a boolean")
    if stream and not paged:
        raise ValueError(
            "'stream' requires [payload] serving = \"paged\" — "
            "the contiguous backend decodes the whole request as "
            "one compiled program, so there is nothing to stream"
        )
    if temperature < 0.0:
        raise ValueError("'temperature' must be >= 0")
    if not 0.0 < top_p <= 1.0:
        raise ValueError("'top_p' must be in (0, 1]")
    spec = doc.get("speculative", 0)
    if (not isinstance(spec, int) or isinstance(spec, bool)
            or not 0 <= spec <= 16):
        raise ValueError(
            "'speculative' must be an integer draft length in "
            "[0, 16] (0 = off)"
        )
    if spec:
        if stream:
            raise ValueError("'speculative' does not compose with 'stream'")
        if paged:
            raise ValueError(
                "per-request 'speculative' runs on the contiguous "
                "backend; the paged backend speculates server-wide "
                "via [payload] serving_speculative (the batch-level "
                "schedule is a server policy, not a request knob)"
            )
        if len(tokens) != 1:
            raise ValueError("'speculative' supports exactly one token row")
        if temperature > 0.0:
            raise ValueError(
                "'speculative' is greedy-only (temperature 0): "
                "drafts verify against the argmax"
            )
    priority = doc.get("priority", "interactive")
    if not isinstance(priority, str) or not priority:
        raise ValueError(
            "'priority' must be a non-empty class name "
            "(e.g. 'interactive' or 'batch')"
        )
    deadline_ms = doc.get("deadline_ms")
    if deadline_ms is not None and (
            not isinstance(deadline_ms, int)
            or isinstance(deadline_ms, bool) or deadline_ms < 1):
        raise ValueError("'deadline_ms' must be a positive integer")
    if not paged and ("priority" in doc or deadline_ms is not None):
        raise ValueError(
            "'priority'/'deadline_ms' require [payload] serving = "
            "\"paged\" — the contiguous backend runs one request at a "
            "time with no admission queue to schedule"
        )
    return (tokens, n_new, temperature, top_p, seed, stream, spec,
            priority, deadline_ms)


def row_key_data(seed: int, row: int) -> np.ndarray:
    """Raw key data of row ``row``'s seed key: ``fold_in(PRNGKey(seed),
    row)``, uint32 ``[2]``."""
    key = fold_in(as_key_tensor(prng_key(seed)), row)
    return key.numpy().astype(np.uint32)


class _ServeCounters:
    """The serve payload's request accounting, the reference's counter
    vocabulary and outcome buckets: ``ValueError`` -> rejected (400),
    :class:`GenerateUnavailable` and retryable serving failures ->
    unavailable (503), anything else -> errors (500)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.data = {
            "requests_total": 0,
            "completed_total": 0,
            "rejected_total": 0,
            "unavailable_total": 0,
            "errors_total": 0,
            "tokens_generated_total": 0,
            "last_latency_ms": 0.0,
            "latency_ms_sum": 0.0,
        }

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.data[key] += n

    def count_outcome(self, exc: Exception) -> None:
        if isinstance(exc, GenerateUnavailable) or (
                isinstance(exc, ServingFailure) and exc.retryable):
            self.count("unavailable_total")
        elif isinstance(exc, ValueError):
            self.count("rejected_total")
        else:
            self.count("errors_total")

    def finish(self, start: float) -> None:
        ms = (time.perf_counter() - start) * 1000.0
        with self._lock:
            self.data["completed_total"] += 1
            self.data["last_latency_ms"] = ms
            self.data["latency_ms_sum"] += ms

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.data)


class _ResumeLog:
    """The delivery log behind client reconnects (the reference's): every
    generated token the serve path hands a request's consumer, keyed by
    request id, so a client that lost its connection reconnects with its
    ``X-Request-Id`` and an ``emitted_offset`` and gets exactly the tokens
    it has not seen, whether the request still decodes, waits in the
    journal across a revive, or finished. The ``max_entries`` most
    recently opened requests are kept; an evicted id is unknown. Pumps
    write and reconnects read under one condition."""

    def __init__(self, max_entries: int = 64):
        self.cond = threading.Condition()
        self.max_entries = int(max_entries)
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def open(self, rid: str, n_rows: int, n_new: int) -> dict:
        """Register ``rid``, replacing any earlier use of the id."""
        with self.cond:
            rec = {"rows": [[] for _ in range(n_rows)], "live": n_rows,
                   "n_new": n_new, "done": False, "error": None}
            self._entries.pop(rid, None)
            self._entries[rid] = rec
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            return rec

    def get(self, rid: str) -> dict | None:
        with self.cond:
            return self._entries.get(rid)

    def append(self, rid: str, row: int, token: int) -> None:
        with self.cond:
            rec = self._entries.get(rid)
            if rec is not None:
                rec["rows"][row].append(token)
                self.cond.notify_all()

    def row_done(self, rid: str) -> None:
        """One row finished; the record is done when all rows are."""
        with self.cond:
            rec = self._entries.get(rid)
            if rec is not None:
                rec["live"] -= 1
                if rec["live"] <= 0:
                    rec["done"] = True
                self.cond.notify_all()

    def finish(self, rid: str, error: Exception | None = None) -> None:
        """Mark ``rid`` complete (the first error recorded wins)."""
        with self.cond:
            rec = self._entries.get(rid)
            if rec is not None:
                if error is not None and rec["error"] is None:
                    rec["error"] = error
                rec["done"] = True
                self.cond.notify_all()


@dataclasses.dataclass
class _Leader:
    """What a multi-process ``serve`` hands the leader's runtime: this
    rank's mesh and weight slices, the restored step, and the transport
    to the followers (a :class:`~kvedge_torch.runtime.sliceserve.
    SlicePagedKVCache` for the paged backend, a :class:`_ContiguousRelay`
    for the contiguous one)."""

    mesh: object
    weights: dict
    restored_step: int | None
    cache: object = None
    relay: object = None


class _ContiguousRelay:
    """The contiguous leader-serves protocol, the reference's: per
    request a fixed-shape header ``ints = [op, rows, prompt_len, n_new,
    sampled, seed]``, ``floats = [temperature, top_p]`` (op 0 = stop),
    then the ``[rows, prompt_len]`` token rows; every rank then runs the
    same model-sharded ``generate``. Requests serialize on the leader's
    one-request lock, so every rank issues its collectives in the same
    order."""

    def __init__(self, plane):
        self.plane = plane
        self.stopped = False

    @staticmethod
    def zero_header():
        return np.zeros(6, np.int64), np.zeros(2, np.float32)

    def send(self, rows: np.ndarray, n_new: int, temperature: float,
             top_p: float, seed: int) -> tuple:
        """Broadcast one request; returns it as the followers received
        it (:meth:`received`), which the leader decodes from too."""
        ints = np.array([1, rows.shape[0], rows.shape[1], n_new,
                         int(temperature > 0.0), seed], np.int64)
        ints, floats = self.plane.bcast(
            (ints, np.array([temperature, top_p], np.float32)))
        return self.received(ints, floats, self.plane.bcast(
            np.ascontiguousarray(rows, np.int64)))

    @staticmethod
    def received(ints, floats, rows) -> tuple:
        """``(rows, n_new, temperature, top_p, seed)`` of a header and
        its rows."""
        return (rows, int(ints[3]), float(floats[0]), float(floats[1]),
                int(ints[5]))

    def stop(self) -> None:
        if not self.stopped:
            self.stopped = True
            self.plane.bcast(self.zero_header())


def _generate_rows(weights, tcfg, device, mesh, rows, n_new: int,
                   temperature: float, top_p: float, seed: int):
    """``generate`` over ``rows`` (on every rank of a multi-process
    contiguous serve, on its slices), row r sampling with
    ``fold_in(PRNGKey(seed), r)`` when ``temperature > 0``."""
    sampled = temperature > 0.0
    sampling = None
    if sampled:
        keys = np.stack([row_key_data(seed, i) for i in range(len(rows))])
        sampling = (keys, temperature, top_p)
    return generate(weights, rows, tcfg, n_new, sampling=sampling,
                    sampled=sampled, device=device, mesh=mesh)


class ServeRuntime:
    """The serving data path: device check, weights, the paged server
    (``server``; None on the contiguous backend) and ``serve_fn``.

    ``device`` is the card unless "cpu" is asked for; ``params`` is a
    numpy param tree (the reference's layout) or None for the latest
    checkpoint's params, or weights made from ``seed`` when there is no
    checkpoint; ``dtype`` is the compute dtype. ``supervisor`` is the
    paged pool's :class:`RecoverySupervisor` (None with
    ``serving_recovery_attempts = 0`` or the contiguous backend); its
    warm restart re-restores the params served, copied in place.
    ``tracer`` is the flight recorder (None with ``serving_trace`` off)
    and ``resume_log`` the reconnect log (None unless checkpoints are on
    on the paged backend). ``http`` and ``handle`` are the status
    server and :class:`~kvedge_torch.runtime.boot.RuntimeHandle` of a
    runtime that :func:`boot_serve` booted, else None. ``leader`` makes
    it the leader (rank 0) of a multi-process ``serve``
    (:func:`run_serve_payload`): its weights are the rank's slices, and
    its device work reaches the followers through the slice cache or the
    contiguous relay.
    """

    def __init__(self, cfg: ServeConfig, *, device=None,
                 dtype: str = "bfloat16", seed: int = 0, params=None,
                 device_check: DeviceCheckResult | None = None,
                 leader: _Leader | None = None):
        self.device = resolve_device(device)
        self.device_check = (device_check if device_check is not None
                             else run_device_check(device=self.device))
        if not self.device_check.ok:
            raise RuntimeError(f"device check failed: "
                               f"{self.device_check.error}")
        self.cfg = cfg
        self.tcfg = cfg.model_config(dtype, self.device)
        self.started_at = time.time()
        self.restored_step = None
        self.leader = leader
        self.mesh = NO_MESH if leader is None else leader.mesh
        given = params
        if leader is not None:
            self.restored_step, self.weights = (leader.restored_step,
                                                leader.weights)
        else:
            if params is None:
                self.restored_step, params = restore_latest_params(
                    cfg, self.tcfg, seed)
            self.weights = params_from_numpy(params, self.tcfg, self.device)
        slots, pages, page_size, _ = _serving_pool_dims(cfg, self.tcfg)
        self.max_rows = _serve_max_rows(cfg, self.tcfg)
        self.paged = cfg.payload_serving == "paged"
        self.server = None
        self.supervisor = None
        self.spec_decision = None
        # One flight recorder for the pool, shared with its scheduler and
        # the supervisor; None is the off state.
        self.tracer = Tracer.from_knob(cfg.serving_trace) if self.paged \
            else None
        self.resume_log = None
        self._counters = _ServeCounters()
        # The prefix registry's file and the fingerprint of the weights
        # its K/V belong to (None: persistence off).
        self.prefix_path = None
        self.prefix_fingerprint = None
        # The boot-time load: {"entries": n, "seconds": s}.
        self.prefix_load = None
        spec_draft = _spec_draft_len(cfg)
        # The contiguous backend decodes one request at a time.
        self._generate_lock = threading.Lock()
        self._closed = False
        if self.paged:
            slo = None
            if cfg.serving_slo:
                slo = SloObjectives(
                    target=cfg.serving_slo_target,
                    ttft_ms=cfg.serving_slo_ttft_ms,
                    itl_ms=cfg.serving_slo_itl_ms,
                    queue_ms=cfg.serving_slo_queue_ms,
                    fast_window_s=cfg.serving_slo_fast_s,
                    slow_window_s=cfg.serving_slo_slow_s)
            self.server = PagedGenerationServer(
                self.weights, self.tcfg, slots=slots, pages=pages,
                page_size=page_size,
                prefill_chunk=cfg.serving_prefill_chunk,
                prefix_cache=cfg.serving_prefix_cache,
                prefix_host_mb=cfg.serving_prefix_host_mb,
                window=cfg.serving_window,
                window_min=cfg.serving_window_min,
                window_max=cfg.serving_window_max,
                kv_dtype=cfg.serving_kv_dtype,
                overlap=cfg.serving_overlap, device=self.device,
                sched_policy=cfg.serving_sched_policy,
                sched_weights=cfg.sched_weights_dict(),
                sched_max_queue_depth=cfg.serving_sched_max_queue_depth,
                sched_max_queue_wait_s=cfg.serving_sched_max_queue_wait_s,
                sched_swap_budget_mb=cfg.serving_sched_swap_budget_mb,
                page_low_watermark=cfg.serving_page_low_watermark,
                page_high_watermark=cfg.serving_page_high_watermark,
                speculative=spec_draft,
                spec_window=(cfg.serving_spec_window if spec_draft > 0
                             else 0),
                spec_sampled_window=cfg.serving_spec_sampled_window,
                min_bucket=cfg.serving_min_bucket,
                retry_after_s=cfg.serving_retry_after_s,
                checkpoint_every=cfg.serving_checkpoint_every,
                debug_pages=cfg.serving_debug_pages,
                tracer=self.tracer,
                debug_locks=cfg.serving_debug_locks,
                slo=slo, slo_shed=cfg.serving_slo_shed,
                occupancy_ring=cfg.serving_occupancy_ring,
                cache=None if leader is None else leader.cache,
            )
            if cfg.state_dir:
                self.server.on_degraded = self._record_failure
            if spec_draft > 0 and leader is not None:
                # The boot probe's ops would enter the slice's op stream
                # before the traffic: "auto" resolves unmeasured to
                # windows, an explicit K runs speculation (the
                # reference's rule on a slice).
                if cfg.serving_speculative == "auto":
                    self.spec_decision = self.server.disable_speculation(
                        "auto unmeasured on a slice")
                else:
                    self.spec_decision = {
                        "mode": f"speculative K={spec_draft} (unmeasured "
                                "on a slice)", "windows_dominate": None}
                print(f"[kvedge-serve] speculative mode: "
                      f"{self.spec_decision['mode']}", flush=True)
            elif spec_draft > 0:
                # Measure this card's verify pass and window before
                # traffic: "auto" turns speculation off when windows beat
                # its best case, an explicit K keeps it with a warning.
                self.spec_decision = self.server.resolve_speculation(
                    auto=cfg.serving_speculative == "auto")
                print(f"[kvedge-serve] speculative mode: "
                      f"{self.spec_decision['mode']} (best-case "
                      f"{self.spec_decision['spec_best_tokens_per_sec']}/s "
                      f"vs windowed "
                      f"{self.spec_decision['windowed_tokens_per_sec']}/s "
                      f"per slot)", flush=True)
            if (cfg.serving_prefix_persist and cfg.serving_prefix_cache
                    and cfg.state_dir and leader is None):
                # Single-host only: a slice cache refuses the dump.
                self._start_prefix_persistence()
            if cfg.serving_recovery_attempts > 0:
                # Chained after the failure record: a poison is recorded,
                # then healed, and escalates to the terminal 503 only when
                # the attempts or the crash-loop breaker say so.
                tcfg = self.tcfg

                def restore_params():
                    tree = (given if given is not None else
                            restore_latest_params(cfg, tcfg, seed)[1])
                    return params_from_numpy(tree, tcfg, "cpu")

                # A slice's warm restart keeps its params: a restore is
                # the whole slice's work, not the supervisor's thread's.

                self.supervisor = RecoverySupervisor(
                    self.server,
                    policy=RecoveryPolicy(
                        max_attempts=cfg.serving_recovery_attempts),
                    state_dir=cfg.state_dir,
                    prefix_path=self.prefix_path or "",
                    prefix_fingerprint=self.prefix_fingerprint or "",
                    restore_params=(restore_params if leader is None
                                    else None),
                ).attach()
            if cfg.serving_checkpoint_every > 0:
                # Reconnects only where a disconnect can detach: with
                # checkpoints off a disconnect still cancels its rows.
                self.resume_log = _ResumeLog()
        # Rows submit together on a bounded pool (2 x slots workers):
        # excess rows queue here instead of spawning threads.
        self._rows = concurrent.futures.ThreadPoolExecutor(
            max_workers=2 * slots, thread_name_prefix="kvedge-torch-row")
        self.http = None
        self.handle = None

    def _start_prefix_persistence(self) -> None:
        """Re-pin the previous run's prefix registry, then dump it every
        30 s while it changes (the reference's wiring and fingerprint:
        the checkpoint step and the model's geometry and dtype; an MoE
        model's adds its experts and top-k, so a dense file at the same
        step is stale for it)."""
        t = self.tcfg
        self.prefix_path = os.path.join(self.cfg.state_dir,
                                        "prefix-cache.npz")
        self.prefix_fingerprint = (
            f"step={self.restored_step} {t.vocab}v {t.d_model}d "
            f"{t.n_heads}h {t.kv_heads}kv {t.n_layers}L {t.d_ff}ff "
            f"{t.max_seq}T {t.dtype}")
        if t.n_experts > 0:
            self.prefix_fingerprint += f" {t.n_experts}e{t.expert_top_k}k"
        t0 = time.perf_counter()
        n = self.server.load_prefix_cache(self.prefix_path,
                                          self.prefix_fingerprint)
        self.prefix_load = {"entries": n,
                            "seconds": time.perf_counter() - t0}
        if n:
            print(f"[kvedge-serve] re-pinned {n} prefix-cache entries "
                  f"from {self.prefix_path}", flush=True)
        self.server.start_prefix_persistence(
            self.prefix_path, self.prefix_fingerprint, interval=30.0)

    def _record_failure(self, reason, failure) -> None:
        """The paged pool's ``on_degraded`` observer: the post-mortem
        ``<state_dir>/last-failure.json``, which outlives the pod, with
        the flight recorder's tail when tracing is on; with
        ``serving_bundle``, the flight bundle beside it, best effort (a
        bundle that fails never masks the record)."""
        record = {
            "payload": "serve", "backend": "paged",
            "type": type(failure).__name__, "reason": reason,
            "retryable": bool(getattr(failure, "retryable", False)),
        }
        if self.tracer is not None:
            record["trace"] = self.tracer.last_events()
        heartbeat.write_failure_record(self.cfg.state_dir, record)
        if self.cfg.serving_bundle:
            try:
                heartbeat.write_flight_bundle(self.cfg.state_dir,
                                              self.server.flight_bundle())
            except Exception as e:
                print(f"[kvedge-serve] flight bundle not written: {e!r}",
                      flush=True)

    @property
    def port(self) -> int:
        return self.http.port

    def stats(self) -> dict:
        """The ``serving`` document: the request counters, the backend,
        and on the paged one the server's and the supervisor's stats."""
        out = self._counters.snapshot()
        out["backend"] = "paged" if self.paged else "contiguous"
        if self.leader is not None:
            out["backend"] = "multihost-" + out["backend"]
            out["processes"] = world_size()
        if self.server is not None:
            out.update(self.server.stats())
        if self.supervisor is not None:
            out.update(self.supervisor.stats())
        if self.prefix_load is not None:
            out["prefix_load"] = dict(self.prefix_load)
        return out

    def payload_fn(self):
        """``serve_fn`` as the ``serve`` payload hands it to the runtime,
        carrying what its HTTP layer reads lock-free: ``stats``,
        ``tracer``, ``degraded``, ``capacity`` (paged), ``slo`` and
        ``bundle`` (None while their knob is off), ``recovery`` (with a
        supervisor) and ``close``; and the port's ``device_quiet`` (the
        profiler's toggles run under it) and ``runtime``, this
        runtime."""
        def serve_fn(doc: dict) -> dict:
            return self.serve_fn(doc)

        server, cfg = self.server, self.cfg
        serve_fn.runtime = self
        serve_fn.stats = self.stats
        serve_fn.tracer = self.tracer
        serve_fn.degraded = ((lambda: server.degraded) if server is not None
                             else (lambda: None))
        if server is not None:
            serve_fn.capacity = server.capacity_probe
        serve_fn.slo = (server.slo_doc
                        if server is not None and cfg.serving_slo else None)
        serve_fn.bundle = (server.flight_bundle
                           if server is not None and cfg.serving_bundle
                           else None)
        if self.supervisor is not None:
            serve_fn.recovery = self.supervisor.health
        serve_fn.close = self.close
        serve_fn.device_quiet = self.device_quiet
        return serve_fn

    def device_quiet(self):
        """A context manager under which this runtime launches no device
        work: the paged server's work lock, or the contiguous backend's
        one-request lock."""
        if self.server is not None:
            return self.server.device_quiet()
        return self._generate_lock

    @property
    def healthy(self) -> bool:
        if self.server is not None:
            return self.server.healthy
        return not self._closed

    def serve_fn(self, doc: dict) -> dict:
        """One ``POST /generate`` body -> the response document, or for
        ``"stream": true`` a document whose ``"_stream"`` iterates the
        newline-delimited JSON records (one ``{"row": r, "token": t}``
        per token, then ``{"done": true, ...}``). Counted: every call is
        a request, its outcome lands in one bucket, and a streamed one
        completes when its last record went out."""
        self._counters.count("requests_total")
        start = time.perf_counter()
        try:
            result = self._serve(doc)
        except Exception as e:
            self._counters.count_outcome(e)
            raise
        stream = result.get("_stream")
        if stream is None:
            self._counters.count("tokens_generated_total",
                                 result["n_new"] * len(result["tokens"]))
            self._counters.finish(start)
            return result
        counters = self._counters

        def counted():
            try:
                for item in stream:
                    if "token" in item:
                        counters.count("tokens_generated_total")
                    yield item
            except GeneratorExit:
                # The client is gone: the inner stream cancels (or
                # detaches) its rows; no completion is recorded.
                stream.close()
                raise
            except Exception as e:
                counters.count_outcome(e)
                raise
            counters.finish(start)

        return {**result, "_stream": counted()}

    def _serve(self, doc: dict) -> dict:
        if "emitted_offset" in doc:
            # A reconnect, not a new request: the original submission
            # pinned every other field.
            if self.resume_log is None:
                raise ValueError(
                    "'emitted_offset' reconnect requires the paged "
                    "backend with [payload] serving_checkpoint_every > 0")
            return self._resume(doc)
        (tokens, n_new, temperature, top_p, seed, stream, spec, priority,
         deadline_ms) = _parse_generate_request(
            doc, self.tcfg, max_rows=self.max_rows, paged=self.paged)
        # The caller's id, cleaned, or one minted here (so programmatic
        # callers get one too): echoed in every response.
        rid = clean_request_id(doc.get("_request_id")) or new_request_id()
        if not self.paged:
            out = self._serve_contiguous(tokens, n_new, temperature, top_p,
                                         seed, spec)
            out["request_id"] = rid
            return out
        timeout = 120.0
        prompts = [[t % self.tcfg.vocab for t in row] for row in tokens]

        def row_sampling(i: int):
            if temperature <= 0.0:
                return None
            return (row_key_data(seed, i), temperature, top_p)

        if stream:
            return {"_stream": self._stream(prompts, n_new, timeout,
                                            row_sampling, priority,
                                            deadline_ms, rid),
                    "request_id": rid}
        rows: list = [None] * len(prompts)

        def one_row(i: int) -> None:
            rows[i] = self.server.submit(prompts[i], n_new, timeout=timeout,
                                         sampling=row_sampling(i),
                                         priority=priority,
                                         deadline_ms=deadline_ms,
                                         request_id=rid)

        log = self.resume_log
        # A buffered request registers too: its submitter waits through a
        # revive, so a client whose connection died re-asks with
        # emitted_offset 0 and collects the tokens.
        if log is not None:
            log.open(rid, len(prompts), n_new)
        try:
            self._fan_out(len(prompts), one_row)
        except Exception as e:
            if log is not None:
                log.finish(rid, error=e)
            raise
        if log is not None:
            for i, row in enumerate(rows):
                for token in row[len(prompts[i]):]:
                    log.append(rid, i, token)
            log.finish(rid)
        return {"tokens": rows, "n_new": n_new,
                "restored_step": self.restored_step, "request_id": rid}

    def _resume(self, doc: dict) -> dict:
        """The reconnect: the original request id and ``emitted_offset``
        (an int, or one per row) re-attach to an issued request and
        deliver exactly the tokens past the offsets, from the delivery
        log its pumps keep feeding while the client is away. Buffered, it
        waits the request out; streamed, it drains the log and follows it
        live. Nothing new is submitted."""
        log = self.resume_log
        rid = clean_request_id(doc.get("_request_id"))
        if not rid:
            raise ValueError("reconnect needs the original request id "
                             "(X-Request-Id header or '_request_id')")
        rec = log.get(rid)
        if rec is None:
            raise ValueError(
                f"unknown or expired request id {rid!r}: nothing to "
                f"resume (the delivery log keeps the {log.max_entries} "
                "most recent requests)")
        n_rows = len(rec["rows"])
        raw = doc.get("emitted_offset")
        offs = raw if isinstance(raw, list) else [raw] * n_rows
        if (len(offs) != n_rows
                or not all(isinstance(o, int) and not isinstance(o, bool)
                           and 0 <= o <= rec["n_new"] for o in offs)):
            raise ValueError(
                "'emitted_offset' must be an integer (or one per row, "
                f"{n_rows} here) in [0, n_new={rec['n_new']}] — the count "
                "of generated tokens already received for the row")
        stream = doc.get("stream", False)
        if not isinstance(stream, bool):
            raise ValueError("'stream' must be a boolean")
        if not stream:
            with log.cond:
                while not rec["done"]:
                    log.cond.wait()
                if rec["error"] is not None:
                    raise rec["error"]
                suffix = [list(row[o:]) for row, o in zip(rec["rows"], offs)]
            return {"tokens": suffix, "n_new": rec["n_new"],
                    "restored_step": self.restored_step,
                    "request_id": rid, "resumed_at": list(offs)}
        restored_step = self.restored_step

        def replay():
            # Tokens are read under the log's condition and yielded
            # outside it: the HTTP write never holds the pumps back.
            cursor = list(offs)
            while True:
                out = []
                with log.cond:
                    while True:
                        for i in range(n_rows):
                            row = rec["rows"][i]
                            if cursor[i] < len(row):
                                out.extend((i, t) for t in row[cursor[i]:])
                                cursor[i] = len(row)
                        if out or rec["done"]:
                            done, err = rec["done"], rec["error"]
                            break
                        log.cond.wait()
                for i, t in out:
                    yield {"row": i, "token": t}
                if done:
                    if err is not None:
                        raise err
                    yield {"done": True,
                           "tokens": [list(r[o:]) for r, o
                                      in zip(rec["rows"], offs)],
                           "n_new": rec["n_new"],
                           "restored_step": restored_step,
                           "request_id": rid, "resumed_at": list(offs)}
                    return

        return {"_stream": replay(), "request_id": rid}

    def _serve_contiguous(self, tokens, n_new: int, temperature: float,
                          top_p: float, seed: int, spec: int) -> dict:
        """One request through ``generate``: its rows as one batch, row r
        sampling with ``fold_in(PRNGKey(seed), r)`` when ``temperature >
        0``; with ``spec`` (one greedy row, as the parser guarantees),
        through ``generate_speculative`` at draft length ``spec``."""
        prompt = [[t % self.tcfg.vocab for t in row] for row in tokens]
        relay = None if self.leader is None else self.leader.relay
        if spec and relay is not None:
            raise ValueError(
                "'speculative' is not supported on a multi-host serve "
                "deployment (single-host contiguous only)")
        if spec:
            with self._generate_lock:
                if self._closed:
                    raise GenerateUnavailable("server is shut down")
                out, rate = generate_speculative(
                    self.weights, prompt, self.tcfg, n_new, draft_len=spec,
                    device=self.device)
                # locklint: allow[device-sync-under-lock] the copy is device work, which this lock (device_quiet) holds off while the profiler toggles
                out = out.cpu()
            rows = out.tolist()
            # The mean tokens emitted per verify pass (1.0 = speculation
            # never paid; spec + 1 = every draft accepted).
            return {"tokens": rows, "n_new": n_new,
                    "restored_step": self.restored_step,
                    "accepted_per_step": round(rate, 3)}
        request = (prompt, n_new, temperature, top_p, seed)
        with self._generate_lock:
            if self._closed:
                raise GenerateUnavailable("server is shut down")
            if relay is not None:
                # Every rank runs the same generate on its slices, from
                # the request as the followers received it.
                request = relay.send(np.asarray(prompt, np.int64),
                                     *request[1:])
            out = _generate_rows(self.weights, self.tcfg, self.device,
                                 self.mesh, *request)
            # locklint: allow[device-sync-under-lock] the copy is device work, which this lock (device_quiet) holds off while the profiler toggles
            out = out.cpu()
        rows = out.tolist()
        return {"tokens": rows, "n_new": n_new,
                "restored_step": self.restored_step}

    def _fan_out(self, n_rows: int, fn) -> None:
        """Run ``fn(i)`` for every row on the bounded row pool, rows
        together so they ride the same decode windows; then raise the
        first real fault (500), else the first capacity or lifecycle
        refusal (a shed and a poisoned pool's retryable failure included)
        as :class:`GenerateUnavailable` (503), with its retry hint when it
        carries one."""
        errors: list = [None] * n_rows

        def guarded(i: int) -> None:
            try:
                fn(i)
            except Exception as e:  # collected; mapped to a status below
                errors[i] = e

        for fut in [self._rows.submit(guarded, i) for i in range(n_rows)]:
            fut.result()
        retriable = [e for e in errors
                     if isinstance(e, (ServerBusy, ServerClosed))
                     or (isinstance(e, ServingFailure) and e.retryable)]
        for e in errors:
            if e is not None and e not in retriable:
                raise e
        if retriable:
            e = retriable[0]
            retry_after = getattr(e, "retry_after_s", None)
            hint = ("" if retry_after is None
                    else f" (retry after ~{retry_after:g}s)")
            raise GenerateUnavailable(f"{e}{hint}", retry_after) from e

    def _stream(self, prompts, n_new: int, timeout: float, row_sampling,
                priority: str = "interactive",
                deadline_ms: int | None = None, rid: str = ""):
        """Admit every row and wait for its first token HERE, so a refusal
        is still a clean 503 before the 200 is committed; then register
        the request for reconnects (before any token leaves) and return
        the generator that merges the rows' tokens as they land."""
        sources: list = [None] * len(prompts)
        firsts: list = [None] * len(prompts)

        def prime(i: int) -> None:
            src = self.server.submit_stream(prompts[i], n_new,
                                            timeout=timeout,
                                            sampling=row_sampling(i),
                                            priority=priority,
                                            deadline_ms=deadline_ms,
                                            request_id=rid)
            sources[i] = src
            firsts[i] = next(src)

        try:
            self._fan_out(len(prompts), prime)
        except Exception:
            for src in sources:
                if src is not None:
                    src.cancel()
            raise
        if self.resume_log is not None:
            self.resume_log.open(rid, len(prompts), n_new)
        return self._merge(prompts, n_new, sources, firsts, rid)

    def _merge(self, prompts, n_new: int, sources, firsts, rid: str = ""):
        done = object()
        out_q: queue.SimpleQueue = queue.SimpleQueue()
        log = self.resume_log

        def pump(i: int) -> None:
            # One pump per row: the streams block on the decode loop, so
            # a round-robin reader would stall every row behind the
            # slowest. Pumps feed the delivery log directly, so a merger
            # gone with its client never stops it.
            try:
                out_q.put((i, firsts[i]))
                if log is not None:
                    log.append(rid, i, firsts[i])
                for token in sources[i]:
                    out_q.put((i, token))
                    if log is not None:
                        log.append(rid, i, token)
                out_q.put((i, done))
                if log is not None:
                    log.row_done(rid)
            except Exception as e:  # handed to the merger, which raises
                out_q.put((i, e))
                if log is not None:
                    log.finish(rid, error=e)

        for i in range(len(prompts)):
            self._rows.submit(pump, i)
        generated: list = [[] for _ in prompts]
        live = len(prompts)
        try:
            while live:
                i, item = out_q.get()
                if item is done:
                    live -= 1
                    continue
                if isinstance(item, Exception):
                    item.stream_row = i  # the HTTP error record names it
                    raise item
                generated[i].append(item)
                yield {"row": i, "token": item}
        except GeneratorExit:
            # The client is gone. Without the delivery log, free every
            # row's slot and pages at the next decode boundary instead of
            # decoding out the budgets; with it the rows DETACH: they
            # decode on, the pumps keep logging, and the client
            # reconnects with emitted_offset.
            if log is None:
                for src in sources:
                    src.cancel()
            raise
        yield {"done": True,
               "tokens": [p + g for p, g in zip(prompts, generated)],
               "n_new": n_new, "restored_step": self.restored_step,
               "request_id": rid}

    def close(self, drain: bool = False) -> None:
        handle, self.handle = self.handle, None
        if handle is not None:
            # A booted runtime closes as its runtime shuts down: the
            # heartbeats, the status server, then this runtime through
            # serve_fn.close, back here with the handle gone (undrained,
            # as the runtime's shutdown closes its payload).
            handle.shutdown()
            return
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.server is not None:
            self.server.close(drain=drain)
            if self.prefix_path:
                # After the close: a drain's late finishes register too,
                # and the registry and pool outlive it. Best effort.
                try:
                    self.server.dump_prefix_cache(self.prefix_path,
                                                  self.prefix_fingerprint)
                except Exception as e:
                    print(f"[kvedge-serve] prefix-cache dump failed: "
                          f"{e!r}", flush=True)
        with self._generate_lock:
            self._closed = True
            if self.leader is not None and self.leader.relay is not None:
                self.leader.relay.stop()  # the followers leave their loop
        self._rows.shutdown(wait=True)


def run_serve_payload(cfg: ServeConfig, device=None, dtype: str = "bfloat16",
                      seed: int = 0, *, params=None):
    """The ``serve`` payload: ``(DeviceCheckResult, serve_fn)``.

    The reference's ``run_serve_payload`` contract: the device check
    against the config first (a failed check returns with no
    ``serve_fn``), then the runtime (over
    ``params``, a numpy tree, when given), then one tiny greedy
    generation through the uncounted path, proving the weights and the
    decode path (and capturing its graphs) before the endpoint goes
    live; its time and token sum are the check's ``probe_ms`` and
    ``probe_checksum``. ``serve_fn`` is
    :meth:`ServeRuntime.payload_fn`'s. In a world of more than one rank
    every rank joins the slice (:func:`_join_slice`): rank 0's runtime
    serves (its probe crosses the whole slice), the others return a
    follower ``serve_fn`` that answers 503."""
    base = run_device_check(cfg, device)
    if not base.ok:
        return base, None
    leader = None
    if world_size() > 1:
        leader, follower_fn = _join_slice(cfg, device, dtype, seed, params)
        if follower_fn is not None:
            return dataclasses.replace(base, probe_ms=0.0,
                                       probe_checksum=0.0), follower_fn
    rt = ServeRuntime(cfg, device=device, dtype=dtype, seed=seed,
                      params=params, device_check=base, leader=leader)
    try:
        max_seq = rt.tcfg.max_seq
        probe_prompt = list(range(1, min(4, max_seq - 1) + 1))
        probe_new = min(2, max_seq - len(probe_prompt))
        start = time.perf_counter()
        probe = rt._serve({"tokens": [probe_prompt], "n_new": probe_new})
        elapsed_ms = (time.perf_counter() - start) * 1000.0
    except BaseException:
        rt.close()
        raise
    return dataclasses.replace(
        base, probe_ms=elapsed_ms,
        probe_checksum=float(sum(probe["tokens"][0])),
    ), rt.payload_fn()


def _join_slice(cfg: ServeConfig, device, dtype: str, seed: int, params,
                follow_here: bool = False):
    """The multi-process ``serve`` (the reference's leader-serves, over the
    world ``init_world`` joined): every rank restores the same weights
    (``params``, or the latest checkpoint: on the shared
    ``checkpoint_dir`` across pods, in the pod's state dir within one),
    cuts its slices for the mesh of ``[mesh]`` and builds its transport
    at the same point of the collective order. Returns ``(leader, None)``
    on rank 0, whose runtime serves ``/generate``; ``(None,
    follower_fn)`` elsewhere, where a thread replays the leader's stream
    and this pod's ``/generate`` answers 503 naming the leader; with
    ``follow_here`` (a pod's other local ranks) the replay runs on the
    calling thread until the leader's STOP and returns ``(None,
    None)``. A follower's replay that fails re-enters the loop
    ``serving_recovery_attempts`` times (the leader's reformation barrier
    is its first op then); when they are spent the process exits with
    code 13, so the StatefulSet restarts the slice."""
    from kvedge_torch.parallel.distributed import rank
    from kvedge_torch.parallel.mesh import build_mesh
    from kvedge_torch.runtime.sliceserve import (
        ControlPlane,
        SlicePagedKVCache,
        follow_paged,
    )

    if params is None and not cfg.checkpoint_dir and cfg.num_processes > 1:
        raise RuntimeConfigError(
            "multi-host serve needs [runtime] checkpoint_dir on shared "
            "storage: every process restores the same checkpoint")
    dev = resolve_device(device)
    tcfg = cfg.model_config(dtype, dev)
    restored_step, tree = ((None, params) if params is not None
                           else restore_latest_params(cfg, tcfg, seed))
    mesh = build_mesh(cfg.mesh)
    weights = sharded_params(tree, tcfg, dev, mesh)
    paged = cfg.payload_serving == "paged"
    if paged:
        slots, pages, page_size, mpps = _serving_pool_dims(cfg, tcfg)
        cache = SlicePagedKVCache(
            tcfg, slots=slots, pages=pages, page_size=page_size, mesh=mesh,
            max_pages_per_seq=mpps, kv_dtype=cfg.serving_kv_dtype,
            device=dev)
        plane = cache._plane
    else:
        cache, plane = None, ControlPlane()
    me = rank()
    if me == 0:
        return _Leader(mesh, weights, restored_step, cache=cache,
                       relay=None if paged else _ContiguousRelay(plane)), None

    def follow_contiguous():
        while True:
            ints, floats = plane.bcast(_ContiguousRelay.zero_header())
            if int(ints[0]) == 0:
                return
            rows = plane.bcast(np.zeros((int(ints[1]), int(ints[2])),
                                        np.int64))
            _generate_rows(weights, tcfg, dev, mesh,
                           *_ContiguousRelay.received(ints, floats, rows))

    def follow():
        rejoins = max(0, int(cfg.serving_recovery_attempts)) if paged else 0
        tries = 0
        while True:
            try:
                if paged:
                    follow_paged(cache, weights)
                else:
                    follow_contiguous()
                return  # the leader's STOP: the end of serve
            except Exception as e:
                tries += 1
                if tries > rejoins:
                    print(f"[kvedge-serve] follower {me} died "
                          f"({tries - 1} rejoin(s) spent): {e!r}",
                          flush=True)
                    os._exit(13)
                print(f"[kvedge-serve] follower {me} dropped from the op "
                      f"stream ({e!r}); rejoining ({tries}/{rejoins})",
                      flush=True)

    if follow_here:
        follow()
        return None, None
    thread = threading.Thread(target=follow, name="kvedge-serve-follow",
                              daemon=True)
    thread.start()

    def follower_fn(doc: dict) -> dict:
        raise GenerateUnavailable(
            f"this pod is follower process {me}; generation is served by "
            "the leader (process 0: the Service routes to ordinal 0)")

    backend = "multihost-paged-follower" if paged else "multihost-follower"
    follower_fn.stats = lambda: {"backend": backend,
                                 "processes": world_size()}
    follower_fn.close = lambda drain=False: None
    follower_fn.join = thread.join
    follower_fn.cache = cache
    return None, follower_fn


def follow_slice(cfg: ServeConfig, device, dtype: str, seed: int) -> None:
    """A pod's local rank above 0 in the ``serve`` payload: its slices of
    the weights, then the leader's op stream replayed on this thread
    until the leader's STOP (:func:`_join_slice`)."""
    _join_slice(cfg, device, dtype, seed, None, follow_here=True)


def boot_serve(cfg: ServeConfig, *, port: int, host: str | None = None,
               device=None, dtype: str = "bfloat16", seed: int = 0,
               params=None) -> ServeRuntime:
    """The serve runtime booted through ``start_runtime`` with a
    ``serve`` payload on ``host``:``port`` (``[status] bind`` when
    None), over ``params`` (a numpy tree) when given. The device check
    is the config's, with the CPU expected when the CPU is asked for, as
    ``--device cpu`` does. Returns the payload's :class:`ServeRuntime`,
    its heartbeats running until :meth:`ServeRuntime.close`; raises,
    with the runtime shut down, when the payload did not come up."""
    from kvedge_torch.runtime.boot import start_runtime

    device = resolve_device(device)
    overrides = {"payload": "serve", "status_port": port,
                 "status_bind": host or cfg.status_bind}
    if device.type == "cpu":
        overrides["expected_platform"] = "cpu"
    handle = start_runtime(dataclasses.replace(cfg, **overrides),
                           device=device, dtype=dtype, seed=seed,
                           params=params)
    rt = getattr(handle.serve_fn, "runtime", None)
    if rt is None:
        handle.shutdown()
        raise RuntimeError(f"serve payload failed: {handle.check.error}")
    rt.handle, rt.http = handle, handle.server
    handle.writer.start()
    return rt
