"""Continuous-batching generation server over the paged KV cache.

A reduced counterpart of the JAX package's ``models/serving.py``
``PagedGenerationServer``: many concurrent requests with different
prompt lengths and budgets share one page pool and ONE batched decode
step. A request admits into a free slot (its worst-case page budget
``ceil((prompt + n_new) / page_size)`` reserved up front, so decode can
never run out of pages halfway), prefills in chunks with the lock
released between chunks, rides the batched decode windows with whatever
else is in flight, and releases its slot and pages when its budget is
done or its stop token is produced.

What this slice carries: ``submit``, ``submit_stream``/``StreamHandle``,
``cancel``, ``close(drain)``, admission through the scheduler
(``models/scheduler.py``: priority classes, ticketed parking, shedding
by queue watermarks and by the page low watermark, preemption by KV
swap with resume at the high watermark), the prefix cache (a radix
trie over page-sized blocks, partial-page matches copied on write, a
host tier for evicted entries, leases that bill a shared page once)
and its persistence across restarts (``dump_prefix_cache``,
``load_prefix_cache``, ``start_prefix_persistence``: an ``.npz`` the
JAX package's server reads and writes too), chunked prefill (on the
card each chunk a replayed CUDA graph), the bucketed device batch
(``min_bucket``: the batch dim steps along a power-of-two ladder at
quiescent boundaries, ``_ensure_bucket_locked`` /
``_maybe_step_bucket_locked``), the
SERIAL window loop (``_loop_once``) with power-of-two windows
(``_window_steps``), the OVERLAPPED loop (``_loop_once_overlap``, the
``overlap`` knob: window N+1 is enqueued on the device-resident carry
before window N is harvested, each row capped at its own budget on the
device), greedy and seeded nucleus sampling with the reference's key
schedule, stop tokens (truncated on the host in the serial loop, found
on the device in the overlapped one), and server-wide speculative
decoding (``speculative``: per verify pass at boundaries, or as
device-resident spec windows in the overlap pipeline with
``spec_window``; the ``resolve_speculation`` boot probe), and degraded
mode: a decode failure poisons the pool with a typed failure
(``runtime/failures.py``), requests checkpointed into the journal
(``checkpoint_every``, ``runtime/journal.py``) park instead of failing,
the prefix registry is dumped on the way down, and :meth:`revive`
restarts the pool in place, captured graphs and all, with the journaled
requests resumed bit for bit (``runtime/recovery.py`` drives it), and
the observability and control plane: request ids and the flight
recorder (``tracer``, ``runtime/tracing.py``: request spans at submit,
queue, prefill, decode, fabric spans for every window and boundary,
checkpoint, poison and revive), always-on stage histograms (TTFT, queue,
decode, ITL, window device time, round trip and host time), the SLO
engine and the occupancy ring fed at quiescent boundaries
(``runtime/slo.py``; ``slo_shed`` gates the scheduler's burn-rate shed),
the flight bundle (:meth:`flight_bundle`), the online window controller
(``window="auto"``, ``runtime/autotune.py``) and ownership-asserting
locks (``debug_locks``, ``runtime/debuglock.py``). With each of these
off, its feature is a ``None`` check and the tokens are unchanged.

Greedy decode is token-for-token the port's ``forward`` argmax, and the
tokens of a request do not depend on what else is in flight: the paged
attention masks each row to its own positions, and token t of a sampled
request draws with ``fold_in(row_key, t)`` whatever the batch holds. A
swap moves pool bytes verbatim and a resumed request keeps its host
tokens, so preemption changes no token either.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.models.sampling import as_key_tensor, fold_in, sample_token
from kvedge_torch.models.scheduler import AdmissionScheduler, _Hist
from kvedge_torch.runtime.autotune import WindowController
from kvedge_torch.runtime.debuglock import (
    DebugLock,
    instrument_locked_methods,
)
from kvedge_torch.runtime.failures import (
    PageAccountingError,
    PoolPoisoned,
    ServingFailure,
    classify_failure,
)
from kvedge_torch.runtime.journal import JournalEntry, RequestJournal
from kvedge_torch.runtime.slo import OccupancyRing, SloEngine

_STREAM_DONE = object()


class ServerBusy(RuntimeError):
    """No slot/page capacity became available within the timeout."""


class ServerOverloaded(ServerBusy):
    """Shed at admission by the scheduler's watermarks, BEFORE parking;
    ``retry_after_s`` (when measurable) is the measured queue wait."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s


class ServerClosed(RuntimeError):
    """The server was shut down (a poisoned pool refuses with
    :class:`~kvedge_torch.runtime.failures.PoolPoisoned` instead)."""


class RequestCancelled(RuntimeError):
    """The request was cancelled (consumer disconnect / explicit)."""


@dataclasses.dataclass(eq=False)
class _Request:
    prompt: list[int]
    n_new: int
    # (key data uint32 [2], temperature, top_p) or None for greedy.
    sampling: tuple | None = None
    next_token: int = -1
    # Generation ends the moment this token is produced (it is emitted
    # as the final token); -1 never matches a produced id.
    stop_token: int = -1
    # The PRIVATE reservation; the full shared prefix pages the table
    # starts on are billed by leases (_lease_take_locked).
    pages_reserved: int = 0
    shared_pages: tuple = ()
    # The trie node at the full-shared depth: the journal shadow's key.
    prefix_node: int | None = None
    # Scheduler: the priority class, the admission ticket (kept across a
    # preemption) and the admission sequence victims are ordered by.
    pclass: str = "interactive"
    ticket_no: int = -1
    admit_seq: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Exception | None = None
    stream: "queue.SimpleQueue | None" = None
    cancelled: bool = False
    # Steps dispatched to the device and not yet harvested (the overlap
    # pipeline), and a stop already emitted whose finish waits for a
    # boundary because a window in flight still touches the slot.
    inflight: int = 0
    stopped: bool = False
    # Exactly-once delivery after a journal restore rewound ``generated``
    # to its checkpoint: tokens at indices below this were streamed
    # already, and the replay records them without streaming them again.
    stream_resume_at: int = 0
    # The request id (``X-Request-Id`` at the HTTP surface) and the
    # tracer's sampling decision for it, made once at submit. The stage
    # stamps are host ``perf_counter`` seconds, taken with tracing off
    # too: submit, slot admission, and the first token's pick (TTFT).
    rid: str = ""
    trace: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0

    def pick(self, logits_row: torch.Tensor, step: int) -> int:
        """Next token from a ``[V]`` logits row, greedy or sampled with
        ``fold_in(row_key, step)``."""
        if self.sampling is None:
            return int(torch.argmax(logits_row))
        key, temperature, top_p = self.sampling
        keys = fold_in(as_key_tensor(key, logits_row.device)[None], step)
        return int(sample_token(logits_row[None], keys, temperature, top_p)[0])


class StreamHandle:
    """Iterator over a streaming request's tokens, with ``cancel()``."""

    def __init__(self, server: "PagedGenerationServer", req: _Request):
        self._server = server
        self._req = req
        self._produced = 0

    def __iter__(self) -> "StreamHandle":
        return self

    def __next__(self) -> int:
        if self._produced >= self._req.n_new:
            raise StopIteration
        item = self._req.stream.get()
        if item is _STREAM_DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        self._produced += 1
        return item

    def cancel(self) -> None:
        self._server.cancel(self._req)


class PagedGenerationServer:
    """Continuous-batching decode over a :class:`PagedKVCache`.

    ``submit`` blocks the calling thread until its tokens are ready (the
    HTTP handler model); one background thread runs the decode loop.
    ``window`` caps the decode steps one device window runs. ``overlap``
    "auto" and "on" run the double-buffered loop, "off" the serial one;
    the tokens are the same. ``speculative`` K > 0 advances greedy
    requests by verify passes of K prompt-lookup drafts (the same tokens
    as plain greedy decode); ``spec_window`` W > 0 runs W passes as one
    device-resident spec window in the overlap pipeline, and
    ``spec_sampled_window`` keeps a batch with sampled co-tenants on
    those windows. ``prefix_cache`` shares the K/V pages of cached
    prompt prefixes (``prefix_host_mb`` > 0 keeps evicted entries in a
    host tier); ``sched_*`` and ``page_*_watermark`` set the admission
    scheduler's policy, shedding and preemption by swap, as the
    reference's. ``min_bucket`` > 0 runs the device batch dim at a
    bucket of the cache's ladder that follows the occupied slots (0
    pins it to ``slots``). ``checkpoint_every`` > 0 journals every live
    request's resumable state each that many quiescent boundaries
    (within ``journal_budget_mb``, 0 = unbounded), so a poison parks
    them for :meth:`revive` instead of failing them; ``retry_after_s``
    is a poisoned pool's static retry hint; ``debug_pages`` audits the
    page books at every boundary. ``window="auto"`` hands the window cap
    to the online controller, within ``[window_min, window_max]``;
    ``tracer`` is a :class:`~kvedge_torch.runtime.tracing.Tracer` or
    None; ``slo`` (:class:`~kvedge_torch.runtime.slo.SloObjectives` or
    None) runs the SLO engine, and ``slo_shed`` lets its alert shed
    non-top classes; ``occupancy_ring`` > 0 keeps that many boundary
    occupancy samples; ``debug_locks`` asserts lock ownership at every
    ``*_locked`` call. ``device`` is the card unless "cpu" is asked for.
    ``cache`` hands in a built cache instead (its slots, pages and page
    size override the knobs): the multi-process ``serve`` payload's
    ``runtime/sliceserve.SlicePagedKVCache``, whose device seams
    broadcast each op to the other ranks. Every cache call already
    serializes on the server's one lock, the total order the slice's op
    stream needs; ``close()`` calls the cache's ``stop`` (the followers'
    release) when it has one.
    """

    def __init__(self, params: dict, cfg: TransformerConfig, *,
                 slots: int = 4, pages: int = 64, page_size: int = 16,
                 prefill_chunk: int = 0, prefix_cache: bool = True,
                 speculative: int = 0,
                 spec_window: int = 0, spec_sampled_window: bool = True,
                 window: int = 64, kv_dtype: str = "",
                 overlap: str = "auto", sched_policy: str = "strict",
                 sched_weights: dict | None = None,
                 sched_max_queue_depth: int = 0,
                 sched_max_queue_wait_s: float = 0.0,
                 sched_swap_budget_mb: int = 0,
                 page_low_watermark: float = 0.0,
                 page_high_watermark: float = 0.0,
                 prefix_host_mb: int = 0, min_bucket: int = 0,
                 retry_after_s: float | None = None,
                 checkpoint_every: int = 0, journal_budget_mb: int = 0,
                 debug_pages: bool = False, window_min: int = 1,
                 window_max: int = 256, tracer=None,
                 debug_locks: bool = False, slo=None,
                 slo_shed: bool = False, occupancy_ring: int = 0,
                 device: torch.device | str | None = None, cache=None):
        # The online window controller (window="auto"): plain data,
        # mutated under the lock at each harvest, never recreated, so
        # what it learned rides through revive().
        self._autotune = None
        # Harvested windows kept from the controller because a graph
        # capture ran inside their round trip (1-2 s under the lock on
        # the card, which would read as a huge R).
        self._autotune_skipped_captures = 0
        if window == "auto":
            self._autotune = WindowController(lo=window_min, hi=window_max)
            window = self._autotune.window()
        elif (isinstance(window, (str, bool)) or not isinstance(window, int)
                or window < 1):
            raise ValueError("window must be an int >= 1 or 'auto'")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole prompt)")
        if overlap not in ("auto", "on", "off"):
            raise ValueError("overlap must be 'auto', 'on' or 'off'")
        self._overlap = overlap
        self._overlap_on = overlap != "off"
        self._params = params
        self._cfg = cfg
        self._window = window
        # The flight recorder, or None (off: every site checks it). Plain
        # host state, so it survives revive() unchanged.
        self.tracer = tracer
        self._prefill_chunk = prefill_chunk
        # Speculative mode: greedy slots advance by verify passes of K
        # drafts, sampled slots ride one token a pass. A GREEDY request's
        # page budget carries K slack positions (a verify pass writes K/V
        # at length..length+K even when nothing accepts); sampled
        # requests reserve none, their draft offsets writing to the sink.
        self._spec = int(speculative)
        self._spec_passes = 0
        self._spec_emitted = 0      # tokens emitted by greedy slots
        self._spec_slot_passes = 0  # greedy-slot participations
        if spec_window < 0:
            raise ValueError("spec_window must be >= 0")
        if spec_window > 0 and self._spec <= 0:
            raise ValueError(
                "spec_window needs speculative mode (speculative > 0)"
            )
        self._spec_window = int(spec_window)
        # The controller's spec-depth ceiling: with window="auto" the
        # spec window floats in [1, cap] at true boundaries.
        self._spec_window_cap = int(spec_window)
        self._spec_windows = 0
        self._spec_depth1_windows = 0
        self._spec_sampled_window = bool(spec_sampled_window)
        # Spec windows configured but a boundary ran the per-pass path
        # anyway, by cause: "sampled" = a mixed batch with the sampled
        # window off; "spec_off" = speculation disabled with a spec
        # window in flight; "overlap_off" = the serial loop is running.
        self._spec_window_fallbacks = {
            "sampled": 0, "spec_off": 0, "overlap_off": 0,
        }
        # Drafting-context capacity of a spec window: prompt + generated
        # + pending never exceeds max_seq + 1, and the device appends at
        # most K past the budget before freezing.
        self._spec_ctx_cap = int(cfg.max_seq) + int(speculative) + 2
        # The boot probe's decision (resolve_speculation), kept after an
        # auto fallback zeroed _spec.
        self._spec_decision: dict | None = None
        # The table widens by the draft slack, so a full-length (prompt +
        # n_new == max_seq) greedy request still admits; a cache handed
        # in was sized by the same rule (runtime/serve._serving_pool_dims).
        if cache is not None:
            slots, pages = cache.slots, cache.num_pages
            page_size = cache.page_size
            self._cache = cache
        else:
            self._cache = PagedKVCache(
                cfg, slots=slots, pages=pages, page_size=page_size,
                max_pages_per_seq=-(-(cfg.max_seq + self._spec)
                                    // page_size),
                kv_dtype=kv_dtype, min_bucket=min_bucket, device=device,
            )
        # An admission parked on a free slot above the bucket: the decode
        # loop steps the bucket up at its next boundary.
        self._bucket_step_wanted = False
        # Free-page watermarks (fractions of the pool, 0 = off): below
        # ``low`` unreserved headroom a non-top-class arrival sheds;
        # a swapped-out request resumes only at ``high`` or better.
        for name, v in (("page_low_watermark", page_low_watermark),
                        ("page_high_watermark", page_high_watermark)):
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if page_low_watermark and page_high_watermark \
                and page_low_watermark > page_high_watermark:
            raise ValueError(
                "page_low_watermark must be <= page_high_watermark"
            )
        self._page_low_wm = float(page_low_watermark)
        self._page_high_wm = float(page_high_watermark)
        # The prefix registry: a radix trie over page-sized token blocks.
        # Node 0 is the root; a node holds its out-edges {block: child},
        # an optional pool entry {"pages", "last_used"} and an optional
        # host-tier record. Node ids are never reused.
        self._prefix_enabled = bool(prefix_cache)
        self._prefix_nodes: dict[int, dict] = {
            0: {"parent": None, "edges": {}, "entry": None, "host": None},
        }
        self._prefix_entry_nodes: dict[int, dict] = {}  # id -> entry
        self._prefix_next_id = 1
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._prefix_tokens_saved = 0
        self._prefix_cow_copies = 0
        # Entries registered so far: the periodic dump's dirty counter.
        self._prefix_registrations = 0
        self._persist_stop: threading.Event | None = None
        self._persist_thread: threading.Thread | None = None
        # Each dump writes a temporary file of its own (this counter names
        # it), so the periodic dump and a caller's never share one.
        self._dump_seq = itertools.count()
        if prefix_host_mb < 0:
            raise ValueError("prefix_host_mb must be >= 0")
        self._prefix_host_budget = int(prefix_host_mb) << 20
        self._prefix_host_nodes: dict[int, dict] = {}  # id -> record
        self._prefix_host_bytes = 0
        self._prefix_demotions = 0
        self._prefix_promotions = 0
        # Evictions by cause, the reference's keys.
        self._prefix_evictions = {
            "admission": 0, "pressure": 0, "revive": 0,
            "host_lru": 0, "host_over": 0,
        }
        # Leases: one reservation unit per distinct shared prefix page a
        # live request's table starts on, freed with its last sharer.
        self._lease: dict[int, int] = {}
        # The journal's shadow store: trie node id -> the shared prefix
        # pages' swap-out bytes, refcounted by the entries that cite
        # them, billed once against the journal budget.
        self._prefix_shadow: dict[int, dict] = {}
        # Registry pins sit outside every reservation: an allocation that
        # finds the free list short reclaims them first.
        self._cache.pressure_relief = self._relieve_pool_pressure_locked
        if tracer is not None:
            # A slice cache stamps its per-op broadcast spans into the
            # same recorder; a single-host cache ignores the attribute.
            self._cache.tracer = tracer
        self._pages_total = pages
        self._reserved = 0  # worst-case pages of every admitted request
        # debug_locks: a lock that asserts its owner at every *_locked
        # call and every wait / notify; a plain Lock otherwise.
        self._lock = DebugLock() if debug_locks else threading.Lock()
        self._work = threading.Condition(self._lock)
        # The admission scheduler shares the server's one lock: each
        # parked ticket waits on its own condition over it. It records
        # its enqueue, queue and shed events into the same tracer.
        self._sched = AdmissionScheduler(
            self._lock, policy=sched_policy, weights=sched_weights,
            max_queue_depth=sched_max_queue_depth,
            max_queue_wait_s=sched_max_queue_wait_s,
            swap_budget_mb=sched_swap_budget_mb,
            tracer=tracer,
        )
        # The SLO engine, fed one snapshot of the cumulative histograms
        # and counters per quiescent boundary; with slo_shed its alert
        # becomes the scheduler's burn-rate shed input.
        self._slo = None
        if slo is not None:
            self._slo = SloEngine(slo)
            if slo_shed:
                self._sched.burn_input = self._slo.alert
        elif slo_shed:
            raise ValueError("slo_shed needs SLO objectives (slo=...)")
        # Occupancy samples at quiescent boundaries (0 = off); with
        # tracing on they are the Chrome counter tracks of GET /trace.
        self._occ_ring = None
        if occupancy_ring:
            self._occ_ring = OccupancyRing(occupancy_ring)
            if tracer is not None:
                tracer.counter_source = self._occ_ring.chrome_counters
        # Host bytes one swapped-out page costs (filled lazily).
        self._swap_page_bytes: int | None = None
        self._free_slots = list(range(slots))  # a heap: lowest slot first
        self._active: dict[int, _Request] = {}
        self._finish_ready: set[int] = set()
        self._prefilling = 0
        self._closed = False
        self._draining = False
        # Degraded mode: the typed failure that poisoned the pool, and
        # its reason, read lock-free by /healthz. ``on_degraded(reason,
        # failure)`` is called once, outside the lock, when the pool
        # poisons; ``retry_after_hint`` () -> float | None (the recovery
        # supervisor's measured estimate) overrides ``retry_after_s``.
        self._poison: ServingFailure | None = None
        self._degraded_reason: str | None = None
        self.on_degraded = None
        self._retry_after_s = retry_after_s
        self.retry_after_hint = None
        # Boundary checkpoints into the journal (0 = off). The clock
        # advances per boundary and per harvested window; an overdue one
        # collapses the overlap pipeline to a boundary.
        if checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if journal_budget_mb < 0:
            raise ValueError("journal_budget_mb must be >= 0")
        self._checkpoint_every = int(checkpoint_every)
        self._journal = RequestJournal(
            max_bytes=journal_budget_mb * (1 << 20))
        self._ckpt_clock = 0
        self._checkpoints_total = 0
        self._checkpoint_skipped = 0
        self._checkpoints_unchanged = 0
        self._journal_restores = 0
        self._debug_pages = bool(debug_pages)
        # The bucket at poison time, which revive restores.
        self._prebucket = 0
        # The persistence file, for the emergency dump of a poisoned pool.
        self._persist_path: str | None = None
        self._persist_fp: str | None = None
        # Counters (read by stats()): decode steps and windows run, and
        # the tokens and requests that finished normally.
        self._decode_steps = 0
        self._windows = 0
        # The overlap pipeline: the one dispatched, unharvested window
        # ({"window": W, "parts": [(slot, req, adv)], "handle": ...}),
        # the windows harvested, those dispatched while another was in
        # flight (depth 1), and the stop finishes waiting for a boundary.
        self._inflight: dict | None = None
        self._overlap_windows = 0
        self._depth1_windows = 0
        self._stops_pending = 0
        self._done_total = 0
        # Requests that took an admission ticket: a plain int, read
        # without the lock by a client that orders its submissions.
        self.requests_queued = 0
        self._tokens_done_total = 0
        self._stop_finishes = 0
        # Host-clock seconds (the device's own are the cache's
        # device_seconds()): ``_prefill_s`` spans each chunk's call and
        # the first token's pick, so it holds the chunks' launches (or
        # replays) and the pick's wait for the device, which also waits
        # out any window queued ahead of the chunk; ``_decode_s`` spans
        # decode windows and steps (serial: to the tokens' host copy;
        # overlapped: the loop's iterations that dispatch or harvest,
        # under the lock).
        self._prefill_s = 0.0
        self._decode_s = 0.0
        # Histograms (ms, the reference's edges), always on. Clocks:
        # ``_hist_rtt`` (dispatch to harvest), ``_hist_host`` (a
        # harvest's bookkeeping), and the request stages ``_hist_ttft``
        # (submit to the first token's pick), ``_hist_queue`` (submit to
        # admission), ``_hist_decode`` (admission to finish) and
        # ``_hist_itl`` (first token to finish over tokens - 1) are host
        # ``perf_counter`` spans. ``_hist_device`` is device time: on the
        # card the CUDA events around each window's graph replay, read
        # once its harvest has waited (never a sync of its own); on the
        # CPU, where a window runs eagerly inside its dispatch, the host
        # time of that run; for an eager step or verify pass, the host
        # time of the blocking call, as the reference's serial path.
        self._hist_rtt = _Hist((1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                                100.0, 200.0, 500.0, 1000.0, 2000.0))
        self._hist_host = _Hist((0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
                                 20.0, 50.0, 100.0))
        self._hist_depth = _Hist((0.0, 1.0))
        stage_edges = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                       500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
                       60000.0, 120000.0, 240000.0, 480000.0, 960000.0)
        self._hist_ttft = _Hist(stage_edges)
        self._hist_queue = _Hist(stage_edges)
        self._hist_decode = _Hist(stage_edges)
        self._hist_device = _Hist((1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                                   100.0, 200.0, 500.0, 1000.0, 2000.0))
        self._hist_itl = _Hist((0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                                100.0, 200.0, 500.0))
        # Tokens one request realized from one spec window.
        self._hist_spec_tokens = _Hist(
            (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        if debug_locks:
            # Every *_locked method of the server and of the scheduler
            # sharing its lock asserts ownership, wrapped before the
            # decode thread exists.
            instrument_locked_methods(self, self._lock)
            instrument_locked_methods(self._sched, self._lock)
        # After the instrumentation: the journal's drop observer is the
        # (checked) bound method; every journal call holds the lock.
        self._journal.on_drop = self._journal_drop_locked
        self._thread = threading.Thread(target=self._loop,
                                        name="kvedge-torch-serve",
                                        daemon=True)
        self._thread.start()

    # ---- public API ------------------------------------------------------

    def submit(self, prompt: list[int], n_new: int, timeout: float = 120.0,
               sampling: tuple | None = None,
               priority: str = "interactive",
               deadline_ms: int | None = None,
               stop_token: int | None = None,
               request_id: str = "") -> list[int]:
        """Blocking generate: the prompt plus UP TO ``n_new`` generated
        tokens. Greedy unless ``sampling = (key_data, temperature,
        top_p)``, with ``key_data`` the raw uint32 ``[2]`` data of the
        row's seed key. ``priority`` names the scheduling class
        (``interactive``/``batch``); ``deadline_ms`` bounds the admission
        wait tighter than ``timeout`` and lets the scheduler shed the
        request up front when its measured queue wait cannot meet it.
        ``request_id`` keys the request's spans in the tracer. Raises :class:`ServerBusy` when capacity does not free up in time
        (:class:`ServerOverloaded` when shed), ValueError for requests
        that can never fit."""
        req = self._start(prompt, n_new, timeout, sampling, stream=False,
                          priority=priority, deadline_ms=deadline_ms,
                          stop_token=stop_token, request_id=request_id)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.prompt + req.generated

    def submit_stream(self, prompt: list[int], n_new: int,
                      timeout: float = 120.0, sampling: tuple | None = None,
                      priority: str = "interactive",
                      deadline_ms: int | None = None,
                      stop_token: int | None = None,
                      request_id: str = "") -> StreamHandle:
        """Streaming generate: an iterator over the generated tokens as
        they land, with ``cancel()``; admission as :meth:`submit`."""
        req = self._start(prompt, n_new, timeout, sampling, stream=True,
                          priority=priority, deadline_ms=deadline_ms,
                          stop_token=stop_token, request_id=request_id)
        return StreamHandle(self, req)

    def cancel(self, req: _Request) -> None:
        """Drop a request at the next boundary (idempotent). A request
        swapped out, or parked in a poisoned pool's journal, holds no
        slot: its host snapshot is freed here and its waiter fails at
        once."""
        with self._work:
            req.cancelled = True
            dropped = self._sched.drop_swapped_locked(req) is not None
            if not dropped and req not in self._active.values():
                dropped = self._journal.pop(req) is not None
            if dropped:
                req.error = RequestCancelled(
                    "request cancelled while swapped out")
                if req.stream is not None:
                    req.stream.put(req.error)
                req.done.set()
            # A parked ticket waits on its own condition: wake them all
            # so the cancelled one dequeues itself.
            self._sched.wake_all_locked()
            self._work.notify_all()

    def close(self, drain: bool = False) -> None:
        """Shut down. A hard close fails in-flight requests with
        :class:`ServerClosed`; ``drain=True`` refuses new submits at once
        but lets every admitted request decode out its budget first. The
        periodic prefix dump stops first; the registry and the pool
        outlive the close, so a dump after it still reads them."""
        if self._persist_stop is not None:
            self._persist_stop.set()
            self._persist_thread.join(timeout=60)
        with self._work:
            if drain:
                self._draining = True
            else:
                self._closed = True
            # Parked tickets wait on their own conditions.
            self._sched.wake_all_locked()
            self._work.notify_all()
        self._thread.join(timeout=600 if drain else 60)
        with self._work:
            self._closed = True
            # Swapped-out requests the exited loop never resumed.
            self._fail_swapped_closed_locked()
            # A closed pool is never revived: journaled survivors of a
            # poison fail with it (retryable, hint attached).
            if len(self._journal):
                self._fail_journal_locked(
                    self._poison if self._poison is not None
                    else ServerClosed("server is shut down"))
            self._sched.wake_all_locked()
            self._work.notify_all()
        # A slice cache releases its followers here, under the lock: the
        # stop serializes after any request thread's cache call, and its
        # idempotence flag is check-then-act atomic. Skipped while the
        # decode loop is still alive (a step wedged outside the op
        # runner): close() stays bounded.
        stop = getattr(self._cache, "stop", None)
        if stop is not None and not self._thread.is_alive():
            with self._work:
                stop()

    @property
    def healthy(self) -> bool:
        """False once the server is closed or its pool poisoned."""
        return not self._closed

    @property
    def degraded(self) -> str | None:
        """The degraded-mode reason, or None while healthy. Lock-free:
        /healthz must answer whatever holds the server lock."""
        return self._degraded_reason

    def device_quiet(self):
        """The server's work lock, as a context manager: while it is held
        no device work of the decode loop runs (every window, prefill
        chunk, swap, capture and harvest runs under it). The profiler's
        two toggles (``runtime/profiling.py``) run under it: a launch
        racing a CUPTI toggle can deadlock the process. The dump's host
        copy (``dump_prefix_cache``) runs outside it."""
        return self._work

    def capacity_probe(self) -> dict:
        """Lock-free capacity snapshot for /healthz (values may be one
        boundary stale). ``pages_free`` is UNRESERVED pages, the
        admission resource."""
        return {
            "pages_free": max(self._pages_total - self._reserved, 0),
            "pages_total": self._pages_total,
            "bucket": self._cache.bucket,
        }

    def load_params(self, params: dict) -> None:
        """Copy ``params`` (name -> tensor) into the server's weights IN
        PLACE, between two decode-loop iterations: every captured graph
        reads the tensors it was captured with, so rebinding would leave
        them on the old weights. Refuses a tree whose keys, shapes or
        dtypes differ from the served one."""
        if set(params) != set(self._params):
            raise ValueError(f"param keys {sorted(params)} != served "
                             f"{sorted(self._params)}")
        for name, dst in self._params.items():
            src = params[name]
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"param {name!r} is {src.dtype} {tuple(src.shape)}, "
                    f"the served one {dst.dtype} {tuple(dst.shape)}")
        with self._work, torch.no_grad():
            for name, dst in self._params.items():
                dst.copy_(params[name])

    def stats(self) -> dict:
        """Counters, gauges and histogram snapshots: the reference's keys
        (what ``runtime/status.py`` renders as ``/metrics``) and the
        port's own. ``prefill_s`` / ``decode_s`` are host spans (see
        ``__init__``); ``prefill_device_s`` / ``decode_device_s`` are the
        device's seconds in prefill-chunk replays and in window and
        spec-window replays, from CUDA events around each (0 on the CPU,
        and for a single step or per-pass verify, which run eagerly).
        Only the raw copies run under the lock; the tracer, SLO and
        occupancy merges read ring copies after it is released."""
        with self._work:
            out = self._stats_core_locked()
        self._stats_merge_unlocked(out)
        return out

    def _stats_locked(self) -> dict:
        """:meth:`stats` under ONE lock hold (the flight bundle's, so its
        metrics, SLO state and page books agree)."""
        out = self._stats_core_locked()
        self._stats_merge_unlocked(out)
        return out

    def _stats_core_locked(self) -> dict:
        # Never waits on the device under the lock: a replay still
        # running counts at a later call.
        device_s = self._cache.device_seconds(wait=False)
        out = {
            "degraded": 1 if self._degraded_reason else 0,
            "in_flight": len(self._active),
            "free_slots": len(self._free_slots),
            "free_pages": self._cache.free_pages(),
            "slots_total": self._cache.slots,
            "bucket": self._cache.bucket,
            "bucket_min": self._cache.min_bucket,
            "bucket_steps_up": self._cache.bucket_steps["up"],
            "bucket_steps_down": self._cache.bucket_steps["down"],
            "pages_total": self._pages_total,
            "reserved_pages": self._reserved,
            "page_low_watermark": self._page_low_wm,
            "page_high_watermark": self._page_high_wm,
            "window": self._window,
            "kv_dtype": ("int8" if self._cache.kv_quantized
                         else str(self._cfg.dtype)),
            "active": len(self._active),
            "waiting": self._sched.depth_locked(),
            "decode_steps": self._decode_steps,
            "windows": self._windows,
            "overlap": 1 if self._overlap_on else 0,
            "overlap_windows": self._overlap_windows,
            "overlap_windows_total": self._overlap_windows,
            "overlap_inflight_depth": 1 if self._inflight is not None else 0,
            "overlap_depth1_windows": self._depth1_windows,
            "window_dispatch_harvest_ms": self._hist_rtt.snapshot(),
            "window_host_ms": self._hist_host.snapshot(),
            "window_device_ms": self._hist_device.snapshot(),
            "window_inflight_depth": self._hist_depth.snapshot(),
            "ttft_ms": self._hist_ttft.snapshot(),
            "queue_ms": self._hist_queue.snapshot(),
            "decode_ms": self._hist_decode.snapshot(),
            "itl_ms": self._hist_itl.snapshot(),
            "requests_done": self._done_total,
            "requests_done_total": self._done_total,
            "tokens_done_total": self._tokens_done_total,
            "stop_finishes": self._stop_finishes,
            "stop_finishes_total": self._stop_finishes,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
            "prefill_device_s": device_s["prefill"],
            "decode_device_s": device_s["decode"],
            "page_accounting": self._cache.page_accounting(),
            "spec_window_fallbacks": dict(self._spec_window_fallbacks),
            **self._prefix_stats_locked(),
            **self._recovery_stats_locked(),
            **self._sched.stats_locked(),
            **self._spec_stats_locked(),
        }
        if self._autotune is not None:
            # The pick and its EWMA inputs: the pick is the smallest power
            # of two with window * t >= R.
            snap = self._autotune.snapshot()
            out["autotune_window"] = snap["window"]
            out["autotune_r_ms"] = round(snap["r_ms"], 3)
            out["autotune_t_ms"] = round(snap["t_ms"], 4)
            out["autotune_updates"] = snap["updates"]
            out["autotune_skipped_captures"] = (
                self._autotune_skipped_captures)
            if self._spec_window_cap:
                out["autotune_spec_window"] = self._spec_window
        return out

    def _stats_merge_unlocked(self, out: dict) -> None:
        """Merge the lock-free planes (the tracer, the SLO engine and the
        occupancy ring read ring copies) into a stats snapshot; callable
        with or without the lock."""
        if self.tracer is not None:
            out.update(self.tracer.stats())
        if self._slo is not None:
            out.update(self._slo.metrics())
        if self._occ_ring is not None:
            out["occupancy_samples_total"] = self._occ_ring.samples_total
            last = self._occ_ring.last()
            if last:
                for k, v in last.items():
                    out["occupancy_" + k] = v
        op_ms = getattr(self._cache, "op_broadcast_ms", None)
        if op_ms:
            # A slice cache's broadcast bill: op kind -> [frames, ms].
            out["slice_op_ms"] = {k: list(v)
                                  for k, v in dict(op_ms).items()}

    # ---- the SLO engine and the flight bundle ----------------------------

    def slo_doc(self) -> dict | None:
        """The ``GET /slo`` document, or None when the engine is off."""
        if self._slo is None:
            return None
        return self._slo.doc()

    def _config_doc_locked(self) -> dict:
        """The serving shape the bundle fingerprints: the reference's
        keys and spellings, so one set of knobs gives one fingerprint
        in both packages."""
        return {
            "slots": self._cache.slots,
            "pages_total": self._pages_total,
            "page_size": self._cache.page_size,
            "window": self._window,
            "overlap": self._overlap,
            "speculative": self._spec,
            "spec_window": self._spec_window,
            "spec_sampled_window": int(self._spec_sampled_window),
            "prefill_chunk": self._prefill_chunk,
            "prefix_cache": int(self._prefix_enabled),
            "checkpoint_every": self._checkpoint_every,
            "page_low_watermark": self._page_low_wm,
            "page_high_watermark": self._page_high_wm,
            "kv_dtype": ("int8" if self._cache.kv_quantized
                         else str(self._cfg.dtype)),
            "slo": (dataclasses.asdict(self._slo.objectives)
                    if self._slo is not None else None),
        }

    def flight_bundle(self) -> dict:
        """The post-mortem bundle: metrics, SLO state, the occupancy tail,
        the journal's summary, the page books, the config and its
        fingerprint, and the trace tail. Everything but the trace tail
        comes from ONE lock hold, so the parts agree; it reads only host
        books, so a poisoned pool answers too."""
        with self._work:
            doc = {
                "bundle_version": 1,
                "reason": self._degraded_reason,
                "degraded": 1 if self._degraded_reason else 0,
                "metrics": self._stats_locked(),
                "slo": (self._slo.doc() if self._slo is not None
                        else None),
                "occupancy_tail": (self._occ_ring.tail()
                                   if self._occ_ring is not None else []),
                "journal": {
                    "entries": len(self._journal),
                    "bytes": self._journal.nbytes,
                    "extra_bytes": self._journal.extra_bytes,
                    "budget_bytes": self._journal.max_bytes,
                },
                "config": self._config_doc_locked(),
            }
            try:
                doc["page_accounting"] = self._cache.page_accounting()
            except Exception:
                # A torn-down cache must not take the post-mortem with it.
                doc["page_accounting"] = None
        doc["config_fingerprint"] = hashlib.sha256(
            json.dumps(doc["config"], sort_keys=True).encode("utf-8")
        ).hexdigest()[:12]
        # Outside the lock: the tracer's ring is lock-free.
        doc["trace_tail"] = (self.tracer.last_events()
                             if self.tracer is not None else [])
        return doc

    def _occupancy_fields_locked(self) -> dict:
        """One occupancy sample: the cache's pool gauges and the server's
        residency gauges, all attribute reads."""
        fields = {
            "slots_active": len(self._active),
            "reserved_pages": self._reserved,
            "prefix_entries": len(self._prefix_entry_nodes),
            "prefix_host_bytes": self._prefix_host_bytes,
            "journal_bytes": self._journal.nbytes,
            "queue_depth": self._sched.depth_locked(),
        }
        fields.update(self._cache.occupancy())
        return fields

    def _observe_boundary_locked(self) -> None:
        """The quiescent-boundary feed: one SLO snapshot (throttled in the
        engine) and one occupancy sample. No device work, nothing
        emitted: with both off it is one check."""
        if self._slo is None and self._occ_ring is None:
            return
        now = time.perf_counter()
        if self._slo is not None:
            self._slo.observe(now, {
                "ttft_ms": self._hist_ttft.snapshot(),
                "itl_ms": self._hist_itl.snapshot(),
                "queue_ms": self._hist_queue.snapshot(),
                "tokens_total": self._tokens_done_total,
                "done_total": self._done_total,
                "shed_total": self._sched.shed,
            })
        if self._occ_ring is not None:
            self._occ_ring.sample(now, self._occupancy_fields_locked())

    def _recovery_stats_locked(self) -> dict:
        out = {
            "degraded": 1 if self._degraded_reason else 0,
            "checkpoint_every": self._checkpoint_every,
            "journal_entries": len(self._journal),
            "journal_bytes": self._journal.nbytes,
            "journal_shadow_nodes": len(self._prefix_shadow),
            "journal_shadow_bytes": self._journal.extra_bytes,
            "checkpoints_total": self._checkpoints_total,
            "checkpoint_skipped_total": self._checkpoint_skipped,
            "checkpoint_unchanged_total": self._checkpoints_unchanged,
            "journal_restores_total": self._journal_restores,
        }
        if self._degraded_reason:
            out["degraded_reason"] = self._degraded_reason
        return out

    def _prefix_stats_locked(self) -> dict:
        return {
            "prefix_entries": len(self._prefix_entry_nodes),
            "prefix_hits": self._prefix_hits,
            "prefix_lookups": self._prefix_lookups,
            "prefix_tokens_saved": self._prefix_tokens_saved,
            "prefix_bytes_saved": self._prefix_tokens_saved * (
                self._page_bytes_locked() // self._cache.page_size),
            "prefix_cow_copies": self._prefix_cow_copies,
            "prefix_host_entries": len(self._prefix_host_nodes),
            "prefix_host_bytes": self._prefix_host_bytes,
            "prefix_demotions": self._prefix_demotions,
            "prefix_promotions": self._prefix_promotions,
            "prefix_evictions": dict(self._prefix_evictions),
        }

    def _spec_stats_locked(self) -> dict:
        out: dict = {}
        if self._spec:
            # Tokens a greedy slot emits per verify pass it rides (1.0 =
            # speculation never paid; K + 1 = every draft accepted),
            # normalized by slot participations, not passes.
            out["spec_draft_len"] = self._spec
            out["spec_passes"] = self._spec_passes
            out["spec_emitted_per_pass"] = round(
                self._spec_emitted / self._spec_slot_passes, 3
            ) if self._spec_slot_passes else 0.0
        if self._spec_window:
            out["spec_window"] = self._spec_window
            out["spec_windows_total"] = self._spec_windows
            out["spec_windows_depth1"] = self._spec_depth1_windows
            out["spec_window_sampled"] = 1 if self._spec_sampled_window else 0
            out["spec_window_emitted_tokens"] = (
                self._hist_spec_tokens.snapshot())
        if self._spec_decision is not None:
            out["spec_decision"] = dict(self._spec_decision)
        return out

    # ---- speculative-mode economics --------------------------------------

    def resolve_speculation(self, auto: bool,
                            timings: dict | None = None) -> dict:
        """Decide, before traffic arrives, whether speculative mode can
        pay on this card: the wall cost of one K-draft verify pass and of
        one ``window``-step decode window at full batch, each with its
        host round trip (measured, or ``timings``), compare speculation's
        BEST case, every draft accepted, ``(K + 1) / verify_s``, with the
        windows' ``window / window_s``. When windows dominate, ``auto``
        turns speculation off; otherwise the operator's explicit choice
        stays, with a warning. Returns the decision, also under
        ``stats()["spec_decision"]``."""
        if self._spec <= 0:
            raise RuntimeError("resolve_speculation needs spec mode on")
        t = timings or self._probe_spec_timings()
        return self._apply_spec_decision(auto, t)

    def disable_speculation(self, reason: str) -> dict:
        """Turn speculation off without probing, recording why."""
        with self._work:
            self._spec = 0
        decision = {"mode": f"windowed ({reason})",
                    "windows_dominate": None}
        self._spec_decision = decision
        return decision

    def _apply_spec_decision(self, auto: bool, t: dict) -> dict:
        k = self._spec
        window = t.get("probed_window", self._window)
        spec_best = (k + 1) / t["verify_s"]
        windowed = window / t["window_s"]
        fallback = windowed > spec_best
        decision = {
            "verify_ms": round(t["verify_s"] * 1e3, 2),
            "window_ms": round(t["window_s"] * 1e3, 2),
            "window": window,
            "draft_len": k,
            "spec_best_tokens_per_sec": round(spec_best, 1),
            "windowed_tokens_per_sec": round(windowed, 1),
            "windows_dominate": fallback,
            "mode": ("windowed (auto fallback)" if fallback and auto
                     else "speculative" if not fallback
                     else "speculative (operator override)"),
        }
        if self._spec_window > 0 and "spec_window_s" in t:
            # A sampled co-tenant advances one token a pass either way:
            # W host round trips per W tokens (per pass) against one
            # spec window.
            w = self._spec_window
            legacy = 1 / t["verify_s"]
            windowed_sampled = w / t["spec_window_s"]
            decision["spec_window_ms"] = round(t["spec_window_s"] * 1e3, 2)
            decision["sampled_cotenant_legacy_tokens_per_sec"] = round(
                legacy, 1)
            decision["sampled_cotenant_windowed_tokens_per_sec"] = round(
                windowed_sampled, 1)
            decision["sampled_window_pays"] = windowed_sampled >= legacy
        if fallback:
            action = ("falling back to windowed decode" if auto else
                      "serving_speculative is set explicitly — keeping "
                      "it; expect slower greedy traffic")
            print("[kvedge-serve] WARNING: windowed decode dominates "
                  f"speculation's best case on this card ({windowed:.0f} "
                  f"vs {spec_best:.0f} tok/s best-case per slot); "
                  f"{action}", flush=True)
            if auto:
                with self._work:
                    self._spec = 0
        self._spec_decision = decision
        return decision

    def _probe_spec_timings(self) -> dict:
        """Time one verify pass, one decode window and (with
        ``spec_window``) one spec window on the live cache: slot 0, a
        one-token prompt admitted and released around each run, the
        first run of each untimed (it builds and, on the card, captures
        the programs real traffic then reuses)."""
        k = self._spec
        n = self._cache.slots
        probe_tokens = np.zeros((n, 1 + k), np.int64)
        step_tokens = np.zeros((n,), np.int64)
        active = np.zeros((n,), bool)
        active[0] = True
        spec_mask = active.copy()
        # A window the serving loop can run: it floors to a power of two.
        window = min(self._window, self._cfg.max_seq - 1 - k)
        if window > 1:
            window = 1 << (window.bit_length() - 1)
        with self._work:
            def timed(op) -> float:
                self._cache.admit(0, 1)
                self._cache.prefill(self._params, 0, [0])
                start = time.perf_counter()
                op()
                elapsed = time.perf_counter() - start
                self._cache.release(0)
                return elapsed

            def verify():
                self._cache.step_spec(self._params, probe_tokens,
                                      active=active, spec_mask=spec_mask)

            def run_window():
                self._cache.step_window(self._params, step_tokens, window,
                                        active=active)

            def run_spec_window():
                budgets = np.zeros((n,), np.int64)
                budgets[0] = self._spec_window
                ctx = np.zeros((n, self._spec_ctx_cap), np.int64)
                ctx_len = np.zeros((n,), np.int64)
                ctx_len[0] = 2  # the prefilled token and the pending one
                handle = self._cache.dispatch_spec_window(
                    self._params, step_tokens, self._spec_window, k,
                    budgets, ctx=ctx, ctx_len=ctx_len)
                self._cache.harvest_spec_window(handle)
                self._cache.drop_carry()

            timed(verify)
            timed(run_window)
            verify_s = min(timed(verify) for _ in range(2))
            window_s = min(timed(run_window) for _ in range(2))
            out = {"verify_s": verify_s, "window_s": window_s,
                   "probed_window": window}
            if self._spec_window > 0:
                timed(run_spec_window)
                out["spec_window_s"] = min(
                    timed(run_spec_window) for _ in range(2))
        return out

    # ---- admission and prefill -------------------------------------------

    def _pages_needed(self, total: int, slack: bool) -> int:
        """Worst-case pages of a ``total``-token request; ``slack``
        (greedy requests in spec mode) adds the K draft positions a
        verify pass writes whatever it accepts."""
        pad = self._spec if slack else 0
        return -(-(total + pad) // self._cache.page_size)

    def _refusal(self) -> Exception:
        """The refusal a new or interrupted request gets (lock held): a
        poisoned pool answers the typed, retryable :class:`PoolPoisoned`
        with a retry-after hint (the supervisor's measured one, else
        ``retry_after_s``, else the taxonomy's default)."""
        if self._poison is not None:
            hint = None
            if self.retry_after_hint is not None:
                try:
                    hint = self.retry_after_hint()
                except Exception:
                    hint = None
            if hint is None:
                hint = self._retry_after_s
            e = PoolPoisoned(
                f"serving pool is poisoned ({self._degraded_reason}); "
                f"queue depth [{self._sched.depth_text_locked()}]; "
                f"retry against the recovered or rescheduled pod",
                **({} if hint is None else {"retry_after_s": hint}),
            )
            e.__cause__ = self._poison
            return e
        return ServerClosed(
            "server is draining" if self._draining
            else "server is shut down")

    def _start(self, prompt, n_new: int, timeout: float, sampling,
               stream: bool, priority: str = "interactive",
               deadline_ms: int | None = None,
               stop_token: int | None = None,
               request_id: str = "") -> _Request:
        if not prompt or n_new < 1:
            raise ValueError("need a non-empty prompt and n_new >= 1")
        if stop_token is not None and stop_token < 0:
            raise ValueError("stop_token must be >= 0 (or None)")
        self._sched.rank(priority)  # unknown classes fail fast
        if deadline_ms is not None and deadline_ms < 1:
            raise ValueError("deadline_ms must be >= 1")
        total = len(prompt) + n_new
        if total > self._cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + n_new ({n_new}) exceeds the "
                f"model's max_seq ({self._cfg.max_seq})"
            )
        pages_needed = self._pages_needed(
            total, self._spec > 0 and sampling is None)
        if pages_needed > self._cache.max_pages_per_seq:
            raise ValueError(
                f"request needs {pages_needed} pages > max_pages_per_seq "
                f"= {self._cache.max_pages_per_seq}"
            )
        if pages_needed > self._pages_total:
            raise ValueError(
                f"request needs {pages_needed} pages > pool size "
                f"{self._pages_total}"
            )
        if sampling is not None:
            key, temperature, top_p = sampling
            key = np.asarray(key, np.uint32).reshape(2)
            sampling = (key, float(temperature), float(top_p))
        req = _Request(
            prompt=[int(t) for t in prompt], n_new=n_new, sampling=sampling,
            stop_token=-1 if stop_token is None else int(stop_token),
            pages_reserved=pages_needed,
            stream=queue.SimpleQueue() if stream else None,
            pclass=priority,
            rid=request_id,
            # Sampled once here: every span of the request shares fate.
            trace=(self.tracer is not None
                   and self.tracer.sampled(request_id)),
            t_submit=time.perf_counter(),
        )
        deadline = time.monotonic() + timeout
        if deadline_ms is not None:
            deadline = min(deadline, time.monotonic() + deadline_ms / 1000.0)
        with self._work:
            if self._closed or self._draining:
                raise self._refusal()
            # Shed BEFORE parking: by the queue watermarks, then by the
            # page low watermark at the arrival's marginal price (its
            # private budget plus the lease units its shared prefix
            # pages would newly pin).
            shed = self._sched.shed_check_locked(priority, deadline_ms,
                                                 rid=request_id)
            if shed is None:
                self._prefix_lookups += 1
                _, shared0, st0, _ = self._prefix_lookup(req.prompt)
                shed = self._page_shed_locked(
                    priority,
                    self._admission_price_locked(pages_needed, shared0, st0))
            if shed is not None:
                hint = shed["retry_after_s"]
                raise ServerOverloaded(
                    f"request shed: {shed['reason']}; "
                    f"{self._capacity_text_locked()}; queue depth "
                    f"[{self._sched.depth_text_locked()}]"
                    + (f"; retry after ~{hint:.1f}s" if hint is not None
                       else ""),
                    retry_after_s=hint,
                )
            # Ticketed admission: park on a per-class FIFO ticket and wait
            # on the ticket's own condition; only the policy head takes
            # capacity, and the decode loop may preempt a lower class for
            # it at a boundary.
            ticket = self._sched.enqueue_locked(req, priority, pages_needed)
            req.ticket_no = ticket.no
            self.requests_queued += 1
            if (not self._free_slots
                    or self._reserved + pages_needed > self._pages_total):
                # Actually parking: wake the decode loop so its next
                # boundary can consider a preemption for this ticket.
                self._work.notify_all()
            try:
                while True:
                    if self._closed or self._draining:
                        raise self._refusal()
                    if req.cancelled:
                        raise RequestCancelled(
                            "request cancelled while queued for admission"
                        )
                    # Re-priced each wake (the trie changes while the
                    # ticket parks). A prefix-hot ticket may pass a head
                    # starved for capacity, within the bypass cap.
                    _, shared_w, st_w, _ = self._prefix_lookup(req.prompt)
                    price = self._admission_price_locked(
                        pages_needed, shared_w, st_w)
                    ticket.hot = st_w > 0
                    head = self._sched.head_locked()
                    at_head = head is ticket
                    if not at_head and ticket.hot:
                        at_head = (
                            head is not None
                            and (not self._free_slots
                                 or self._reserved + head.pages_needed
                                 > self._pages_total)
                            and self._sched.bypass_ok_locked(ticket)
                        )
                    if (at_head and self._free_slots
                            and self._reserved + price <= self._pages_total
                            and self._ensure_bucket_locked()):
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ServerBusy(
                            "no page capacity within the timeout "
                            f"({len(self._active)} requests in flight; "
                            f"{self._capacity_text_locked()}; queue depth "
                            f"[{self._sched.depth_text_locked()}])"
                        )
                    ticket.cond.wait(timeout=remaining)
                self._sched.admit_locked(ticket)
                ticket = None  # admitted: the finally must not remove it
            finally:
                if ticket is not None:
                    self._sched.remove_locked(ticket)
            req.admit_seq = self._sched.next_admit_seq_locked()
            req.t_admit = time.perf_counter()
            self._hist_queue.observe((req.t_admit - req.t_submit) * 1e3)
            slot = heapq.heappop(self._free_slots)
            # Start the table on the cached prefix's read-only pages
            # (promoting a deeper host-tier match first, best effort),
            # evict registry pins (never the donor) until the free list
            # covers the private budget, and COW a shared partial page
            # before the suffix prefill writes into it.
            donor, shared, shared_tokens, host_node = \
                self._prefix_lookup(req.prompt)
            if host_node is not None:
                got = self._promote_host_locked(host_node, {donor})
                if got is not None:
                    donor, shared, shared_tokens = got
            page = self._cache.page_size
            partial = shared_tokens % page != 0
            shared_full = tuple(shared[:-1] if partial else shared)
            private = pages_needed - len(shared_full)
            self._reserved += private
            self._lease_take_locked(shared_full)
            req.pages_reserved = private
            req.shared_pages = shared_full
            if shared_full:
                # The journal shadow's key: for a partial (COW) match the
                # donor is one level deeper than the shared path.
                req.prefix_node = (self._prefix_nodes[donor]["parent"][0]
                                   if partial else donor)
            try:
                self._evict_prefixes_for(private, {donor})
                self._cache.admit(slot, len(req.prompt), shared)
                if partial and self._cache.cow_page(
                        slot, len(shared) - 1) is not None:
                    self._prefix_cow_copies += 1
            except Exception:
                self._release_locked(slot, private, req.shared_pages)
                req.shared_pages = ()
                req.prefix_node = None
                raise
            self._prefilling += 1
            if shared_tokens:
                self._prefix_hits += 1
                self._prefix_tokens_saved += shared_tokens
        # Chunked prefill from the first token past the cached prefix,
        # the lock held per chunk: the decode loop runs windows for
        # in-flight requests between chunks (this slot is not active
        # yet, so they never touch it).
        chunk = self._prefill_chunk or len(req.prompt)
        activated = False
        t_prefill = time.perf_counter()
        try:
            logits = None
            off = shared_tokens
            while off < len(req.prompt):
                piece = req.prompt[off:off + chunk]
                with self._work:
                    if self._closed:
                        raise self._refusal()
                    if req.cancelled:
                        raise RequestCancelled("request cancelled during "
                                               "prefill")
                    t0 = time.perf_counter()
                    # The chunk's logits are this request's own (the cache
                    # copies them out of the graph's static output), so
                    # the pick below may take another lock hold.
                    logits = self._cache.prefill_chunk(self._params, slot,
                                                       piece, off)
                    self._prefill_s += time.perf_counter() - t0
                off += len(piece)
            with self._work:
                if self._closed:
                    raise self._refusal()
                t0 = time.perf_counter()
                req.next_token = req.pick(logits, 0)
                t_first = time.perf_counter()
                self._prefill_s += t_first - t0
                # Time to first token: submit to the pick of the first
                # token (its emission rides the next loop iteration).
                req.t_first = t_first
                self._hist_ttft.observe((t_first - req.t_submit) * 1e3)
                if req.trace:
                    self.tracer.span(
                        "prefill", "serve", t_prefill, t_first, rid=req.rid,
                        args={"prompt": len(req.prompt),
                              "shared": shared_tokens,
                              "class": req.pclass})
                self._active[slot] = req
                self._note_finish_candidate_locked(slot, req)
                self._prefilling -= 1
                activated = True
                # The prefilled prompt's page-aligned prefixes are now
                # reusable K/V: pin and register them.
                self._register_prefixes(req.prompt,
                                        self._cache.slot_pages(slot))
                self._work.notify_all()  # wake the decode loop
        except Exception as e:
            with self._work:
                if not activated:
                    self._prefilling -= 1
                    self._release_locked(slot, req.pages_reserved,
                                         req.shared_pages)
                    req.shared_pages = ()
                    req.prefix_node = None
                if isinstance(e, ServingFailure) and not e.retryable:
                    # A terminal failure on the submit path kills the
                    # pool for everyone: poison co-tenants now.
                    self._poison_locked(e)
            raise
        return req

    # ---- capacity semantics ----------------------------------------------

    def _capacity_text_locked(self) -> str:
        """Page-capacity terms for refusal messages."""
        free = self._pages_total - self._reserved
        return (f"{free}/{self._pages_total} pages unreserved, "
                f"bucket {self._cache.bucket}/{self._cache.slots} rows")

    def _page_shed_locked(self, priority: str,
                          pages_needed: int) -> dict | None:
        """Low-watermark page shed: None (park) or a shed record in the
        scheduler's shape. The top class never page-sheds: preemption
        frees pages for it."""
        if not self._page_low_wm or self._sched.rank(priority) == 0:
            return None
        free_after = self._pages_total - self._reserved - pages_needed
        if free_after >= self._page_low_wm * self._pages_total:
            return None
        self._sched.shed += 1
        return {
            "reason": (
                f"free-page headroom below the low watermark "
                f"({free_after} of {self._pages_total} pages would "
                f"stay unreserved, watermark {self._page_low_wm:.0%})"
            ),
            "retry_after_s": None,
        }

    def _resume_pages_ok_locked(self, pages_needed: int) -> bool:
        """High-watermark resume gate: swap back in only when that leaves
        free-page headroom at or above the high watermark (hysteresis
        against preempt/resume thrash)."""
        if not self._page_high_wm:
            return True
        free_after = self._pages_total - self._reserved - pages_needed
        return free_after >= self._page_high_wm * self._pages_total

    def _ensure_bucket_locked(self) -> bool:
        """Admission's bucket clause: True iff a free slot inside the
        current device bucket exists. When every free slot lies above
        the bucket, resize at once if nothing is in flight (the serial
        loop, or an idle pipeline); otherwise flag the step-up for the
        decode loop's next boundary and keep the caller parked (the
        resize wakes it)."""
        if self._free_slots and self._free_slots[0] < self._cache.bucket:
            return True
        if not self._free_slots:
            return False
        # With nothing dispatched the resize is safe here: the loop's
        # next dispatch at a boundary feeds host tokens, so the carry
        # set_bucket drops was dead anyway.
        if self._inflight is None and not self._cache.spec_pending():
            self._cache.set_bucket(
                self._cache.bucket_for(self._free_slots[0] + 1))
            return True
        self._bucket_step_wanted = True
        self._work.notify_all()
        return False

    def _maybe_step_bucket_locked(self) -> None:
        """Resize the device batch dim at a boundary: UP when an
        admission parked on a row above the bucket, DOWN when the
        occupied slots have drained out of the bucket's top half and
        nothing is queued. Nothing in flight; a no-op with bucketing
        off."""
        if not self._cache.min_bucket or self._inflight is not None:
            return
        if self._cache.spec_pending():
            return
        bucket = self._cache.bucket
        want = self._cache.rows_in_use()
        if self._bucket_step_wanted and self._free_slots:
            want = max(want, self._free_slots[0] + 1)
        self._bucket_step_wanted = False
        target = self._cache.bucket_for(want)
        if target > bucket or (target < bucket
                               and self._sched.head_locked() is None):
            self._cache.set_bucket(target)
            self._sched.wake_head_locked()
            self._work.notify_all()

    # ---- the prefix registry (lock held for every method here) ----------

    def _prefix_lookup(self, prompt: list[int]):
        """``(donor_node, pages, shared_tokens, host_node)`` of the best
        cached prefix, capped at ``len(prompt) - 1`` so at least one
        token prefills and yields the first logits. Whole page-sized
        blocks walk the trie; from the deepest node a PARTIAL last block
        is matched against the children's entries by their longest
        common prefix (the admission then copies that page on write).
        ``host_node`` is the deepest host-tier entry strictly deeper
        than the match."""
        if not self._prefix_enabled:
            return None, (), 0, None
        page = self._cache.page_size
        node, depth = 0, 0
        best = (None, (), 0)
        host = None
        for k in range(1, (len(prompt) - 1) // page + 1):
            block = tuple(prompt[(k - 1) * page:k * page])
            child = self._prefix_nodes[node]["edges"].get(block)
            if child is None:
                break
            node, depth = child, k
            rec = self._prefix_nodes[node]
            if rec["entry"] is not None:
                rec["entry"]["last_used"] = time.monotonic()
                best = (node, tuple(rec["entry"]["pages"]), k * page)
            if rec["host"] is not None:
                host = (node, k)
        cap = len(prompt) - 1 - depth * page
        if cap > 0:
            tail = prompt[depth * page:(depth + 1) * page]
            best_ov = 0
            for block, child in self._prefix_nodes[node]["edges"].items():
                entry = self._prefix_nodes[child]["entry"]
                if entry is None:
                    continue
                ov = 0
                for a, b in zip(tail, block):
                    if a != b:
                        break
                    ov += 1
                ov = min(ov, cap)
                if ov > best_ov:
                    best_ov = ov
                    entry["last_used"] = time.monotonic()
                    best = (child, tuple(entry["pages"][:depth + 1]),
                            depth * page + ov)
        host_node = None
        if host is not None and host[1] * page > best[2]:
            host_node = host[0]
        return best[0], best[1], best[2], host_node

    def _admission_price_locked(self, pages_needed: int, shared,
                                shared_tokens: int) -> int:
        """The marginal page cost of an arrival whose lookup matched
        ``shared``: its private budget (a COW copy counts as private)
        plus one lease unit per full shared page no live request leases
        yet."""
        page = self._cache.page_size
        full = (shared[:-1] if shared and shared_tokens % page else shared)
        new_leases = sum(1 for p in full if p not in self._lease)
        return pages_needed - len(full) + new_leases

    def _trie_child(self, node: int, block: tuple) -> int:
        """The trie child for ``block`` under ``node``, created if
        absent."""
        child = self._prefix_nodes[node]["edges"].get(block)
        if child is None:
            child = self._prefix_next_id
            self._prefix_next_id += 1
            self._prefix_nodes[node]["edges"][block] = child
            self._prefix_nodes[child] = {
                "parent": (node, block), "edges": {}, "entry": None,
                "host": None,
            }
        return child

    def _node_tokens(self, node: int) -> list[int]:
        """A trie node's full token path."""
        blocks = []
        cur = node
        while cur != 0:
            parent_id, block = self._prefix_nodes[cur]["parent"]
            blocks.append(block)
            cur = parent_id
        return [t for block in reversed(blocks) for t in block]

    def _register_prefixes(self, prompt: list[int],
                           pages: list[int]) -> None:
        """Pin every page-aligned prefix of committed tokens. Only full
        pages covered by ``prompt`` register; later writes land past
        them (a shared partial page is copied before its first write),
        so registered pages are immutable."""
        if not self._prefix_enabled:
            return
        page = self._cache.page_size
        node = 0
        for k in range(1, len(prompt) // page + 1):
            block = tuple(prompt[(k - 1) * page:k * page])
            node = self._trie_child(node, block)
            if self._prefix_nodes[node]["entry"] is None:
                held = list(pages[:k])
                self._cache.retain_pages(held)
                entry = {"pages": held, "last_used": time.monotonic()}
                self._prefix_nodes[node]["entry"] = entry
                self._prefix_entry_nodes[node] = entry
                self._prefix_registrations += 1
                if self._prefix_nodes[node]["host"] is not None:
                    # The live pages supersede the host copy (the bytes
                    # are the same); keeping both would bill twice.
                    self._drop_host_record_locked(node)

    def _insert_prefix_entry(self, tokens: list[int], pages) -> int:
        """Attach ONE registry entry holding ``pages`` at the trie node
        for ``tokens`` (whole blocks), creating path nodes as needed.
        The caller's page references (``allocate_pinned_page``, or a
        retain) BECOME the entry's pin. When the node already has an
        entry, that one stays and the caller's references are released.
        Returns the node id."""
        page = self._cache.page_size
        node = 0
        for k in range(1, len(tokens) // page + 1):
            node = self._trie_child(
                node, tuple(tokens[(k - 1) * page:k * page]))
        if self._prefix_nodes[node]["entry"] is not None:
            self._cache.release_pages(pages)
            return node
        entry = {"pages": list(pages), "last_used": time.monotonic()}
        self._prefix_nodes[node]["entry"] = entry
        self._prefix_entry_nodes[node] = entry
        self._prefix_registrations += 1
        if self._prefix_nodes[node]["host"] is not None:
            self._drop_host_record_locked(node)
        return node

    def _prune_prefix_upward(self, node: int) -> None:
        """Drop edge-less, entry-less, host-less nodes upward."""
        cur = node
        while cur != 0:
            rec = self._prefix_nodes[cur]
            if (rec["entry"] is not None or rec["host"] is not None
                    or rec["edges"]):
                break
            pid, block = rec["parent"]
            del self._prefix_nodes[cur]
            del self._prefix_nodes[pid]["edges"][block]
            cur = pid

    def _evict_prefix_node(self, node: int, cause: str) -> None:
        """Unpin one pool entry, demoting its bytes to the host tier when
        the budget allows, and prune upward; ``cause`` feeds the
        eviction counters."""
        entry = self._prefix_entry_nodes.pop(node)
        self._prefix_evictions[cause] += 1
        rec = self._prefix_nodes[node]
        rec["entry"] = None
        if self._prefix_host_budget and rec["host"] is None:
            self._demote_prefix_locked(node, entry)
        self._cache.release_pages(entry["pages"])
        self._prune_prefix_upward(node)

    def _demote_prefix_locked(self, node: int, entry: dict) -> None:
        """Move an evicted entry's pages to the host tier as the verbatim
        swap-out bytes. An oversize record drops; host-LRU eviction makes
        room otherwise. Best effort: a failing copy drops the entry."""
        try:
            arrays = self._cache.swapout_pages(entry["pages"])
        except Exception:
            return
        nbytes = sum(a.nbytes for a in arrays)
        if nbytes > self._prefix_host_budget:
            self._prefix_evictions["host_over"] += 1
            return
        while self._prefix_host_bytes + nbytes > self._prefix_host_budget:
            lru = min(self._prefix_host_nodes,
                      key=lambda n: self._prefix_host_nodes[n]["last_used"])
            self._prefix_evictions["host_lru"] += 1
            self._drop_host_record_locked(lru)
        rec = {"arrays": arrays, "nbytes": nbytes,
               "npages": len(entry["pages"]),
               "last_used": entry["last_used"]}
        self._prefix_nodes[node]["host"] = rec
        self._prefix_host_nodes[node] = rec
        self._prefix_host_bytes += nbytes
        self._prefix_demotions += 1

    def _drop_host_record_locked(self, node: int) -> None:
        """Forget a host-tier record and un-bill its bytes."""
        rec = self._prefix_host_nodes.pop(node)
        self._prefix_host_bytes -= rec["nbytes"]
        self._prefix_nodes[node]["host"] = None
        self._prune_prefix_upward(node)

    def _promote_host_locked(self, node: int, keep) -> tuple | None:
        """Swap a host-tier entry back into fresh pinned pages at an
        admission hit. Returns ``(node, pages, shared_tokens)``, or None
        when the free list cannot cover it after an LRU sweep of colder
        entries (never ``keep``): promotion never fails an admission."""
        rec = self._prefix_host_nodes.get(node)
        if rec is None:
            return None
        n = rec["npages"]
        self._evict_prefixes_for(n, keep)
        if (self._prefix_host_nodes.get(node) is not rec
                or self._cache.free_pages() < n):
            # The sweep's own demotions may have pushed this record out
            # of the host budget (host LRU).
            return None
        pages = [self._cache.allocate_pinned_page() for _ in range(n)]
        try:
            self._cache.swapin_pages(pages, rec["arrays"])
        except Exception:
            self._cache.release_pages(pages)
            raise
        entry = {"pages": pages, "last_used": time.monotonic()}
        self._prefix_nodes[node]["entry"] = entry
        self._prefix_entry_nodes[node] = entry
        self._prefix_nodes[node]["host"] = None
        self._prefix_host_nodes.pop(node)
        self._prefix_host_bytes -= rec["nbytes"]
        self._prefix_promotions += 1
        self._prefix_registrations += 1
        return node, tuple(pages), n * self._cache.page_size

    def _evict_prefixes_for(self, needed_free: int, keep=()) -> None:
        """Evict LRU registry entries (never one in ``keep``) until the
        free list covers ``needed_free`` pages."""
        while (self._cache.free_pages() < needed_free
               and any(n not in keep for n in self._prefix_entry_nodes)):
            victim = min(
                (n for n in self._prefix_entry_nodes if n not in keep),
                key=lambda n: self._prefix_entry_nodes[n]["last_used"],
            )
            self._evict_prefix_node(victim, "admission")

    def _relieve_pool_pressure_locked(self, needed: int = 1) -> bool:
        """The cache's callback when an allocation (admit, grow, COW)
        finds the free list short: evict LRU registry pins (demoting to
        the host tier when configured). True iff ``needed`` pages are
        free now."""
        while (self._prefix_entry_nodes
               and self._cache.free_pages() < needed):
            victim = min(
                self._prefix_entry_nodes,
                key=lambda n: self._prefix_entry_nodes[n]["last_used"],
            )
            self._evict_prefix_node(victim, "pressure")
        return self._cache.free_pages() >= needed

    # ---- prefix persistence ----------------------------------------------

    # The registry outlives the pod: dump writes the tokens and K/V of
    # every pool-resident entry to an .npz (a JSON doc and fp32 K/V, no
    # framework in it, so the JAX package's server reads it too, and
    # writes what this one reads); load re-pins them into a fresh
    # server. K/V are valid only for the params that made them: the
    # caller's fingerprint names them, and a file with another one is
    # ignored.

    def dump_prefix_cache(self, path: str, fingerprint: str) -> int:
        """Write the registry's pool-resident entries to ``path``. Returns
        the entries written (0 = none registered, no file touched). Only
        the pages' device gather runs under the lock; the copy to the
        host (as stored: int8 and its scales for an int8 pool), the
        dequantization to fp32 and the file's write run outside it, and
        the file lands by an atomic ``os.replace`` of a temporary of its
        own."""
        with self._work:
            entries = [
                {"tokens": self._node_tokens(node),
                 "pages": list(entry["pages"])}
                for node, entry in self._prefix_entry_nodes.items()
            ]
            if not entries:
                return 0
            page_ids = sorted({p for e in entries for p in e["pages"]})
            snapshot = self._cache.snapshot_pages(page_ids)
        pool_k, pool_v = (t.numpy() for t in
                          self._cache.snapshot_to_host(snapshot))
        doc = {"fingerprint": fingerprint,
               "page_size": self._cache.page_size,
               "entries": entries, "page_ids": page_ids}
        # A temporary of this dump's own (the periodic dump and the one
        # after close may overlap), written under no lock and moved in
        # whole; a failed write removes it.
        tmp = f"{path}.{os.getpid()}-{next(self._dump_seq)}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, doc=np.frombuffer(json.dumps(doc).encode(),
                                              np.uint8),
                         pool_k=pool_k, pool_v=pool_v)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return len(entries)

    def load_prefix_cache(self, path: str, fingerprint: str) -> int:
        """Re-pin a dumped registry into this fresh server; returns the
        entries loaded. 0, with the reason printed, when the file is
        absent, unreadable or stale (another fingerprint or page size),
        or the registry already holds entries (boot time only). Entries
        load ancestors first, so nested prefixes share pages as they did
        live, with one reference per entry per page; an entry whose new
        pages the free list cannot cover is skipped, later ones still
        load, and nothing is evicted."""
        if not os.path.exists(path):
            return 0
        try:
            with np.load(path) as data:
                # The doc first: a stale file's K/V are never read.
                doc = json.loads(bytes(data["doc"]).decode())
                if (doc.get("fingerprint") != fingerprint
                        or doc.get("page_size") != self._cache.page_size):
                    print(f"[kvedge-serve] ignoring stale prefix cache "
                          f"{path} (fingerprint/page-size changed)",
                          flush=True)
                    return 0
                pool_k, pool_v = data["pool_k"], data["pool_v"]
        except Exception as e:  # a torn or foreign file: start cold
            print(f"[kvedge-serve] ignoring unreadable prefix cache "
                  f"{path}: {e!r}", flush=True)
            return 0
        old_pos = {p: i for i, p in enumerate(doc["page_ids"])}
        loaded = 0
        with self._work:
            if (not self._prefix_enabled or self._closed
                    or self._prefix_entry_nodes):
                return 0
            remap: dict[int, int] = {}
            writes: list[tuple[int, int]] = []  # (new id, dump position)
            for e in sorted(doc["entries"], key=lambda e: len(e["tokens"])):
                fresh = {p for p in e["pages"] if p not in remap}
                if len(fresh) > self._cache.free_pages():
                    continue
                for p in sorted(fresh):
                    new = self._cache.allocate_pinned_page()
                    remap[p] = new
                    writes.append((new, old_pos[p]))
                # A fresh page's count 1 is this entry's pin; a page an
                # earlier entry loaded takes one more.
                self._cache.retain_pages(
                    [remap[p] for p in e["pages"] if p not in fresh])
                self._insert_prefix_entry(
                    e["tokens"], [remap[p] for p in e["pages"]])
                loaded += 1
            if writes:
                pos = [i for _, i in writes]
                self._cache.write_pages([w for w, _ in writes],
                                        pool_k[:, pos], pool_v[:, pos])
        return loaded

    def start_prefix_persistence(self, path: str, fingerprint: str,
                                 interval: float = 30.0) -> None:
        """Dump the registry to ``path`` every ``interval`` seconds while
        entries have registered since the last dump, so a pod killed
        without a drain keeps its warm prefixes. A daemon thread, which
        holds the server lock only inside each dump; :meth:`close` stops
        it. Once per server."""
        if self._persist_stop is not None:
            raise RuntimeError("prefix persistence already started")
        self._persist_stop = threading.Event()
        # Also the target of a poisoned pool's emergency dump.
        self._persist_path, self._persist_fp = path, fingerprint

        def loop() -> None:
            dumped_at = 0
            while not self._persist_stop.wait(interval):
                with self._work:
                    registered = self._prefix_registrations
                if registered == dumped_at:
                    continue
                try:
                    self.dump_prefix_cache(path, fingerprint)
                    dumped_at = registered
                except Exception as e:  # a dump never stops serving
                    print(f"[kvedge-serve] periodic prefix-cache dump "
                          f"failed: {e!r}", flush=True)

        self._persist_thread = threading.Thread(
            target=loop, name="kvedge-torch-prefix-persist", daemon=True)
        self._persist_thread.start()

    # ---- finishing -------------------------------------------------------

    def _lease_take_locked(self, pages) -> None:
        """One lease per shared page: the FIRST sharer books its
        reservation unit, later sharers ride it."""
        for p in pages:
            n = self._lease.get(p, 0)
            self._lease[p] = n + 1
            if n == 0:
                self._reserved += 1

    def _lease_drop_locked(self, pages) -> None:
        """A page's reservation unit frees with its LAST live sharer."""
        for p in pages:
            n = self._lease[p] - 1
            if n:
                self._lease[p] = n
            else:
                del self._lease[p]
                self._reserved -= 1

    def _release_locked(self, slot: int, pages: int,
                        shared: tuple = ()) -> None:
        """Return a slot, its PRIVATE reservation ``pages`` and the leases
        of its ``shared`` prefix pages; wake the policy head."""
        if self._cache.is_admitted(slot):
            self._cache.release(slot)
        heapq.heappush(self._free_slots, slot)
        self._reserved -= pages
        self._lease_drop_locked(shared)
        self._sched.wake_head_locked()
        self._work.notify_all()

    def _finish_request_locked(self, slot: int, req: _Request) -> None:
        """The one exit of a normal finish: the decode and ITL
        histograms, the completion counters, the decode span, the
        multi-turn registration and the release."""
        t1 = time.perf_counter()
        if req.t_admit:
            self._hist_decode.observe((t1 - req.t_admit) * 1e3)
        self._done_total += 1
        self._tokens_done_total += len(req.generated)
        if req.t_first and len(req.generated) > 1:
            self._hist_itl.observe(
                (t1 - req.t_first) * 1e3 / (len(req.generated) - 1))
        if req.trace:
            self.tracer.span("decode", "serve", req.t_admit or t1, t1,
                             rid=req.rid,
                             args={"tokens": len(req.generated),
                                   "class": req.pclass})
        del self._active[slot]
        self._journal.pop(req)  # a finished request never resumes
        if self._prefix_enabled:
            # Multi-turn reuse: the slot's committed K/V (prompt AND
            # generated) registers before the release drops its pages,
            # clamped to the committed length so drafts and a deferred
            # stop's scribbles are never pinned.
            tokens = (req.prompt + req.generated)[
                :self._cache.slot_length(slot)]
            self._register_prefixes(tokens, self._cache.slot_pages(slot))
        self._release_locked(slot, req.pages_reserved, req.shared_pages)
        if req.stream is not None:
            req.stream.put(_STREAM_DONE)
        req.done.set()

    @staticmethod
    def _emit(req: _Request, token: int) -> None:
        """Record a generated token and stream it. After a journal
        restore, indices below ``stream_resume_at`` are the replay of
        tokens the consumer already has: recorded, not streamed again."""
        idx = len(req.generated)
        req.generated.append(token)
        if req.stream is not None and idx >= req.stream_resume_at:
            req.stream.put(token)

    @staticmethod
    def _emit_many(req: _Request, tokens: list) -> None:
        """Bulk :meth:`_emit`: a harvested row's tokens in one extend,
        with the same exactly-once watermark."""
        if not tokens:
            return
        idx = len(req.generated)
        req.generated.extend(tokens)
        if req.stream is not None:
            skip = req.stream_resume_at - idx
            for token in (tokens[skip:] if skip > 0 else tokens):
                req.stream.put(token)

    def _note_finish_candidate_locked(self, slot: int, req: _Request) -> None:
        """Register a slot whose pending token completes the request
        (budget filled or stop token) for the boundary sweep."""
        if (req.stopped or len(req.generated) + 1 >= req.n_new
                or req.next_token == req.stop_token):
            self._finish_ready.add(slot)

    def _finish_stopped_locked(self, slot: int, req: _Request) -> None:
        """Complete a stop-terminated row (its stream already ends in the
        stop token). If the window in flight still touches the slot, its
        pages are still being written on the device: mark the row
        stopped, force a boundary, and let the sweep finish it there."""
        self._stop_finishes += 1
        rec = self._inflight
        if rec is not None and any(s == slot for s, _, _ in rec["parts"]):
            req.stopped = True
            self._finish_ready.add(slot)
            self._stops_pending += 1
            return
        self._finish_request_locked(slot, req)

    def _sweep_finished_locked(self) -> None:
        """A request whose pending token completes its budget, or IS its
        stop token, needs no step: emit it and finish before the batch. A
        deferred stop finish (``req.stopped``) completes here too."""
        for slot in sorted(self._finish_ready):
            req = self._active.get(slot)
            if req is None or req.cancelled:
                continue
            if req.stopped:
                self._finish_request_locked(slot, req)
            elif len(req.generated) + 1 >= req.n_new:
                self._emit(req, req.next_token)
                self._finish_request_locked(slot, req)
            elif req.next_token == req.stop_token:
                self._emit(req, req.next_token)
                self._stop_finishes += 1
                self._finish_request_locked(slot, req)
        self._finish_ready.clear()
        # This sweep is the boundary the pending stops asked for.
        self._stops_pending = 0

    def _sweep_cancelled_locked(self) -> None:
        for slot in list(self._active):
            req = self._active[slot]
            if not req.cancelled:
                continue
            del self._active[slot]
            self._journal.pop(req)  # a cancelled request never resumes
            self._release_locked(slot, req.pages_reserved, req.shared_pages)
            req.error = RequestCancelled("request cancelled mid-decode")
            if req.stream is not None:
                req.stream.put(req.error)
            req.done.set()

    def _fail_active_locked(self, error: Exception) -> None:
        for req in self._active.values():
            req.error = error
            if req.stream is not None:
                req.stream.put(error)
            req.done.set()
        self._active.clear()

    # ---- degraded mode: poison, checkpoints, revive ---------------------

    def _poison_locked(self, failure: ServingFailure) -> None:
        """Poison the pool (lock held): a request with a journal
        checkpoint parks (its waiter stays blocked, its stream quiet)
        for :meth:`revive`; every other in-flight waiter gets the typed
        failure; the degraded flag flips for stats and /healthz; and
        admission waiters wake into :meth:`_refusal`. The exiting decode
        loop runs :meth:`_degrade` outside the lock."""
        if self._poison is None:
            self._poison = failure
            self._degraded_reason = f"{type(failure).__name__}: {failure}"
            self._prebucket = self._cache.bucket
        survivors = failed = 0
        for req in self._active.values():
            if self._divert_to_journal_locked(req):
                survivors += 1
                continue
            failed += 1
            req.error = failure
            if req.stream is not None:
                req.stream.put(failure)
            req.done.set()
        self._active.clear()
        # A swapped-out request's host snapshot is a ready checkpoint
        # under its original ticket: with checkpoints on it moves into
        # the journal, otherwise it fails like an active one.
        for entry in self._sched.take_swapped_locked():
            if self._journal_swapped_locked(entry):
                survivors += 1
                continue
            failed += 1
            entry.req.error = failure
            if entry.req.stream is not None:
                entry.req.stream.put(failure)
            entry.req.done.set()
        if self.tracer is not None:
            # The instant the post-mortem's trace tail is anchored on.
            self.tracer.event("poison", "failure",
                              args={"type": type(failure).__name__,
                                    "failed": failed,
                                    "journaled": survivors})
        self._closed = True
        self._sched.wake_all_locked()
        self._work.notify_all()

    def _degrade(self) -> None:
        """Run once by the exiting decode loop, OUTSIDE the lock: dump the
        prefix registry if the pool is still readable (a device left
        unusable raises before the temporary file is opened, so the dump
        is skipped, never torn), then call the ``on_degraded`` observer."""
        if self._persist_path is not None and self._prefix_entry_nodes:
            try:
                n = self.dump_prefix_cache(self._persist_path,
                                           self._persist_fp)
                print(f"[kvedge-serve] degraded: emergency prefix dump "
                      f"wrote {n} entries", flush=True)
            except Exception as e:
                print(f"[kvedge-serve] degraded: emergency prefix dump "
                      f"skipped ({e!r})", flush=True)
        cb = self.on_degraded
        if cb is not None:
            try:
                cb(self._degraded_reason, self._poison)
            except Exception as e:  # observers never re-poison teardown
                print(f"[kvedge-serve] on_degraded observer failed: "
                      f"{e!r}", flush=True)

    def _maybe_checkpoint_locked(self) -> None:
        """Quiescent-boundary durability hook (lock held, nothing in
        flight): audit the page books when asked, then every
        ``checkpoint_every`` clock ticks journal each live request's
        resumable state. A request whose (gen_len, next_token) match its
        standing entry keeps it (decode only appends). Every page the
        boundary needs rides ONE ``swapout_pages`` call, sliced per entry
        into tensors of its own, so each entry counts the bytes it
        holds; ``saved_len`` covers the committed positions and the
        pending token is kept on the host, the preempt/resume contract."""
        if self._debug_pages:
            self._audit_pages_locked()
        if not self._checkpoint_every:
            return
        self._ckpt_clock += 1
        if self._ckpt_clock < self._checkpoint_every:
            return
        self._ckpt_clock = 0
        if not self._active:
            return
        t0 = time.perf_counter()
        jobs = []       # (req, saved_len, shared pages, node, own span)
        all_ids: list[int] = []
        new_shadow_spans: dict = {}   # node -> (start, n)
        for slot, req in self._active.items():
            if req.cancelled:
                continue
            saved_len = len(req.prompt) + len(req.generated)
            prev = self._journal.get(req)
            if (prev is not None
                    and prev.gen_len == len(req.generated)
                    and prev.next_token == req.next_token):
                self._checkpoints_unchanged += 1
                continue
            n_pages = -(-saved_len // self._cache.page_size)
            ids = self._cache.slot_pages(slot)[:n_pages]
            sh_n = len(req.shared_pages)
            shared = req.prefix_node is not None and sh_n
            own_ids = ids[sh_n:] if shared else ids
            own_span = (len(all_ids), len(own_ids))
            all_ids.extend(own_ids)
            node = None
            if shared:
                node = req.prefix_node
                if (node not in self._prefix_shadow
                        and node not in new_shadow_spans):
                    new_shadow_spans[node] = (len(all_ids), sh_n)
                    all_ids.extend(ids[:sh_n])
            jobs.append((req, saved_len, sh_n if shared else 0, node,
                         own_span))
        if not jobs:
            return
        batch = self._cache.swapout_pages(all_ids) if all_ids else None

        def _slice(span):
            # [L, n_pages, ...] slabs: pages on axis 1. A copy, so the
            # entry does not pin the whole batch.
            start, n = span
            return tuple(a[:, start:start + n].clone() for a in batch)

        new_shadows = {node: _slice(span)
                       for node, span in new_shadow_spans.items()}
        for req, saved_len, sh_n, node, own_span in jobs:
            own = _slice(own_span)
            if node is not None:
                ok = self._checkpoint_shared_locked(
                    req, saved_len, sh_n, own, new_shadows.get(node))
            else:
                entry = JournalEntry(
                    req=req, pclass=req.pclass, ticket_no=req.ticket_no,
                    admit_seq=req.admit_seq,
                    pages_reserved=req.pages_reserved,
                    saved_len=saved_len, gen_len=len(req.generated),
                    next_token=req.next_token, emitted=len(req.generated),
                    arrays=own, nbytes=sum(a.nbytes for a in own),
                )
                ok = self._journal.put(req, entry)
            if ok:
                self._checkpoints_total += 1
            else:
                # Budget-refused: the request keeps its older entry, or
                # none.
                self._checkpoint_skipped += 1
        if self.tracer is not None:
            self.tracer.span("checkpoint", "serve", t0,
                             args={"live": len(self._active),
                                   "entries": len(self._journal),
                                   "bytes": self._journal.nbytes})

    def _checkpoint_shared_locked(self, req: _Request, saved_len: int,
                                  sh_n: int, own: tuple,
                                  sh_arrays: tuple | None) -> bool:
        """Checkpoint a request whose table starts on cached-prefix pages
        (lock held): the entry holds the request's OWN page bytes and a
        reference into a per-node shadow snapshot of the shared ones,
        taken once and refcounted across every entry citing it. Refs
        bump BEFORE ``put``, so the ``on_drop`` of a replaced entry
        citing the same node nets out."""
        node = req.prefix_node
        shadow = self._prefix_shadow.get(node)
        extra = 0
        if shadow is None:
            if sh_arrays is None:
                return False
            extra = sum(a.nbytes for a in sh_arrays)
            shadow = {"arrays": sh_arrays, "nbytes": extra, "refs": 0,
                      "npages": sh_n}
            self._prefix_shadow[node] = shadow
        shadow["refs"] += 1
        entry = JournalEntry(
            req=req, pclass=req.pclass, ticket_no=req.ticket_no,
            admit_seq=req.admit_seq, pages_reserved=req.pages_reserved,
            saved_len=saved_len, gen_len=len(req.generated),
            next_token=req.next_token, emitted=len(req.generated),
            arrays=own, nbytes=sum(a.nbytes for a in own),
            prefix_node=node, prefix_pages_n=sh_n,
            prefix_tokens=sh_n * self._cache.page_size,
        )
        if self._journal.put(req, entry, extra=extra):
            if extra:
                self._journal.adjust_extra(extra)
            return True
        shadow["refs"] -= 1
        if shadow["refs"] <= 0:
            # Created for this refused entry: unwind it, never billed.
            del self._prefix_shadow[node]
        return False

    def _journal_drop_locked(self, entry) -> None:
        """The journal's ``on_drop`` (lock held): the last entry citing a
        shadow snapshot releases its bytes from the budget."""
        node = entry.prefix_node
        if node is None:
            return
        shadow = self._prefix_shadow.get(node)
        if shadow is None:
            return
        shadow["refs"] -= 1
        if shadow["refs"] <= 0:
            del self._prefix_shadow[node]
            self._journal.adjust_extra(-shadow["nbytes"])

    def _audit_pages_locked(self) -> None:
        """Page conservation at a quiescent boundary (lock held): free +
        live == pages_total with clean books, else the typed
        :class:`PageAccountingError`, which the loop's failure path
        poisons the pool with."""
        acct = self._cache.page_accounting()
        if (acct["free"] + acct["live"] == acct["pages_total"]
                and not acct["free_dup"] and not acct["neg_refs"]
                and not acct["free_live"]):
            return
        raise PageAccountingError(
            f"page conservation violated at a quiescent boundary: "
            f"free={acct['free']} live={acct['live']} "
            f"total={acct['pages_total']} dup_free={acct['free_dup']} "
            f"neg_refs={acct['neg_refs']} "
            f"free_but_live={acct['free_live']}")

    def _divert_to_journal_locked(self, req: _Request) -> bool:
        """Poison-path diversion (lock held): True when ``req`` has a
        checkpoint to resume from. Every token in ``generated`` now was
        delivered already: the replay must not stream below that."""
        if req.cancelled:
            return False
        entry = self._journal.get(req)
        if entry is None:
            return False
        entry.emitted = max(entry.emitted, len(req.generated))
        return True

    def _journal_swapped_locked(self, entry) -> bool:
        """Move a swapped-out request's snapshot into the journal at
        poison time (lock held). False (the caller fails the request)
        when checkpoints are off, the request was cancelled, or the
        budget refuses the bytes."""
        if not self._checkpoint_every or entry.req.cancelled:
            entry.arrays = ()
            return False
        req = entry.req
        je = JournalEntry(
            req=req, pclass=entry.pclass, ticket_no=entry.no,
            admit_seq=req.admit_seq, pages_reserved=entry.pages_needed,
            saved_len=entry.saved_len, gen_len=len(req.generated),
            next_token=req.next_token, emitted=len(req.generated),
            arrays=entry.arrays, nbytes=entry.nbytes,
        )
        if not self._journal.put(req, je):
            self._checkpoint_skipped += 1
            entry.arrays = ()
            return False
        self._checkpoints_total += 1
        return True

    def _fail_journal_locked(self, err: Exception) -> None:
        """Fail every journaled waiter (lock held): the close of a pool
        that will never be revived."""
        for entry in self._journal.take_all():
            self._journal_drop_locked(entry)
            req = entry.req
            if req.done.is_set():
                continue
            req.error = err
            if req.stream is not None:
                req.stream.put(err)
            req.done.set()

    def revive(self, *, prefill_wait_s: float = 30.0) -> int:
        """Warm-restart a poisoned pool in place; returns the number of
        journaled requests re-admitted. Raises RuntimeError when the pool
        is not poisoned or its decode loop is still running.

        It first waits for the device to finish everything queued (every
        stream, the capture stream too): a window dispatched before the
        failure may still be writing the pool. A device left unusable (a
        sticky CUDA error) raises here, typed, before anything changes.
        Then the scrub: registry pins are evicted (their K/V are suspect;
        the emergency dump reloads them), every admitted slot released,
        the books reset. NOTHING is reallocated: the pools, tables,
        lengths and inputs keep their addresses, the carry and the upload
        memo are dropped, and the pre-poison bucket is set again, so
        every captured graph replays as before. Journaled requests then
        re-admit (:meth:`_restore_journal_locked`), transactionally."""
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            raise RuntimeError("decode loop still running; cannot revive")
        deadline = time.monotonic() + prefill_wait_s
        with self._work:
            if self._poison is None:
                raise RuntimeError("pool is not poisoned; nothing to revive")
            # Prefills caught mid-flight fail on their next cache call;
            # wait them out so none lands tokens into the reset pool.
            while self._prefilling > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"{self._prefilling} prefill(s) still in flight "
                        f"after {prefill_wait_s:g}s; cannot revive")
                self._work.wait(timeout=left)
            try:
                self._cache.wait_device()
            except Exception as e:
                raise PoolPoisoned(
                    f"the device is unusable after "
                    f"{self._degraded_reason}: {type(e).__name__}: {e}"
                ) from e
            for node in list(self._prefix_entry_nodes):
                # Never demoted: device K/V are suspect after a poison.
                # The host tier and the journal's shadows are host bytes
                # taken before the failure.
                self._evict_prefix_node(node, "revive")
            for slot in range(self._cache.slots):
                if self._cache.is_admitted(slot):
                    self._cache.release(slot)
            self._free_slots = list(range(self._cache.slots))
            self._reserved = 0
            self._lease.clear()
            self._bucket_step_wanted = False
            self._active.clear()
            self._inflight = None
            self._finish_ready.clear()
            self._stops_pending = 0
            self._cache.drop_carry()
            if self._cache.min_bucket:
                # The pre-poison bucket (floored at what the journal
                # needs): its graphs were captured already.
                rung = self._prebucket or self._cache.bucket_for(0)
                rung = max(rung, self._cache.bucket_for(len(self._journal)))
                self._cache.set_bucket(rung)
            self._sched.reset_locked()
            restored = self._restore_journal_locked()
            self._poison = None
            self._degraded_reason = None
            self._closed = False
            self._draining = False
            self._thread = threading.Thread(target=self._loop,
                                            name="kvedge-torch-serve",
                                            daemon=True)
            self._thread.start()
            if self.tracer is not None:
                # Same recorder, same timeline: the revive lands next to
                # the poison it heals.
                self.tracer.event("revive", "serve",
                                  args={"restored": restored})
            self._work.notify_all()
        return restored

    def _rewind_locked(self, req: _Request, entry) -> None:
        """Rewind ``req`` to its checkpoint (idempotent): ``generated``
        truncates to the checkpointed length, the pending token restores,
        and the delivered watermark arms :meth:`_emit`'s replay
        suppression. A stop found after the checkpoint is replay state."""
        req.stream_resume_at = max(req.stream_resume_at, entry.emitted)
        del req.generated[entry.gen_len:]
        req.next_token = entry.next_token
        req.inflight = 0
        req.stopped = False

    def _restore_journal_locked(self) -> int:
        """Re-admit every journaled request into the scrubbed pool (lock
        held, no decode loop yet): each rewinds to its checkpoint and
        takes a fresh slot with its page bytes swapped back in. A prefix
        reference re-materializes its shadow ONCE per node: the first
        restorer swaps it into freshly pinned pages and re-registers the
        entry, later citers lease those pages. A fault re-journals
        everything (restored rows too; the rewind is idempotent) and
        leaves the pool poisoned for the next attempt. Entries beyond
        the free slots go back to the swap set under their tickets."""
        entries = self._journal.take_all()
        all_drained = list(entries)
        node_pages: dict[int, tuple] = {}
        restored: list[tuple[int, JournalEntry]] = []
        t0 = time.perf_counter()
        try:
            while entries:
                entry = entries[0]
                req = entry.req
                if req.cancelled or req.done.is_set():
                    entries.pop(0)
                    continue
                if not self._free_slots:
                    break
                self._rewind_locked(req, entry)
                req.pages_reserved = entry.pages_reserved
                req.ticket_no = entry.ticket_no
                req.admit_seq = entry.admit_seq
                req.shared_pages = ()
                req.prefix_node = None
                slot = heapq.heappop(self._free_slots)
                self._reserved += entry.pages_reserved
                self._active[slot] = req
                # Listed BEFORE the device calls, so a fault unwinds it.
                restored.append((slot, entry))
                sh_n = entry.prefix_pages_n
                if entry.prefix_node is not None and sh_n:
                    node = entry.prefix_node
                    pins = node_pages.get(node)
                    if pins is None:
                        shadow = self._prefix_shadow[node]
                        fresh = [self._cache.allocate_pinned_page()
                                 for _ in range(sh_n)]
                        try:
                            self._cache.swapin_pages(fresh,
                                                     shadow["arrays"])
                        except Exception:
                            self._cache.release_pages(fresh)
                            raise
                        self._insert_prefix_entry(
                            req.prompt[:entry.prefix_tokens], fresh)
                        pins = node_pages[node] = tuple(fresh)
                    self._cache.admit(slot, entry.saved_len, pins)
                    self._cache.swapin_pages(
                        self._cache.slot_pages(slot)[sh_n:], entry.arrays)
                    self._lease_take_locked(pins)
                    req.shared_pages = pins
                    req.prefix_node = node
                else:
                    self._cache.admit(slot, entry.saved_len)
                    self._cache.swapin_pages(self._cache.slot_pages(slot),
                                             entry.arrays)
                self._note_finish_candidate_locked(slot, req)
                entries.pop(0)
        except Exception:
            for slot, entry in restored:
                self._active.pop(slot, None)
                self._release_locked(slot, entry.pages_reserved,
                                     entry.req.shared_pages)
                entry.req.shared_pages = ()
                entry.req.prefix_node = None
            for _, entry in restored:
                self._journal.put(entry.req, entry)
            for entry in entries:
                self._journal.put(entry.req, entry)
            raise
        # Overflow back to the swap set (host bookkeeping only): the loop
        # resumes them at boundaries like preempted victims. A prefix
        # reference becomes the full snapshot (shadow + own pages).
        requeued = 0
        for entry in entries:
            req = entry.req
            self._rewind_locked(req, entry)
            arrays = entry.arrays
            pages_needed = entry.pages_reserved
            if entry.prefix_node is not None and entry.prefix_pages_n:
                shadow = self._prefix_shadow[entry.prefix_node]
                arrays = tuple(torch.cat([s, o], dim=1) for s, o in
                               zip(shadow["arrays"], entry.arrays))
                pages_needed += entry.prefix_pages_n
            req.pages_reserved = pages_needed
            req.shared_pages = ()
            req.prefix_node = None
            self._sched.record_swapout_locked(
                req, entry.pclass, entry.ticket_no, pages_needed,
                entry.saved_len, arrays, restore=True)
            requeued += 1
        # Committed: settle every drained entry's shadow reference.
        for entry in all_drained:
            if entry.prefix_node is not None:
                self._journal_drop_locked(entry)
        self._journal_restores += len(restored) + requeued
        if self.tracer is not None and (restored or requeued):
            self.tracer.span("journal-restore", "serve", t0,
                             args={"restored": len(restored),
                                   "requeued": requeued})
        return len(restored) + requeued

    # ---- the decode loop -------------------------------------------------

    def _window_steps(self) -> int:
        """Steps the next window may run: the tightest remaining budget
        MINUS the pending token (emitted without a step), capped at the
        operator window and floored to a power of two."""
        w = min(req.n_new - len(req.generated) - 1
                for req in self._active.values())
        w = min(w, self._window)
        if w <= 1:
            return 1
        return 1 << (w.bit_length() - 1)

    def _sampling_rows(self, samplers: dict) -> tuple:
        """A window's sampling inputs ``(key_data, base_steps, temps,
        top_ps, sampled_mask)``, one row per slot. ``base_steps`` is the
        serial schedule's ``len(generated) + 1`` with the unharvested
        advance folded in, so token t draws with ``fold_in(seed, t)``
        however the windows fall."""
        n = self._cache.slots
        key_data = np.zeros((n, 2), np.uint32)
        base_steps = np.zeros((n,), np.int64)
        temps = np.ones((n,), np.float32)
        top_ps = np.ones((n,), np.float32)
        smask = np.zeros((n,), bool)
        for slot, req in samplers.items():
            key_data[slot] = req.sampling[0]
            base_steps[slot] = len(req.generated) + req.inflight + 1
            temps[slot] = req.sampling[1]
            top_ps[slot] = req.sampling[2]
            smask[slot] = True
        return key_data, base_steps, temps, top_ps, smask

    def _sampled_window(self, tokens, window: int, mask, samplers):
        return self._cache.step_window_sampled(
            self._params, tokens, window, mask,
            *self._sampling_rows(samplers))

    def _next_tokens(self, logits: torch.Tensor) -> dict[int, int]:
        """Every active slot's next token from one step's logits."""
        # locklint: allow[device-sync-under-lock] the serial loop's step: its tokens are the next step's input and the books this lock guards wait on them (the reference reads them under its lock too)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        out = {slot: int(greedy[slot]) for slot in self._active}
        out.update(self._sample_slots(logits, {
            slot: req for slot, req in self._active.items()
            if req.sampling is not None}))
        return out

    @staticmethod
    def _sample_slots(logits: torch.Tensor, samplers: dict) -> dict[int, int]:
        """Sampled slots' tokens from ``[slots, V]`` logits, token index
        ``len(generated) + 1`` (the cross-backend key schedule)."""
        if not samplers:
            return {}
        slots = sorted(samplers)
        dev = logits.device
        keys = as_key_tensor(
            np.stack([samplers[s].sampling[0] for s in slots]), dev)
        steps = torch.as_tensor(
            [len(samplers[s].generated) + 1 for s in slots], device=dev)
        temps = torch.as_tensor([samplers[s].sampling[1] for s in slots],
                                dtype=torch.float32, device=dev)[:, None]
        top_ps = torch.as_tensor([samplers[s].sampling[2] for s in slots],
                                 dtype=torch.float32, device=dev)[:, None]
        # locklint: allow[device-sync-under-lock] as _next_tokens: the step's sampled tokens, read where the loop needs them
        picked = sample_token(logits[slots], fold_in(keys, steps), temps,
                              top_ps).cpu().numpy()
        return {s: int(picked[i]) for i, s in enumerate(slots)}

    @staticmethod
    def _draft(req: _Request, k: int) -> list[int]:
        """K prompt-lookup drafts for a greedy request: the host's mirror
        of the n-gram proposer (the host owns every emitted token). Any
        draft is legal; verification makes the output
        draft-independent."""
        ctx = req.prompt + req.generated + [req.next_token]
        g0, g1 = ctx[-2] if len(ctx) > 1 else ctx[-1], ctx[-1]
        for p in range(len(ctx) - 3, -1, -1):
            if ctx[p] == g0 and ctx[p + 1] == g1:
                start = max(0, min(p + 2, len(ctx) - k))
                cand = ctx[start:start + k]
                return cand + [g1] * (k - len(cand))
        return [g1] * k

    def _spec_pass(self) -> None:
        """One speculative verify pass for the active batch (lock held).
        Greedy slots emit their pending token plus up to K accepted
        drafts and a bonus, truncated at the budget and at a stop token;
        sampled slots advance one token drawn from the pass's
        pending-position logits, the per-step path's key schedule."""
        k = self._spec
        n = self._cache.slots
        tokens = np.zeros((n, k + 1), np.int64)
        mask = np.zeros((n,), bool)
        spec_mask = np.zeros((n,), bool)
        for slot, req in self._active.items():
            tokens[slot, 0] = req.next_token
            mask[slot] = True
            if req.sampling is None:
                spec_mask[slot] = True
                tokens[slot, 1:] = self._draft(req, k)
        emitted, accepted, logits0 = self._cache.step_spec(
            self._params, tokens, active=mask, spec_mask=spec_mask)
        sampled_next = self._sample_slots(logits0, {
            slot: req for slot, req in self._active.items()
            if req.sampling is not None})
        self._spec_passes += 1
        for slot in list(self._active):
            req = self._active[slot]
            if req.sampling is not None:
                self._emit(req, req.next_token)
                req.next_token = sampled_next[slot]
                self._note_finish_candidate_locked(slot, req)
                continue
            a = int(accepted[slot])
            room = req.n_new - len(req.generated)
            seq = [req.next_token] + [int(t) for t in emitted[slot, :a]]
            emit_n, stopped = 0, False
            for t in seq[:room]:
                self._emit(req, t)
                emit_n += 1
                if t == req.stop_token:
                    stopped = True
                    break
            self._spec_emitted += emit_n
            self._spec_slot_passes += 1
            if stopped:
                # Passes run at boundaries only (nothing in flight): the
                # stop finish never needs the deferred path.
                self._stop_finishes += 1
                self._finish_request_locked(slot, req)
            elif len(req.generated) >= req.n_new:
                self._finish_request_locked(slot, req)
            else:
                # The bonus token becomes pending.
                req.next_token = int(emitted[slot, a])
                self._note_finish_candidate_locked(slot, req)

    # ---- scheduler boundary hooks ----------------------------------------

    def _sched_attention_locked(self, *,
                                ignore_inflight: bool = False) -> bool:
        """Does the decode loop need a non-overlapped boundary for the
        scheduler? True when the policy head could RESUME now, or is
        starved and a preemptable victim exists. ``ignore_inflight`` is
        the pipeline-collapse probe: every row still carries in-flight
        window tokens, which the harvest a collapse implies reconciles,
        so a victim is judged as it will be at the boundary."""
        head = self._sched.head_locked()
        if head is None:
            return False
        if (self._free_slots
                and self._reserved + head.pages_needed <= self._pages_total):
            return head.resume
        return (self._sched.preemption_enabled
                and self._pick_victim_locked(
                    head, ignore_inflight=ignore_inflight) is not None)

    def _swap_cost_locked(self, req: _Request, *,
                          include_inflight: bool = False) -> int:
        """Host bytes ``req``'s swap snapshot would take, priced before
        the gather (``include_inflight``: as of the next boundary)."""
        n_tokens = len(req.prompt) + len(req.generated)
        if include_inflight:
            n_tokens += req.inflight
        n_pages = -(-n_tokens // self._cache.page_size)
        return n_pages * self._page_bytes_locked()

    def _page_bytes_locked(self) -> int:
        """Host bytes one page takes (K + V, and the int8 pool's scale
        slabs), priced from the P-page views, which leave out the sink."""
        if self._swap_page_bytes is None:
            st = self._cache.state
            per = st.pool_k.nbytes + st.pool_v.nbytes
            if st.scale_k is not None:
                per += st.scale_k.nbytes + st.scale_v.nbytes
            self._swap_page_bytes = -(-per // self._cache.num_pages)
        return self._swap_page_bytes

    def _pick_victim_locked(self, head, *,
                            ignore_inflight: bool = False) -> int | None:
        """The slot to preempt for ``head``, or None: a STRICTLY lower
        class active request, the lowest class first, then the LATEST
        admitted (least progress lost), whose snapshot fits the host
        budget. A row with in-flight window or spec-window tokens is
        never a victim (unless ``ignore_inflight``, the collapse probe)."""
        head_rank = self._sched.rank(head.pclass)
        best_slot, best_key = None, None
        for slot, req in self._active.items():
            if req.cancelled or (req.inflight and not ignore_inflight):
                continue
            rank = self._sched.rank(req.pclass)
            if rank <= head_rank:
                continue
            if not self._sched.swap_fits_locked(self._swap_cost_locked(
                    req, include_inflight=ignore_inflight)):
                continue
            key = (rank, req.admit_seq)
            if best_key is None or key > best_key:
                best_slot, best_key = slot, key
        return best_slot

    def _maybe_resume_locked(self) -> None:
        """Re-admit swapped-out requests while the policy head is a
        resume entry that fits (boundary only): the reservation first,
        then ``admit`` and the verbatim swap-in. The host-held
        ``next_token``/``generated`` and the positional key schedule
        make the resumed stream the never-preempted one."""
        while True:
            head = self._sched.head_locked()
            if (head is None or not head.resume
                    or not self._free_slots
                    or self._reserved + head.pages_needed > self._pages_total
                    or not self._resume_pages_ok_locked(head.pages_needed)):
                return
            if self._free_slots[0] >= self._cache.bucket:
                # The resume row lies above the bucket: step up now when
                # nothing is in flight, else at the next boundary.
                if (self._inflight is None
                        and not self._cache.spec_pending()):
                    self._cache.set_bucket(
                        self._cache.bucket_for(self._free_slots[0] + 1))
                else:
                    self._bucket_step_wanted = True
                    return
            arrays = head.arrays
            self._sched.pop_resume_locked(head)
            req = head.req
            slot = heapq.heappop(self._free_slots)
            self._reserved += head.pages_needed
            # Active BEFORE the device calls: if the swap-in faults, the
            # poison path owns this waiter like any other.
            self._active[slot] = req
            self._note_finish_candidate_locked(slot, req)
            self._cache.admit(slot, head.saved_len)
            self._cache.swapin_pages(self._cache.slot_pages(slot), arrays)

    def _maybe_preempt_locked(self) -> None:
        """Swap out lower-class victims while the policy head is starved
        (boundary only, nothing in flight): the victim's live pages,
        ``ceil(len / page)`` of them as stored, go to host memory, its
        slot and reservation free, and a resume entry under its ORIGINAL
        ticket re-enters the queue. A spec window's unharvested
        reservation blocks it."""
        if not self._sched.preemption_enabled or self._cache.spec_pending():
            return
        while True:
            head = self._sched.head_locked()
            if head is None:
                return
            if (self._free_slots
                    and self._reserved + head.pages_needed
                    <= self._pages_total):
                self._sched.wake_head_locked()
                return
            victim = self._pick_victim_locked(head)
            if victim is None:
                return
            req = self._active[victim]
            saved_len = len(req.prompt) + len(req.generated)
            n_pages = -(-saved_len // self._cache.page_size)
            # Pages grown past the live length hold no committed K/V.
            ids = self._cache.slot_pages(victim)[:n_pages]
            arrays = self._cache.swapout_pages(ids)
            del self._active[victim]
            # The snapshot copied the shared prefix pages too: the victim
            # becomes self-contained, its leases dissolve and the resume
            # reserves its full footprint.
            full = req.pages_reserved + len(req.shared_pages)
            self._release_locked(victim, req.pages_reserved,
                                 req.shared_pages)
            req.pages_reserved = full
            req.shared_pages = ()
            req.prefix_node = None
            self._sched.record_swapout_locked(
                req, req.pclass, req.ticket_no, full, saved_len, arrays)

    def _fail_swapped_closed_locked(self) -> None:
        """A hard close reaches the swap set as the active set: fail each
        swapped-out waiter and free its host snapshot."""
        for entry in self._sched.take_swapped_locked():
            entry.arrays = ()
            entry.req.error = ServerClosed(
                "server shut down mid-request (swapped out)")
            if entry.req.stream is not None:
                entry.req.stream.put(entry.req.error)
            entry.req.done.set()
        self._sched.wake_all_locked()

    def _loop(self) -> None:
        step = (self._loop_once_overlap if self._overlap_on
                else self._loop_once)
        while step() != "exit":
            # Yield the interpreter lock with the work lock released, so
            # admission waiters can take it between windows.
            # locklint: allow[sleep-under-lock] deliberate GIL yield with the lock RELEASED — breaks the decode loop's lock convoy so expired admission waiters win the reacquisition race (rung 17 fair handoff; removing it starves ServerBusy)
            time.sleep(0)
        if self._poison is not None:
            self._degrade()  # outside the lock, the loop has exited

    def _loop_once(self) -> str:
        """One decode-loop iteration under the lock ("exit" ends it)."""
        with self._work:
            while (not self._active and not self._closed
                   and not self._sched_attention_locked()
                   and not (self._draining and not self._prefilling)):
                self._work.wait()
            if self._closed:
                self._fail_active_locked(ServerClosed(
                    "server shut down mid-request"))
                self._fail_swapped_closed_locked()
                return "exit"
            if (self._draining and not self._active and not self._prefilling
                    and not self._sched.resume_pending_locked()):
                return "exit"
            try:
                self._sweep_cancelled_locked()
                self._sweep_finished_locked()
                # Scheduler boundary: resume swapped-out requests into
                # freed capacity, then preempt for a starved head.
                self._maybe_resume_locked()
                self._maybe_preempt_locked()
                self._maybe_step_bucket_locked()
                self._maybe_checkpoint_locked()
                self._observe_boundary_locked()
                if not self._active:
                    return "ran"
                if (self._spec > 0
                        and any(req.sampling is None
                                for req in self._active.values())):
                    # Greedy slots advance by verify passes; sampled
                    # slots ride one token a pass. An all-sampled batch
                    # takes the plain step below.
                    if self._spec_window > 0:
                        # Spec windows ride the overlap pipeline.
                        self._spec_window_fallbacks["overlap_off"] += 1
                    t0 = time.perf_counter()
                    self._spec_pass()
                    self._decode_s += time.perf_counter() - t0
                    return "ran"
                # Every active slot's pending token through ONE batched
                # step; a half-prefilled slot is admitted but not active.
                n = self._cache.slots
                tokens = np.zeros((n,), np.int64)
                mask = np.zeros((n,), bool)
                for slot, req in self._active.items():
                    tokens[slot] = req.next_token
                    mask[slot] = True
                window = self._window_steps()
                t0 = time.perf_counter()
                if window > 1:
                    samplers = {slot: req
                                for slot, req in self._active.items()
                                if req.sampling is not None}
                    if samplers:
                        produced = self._sampled_window(tokens, window, mask,
                                                        samplers)
                    else:
                        produced = self._cache.step_window(
                            self._params, tokens, window, active=mask)
                    # locklint: allow[device-sync-under-lock] the serial loop's window: the batch holds still under the lock until its tokens are read, by design (boundary-only admission)
                    produced = produced.cpu().numpy()
                    t1 = time.perf_counter()
                    self._decode_s += t1 - t0
                    self._decode_steps += window
                    self._windows += 1
                    # The window's device time (see __init__): serial,
                    # so nothing else was queued on the device.
                    device_ms = self._cache.last_window_ms
                    self._hist_device.observe(
                        (t1 - t0) * 1e3 if device_ms is None else device_ms)
                    if self.tracer is not None:
                        # A fabric span: every window records it.
                        self.tracer.span("window", "serve", t0, t1,
                                         args={"w": window,
                                               "rows": len(self._active),
                                               "depth": 0})
                    for slot, req in list(self._active.items()):
                        self._emit(req, req.next_token)
                        finished = False
                        for i in range(window - 1):
                            t = int(produced[i, slot])
                            self._emit(req, t)
                            if t == req.stop_token:
                                # Host-side stop truncation: the rest of
                                # the window's tokens are dropped.
                                self._stop_finishes += 1
                                self._finish_request_locked(slot, req)
                                finished = True
                                break
                        if not finished:
                            req.next_token = int(produced[window - 1, slot])
                            self._note_finish_candidate_locked(slot, req)
                    return "ran"
                logits = self._cache.step(self._params, tokens, active=mask)
                next_tokens = self._next_tokens(logits)
                t1 = time.perf_counter()
                self._decode_s += t1 - t0
                self._decode_steps += 1
                # An eager step: the blocking call's host time (the
                # tokens' read waits for the device).
                self._hist_device.observe((t1 - t0) * 1e3)
                if self.tracer is not None:
                    self.tracer.span("step", "serve", t0, t1,
                                     args={"rows": len(self._active)})
                for slot, req in self._active.items():
                    self._emit(req, req.next_token)
                    req.next_token = next_tokens[slot]
                    self._note_finish_candidate_locked(slot, req)
            except Exception as e:  # poison: typed, journaled requests park
                self._poison_locked(classify_failure(e))
                return "exit"
        return "ran"

    # ---- the overlapped decode loop --------------------------------------

    def _loop_once_overlap(self) -> str:
        """One iteration of the double-buffered decode loop.

        At a boundary (no window in flight) it reconciles as the serial
        loop does (cancel sweep, finish sweep) and DISPATCHES a window
        without harvesting it. With a window in flight it first enqueues
        the next window on the device-resident carry (no host round trip
        between the two: the overlap), then harvests the previous one
        while the next runs. Whenever exactness needs a boundary (a
        cancel, a newcomer, a stop finish waiting for its slot) it
        harvests WITHOUT dispatching, so the next iteration reconciles.
        Each row's device-side cap freezes it at its true budget, so a
        window dispatched ahead of the host never writes past it.
        """
        with self._work:
            while (not self._active and self._inflight is None
                   and not self._closed
                   and not self._sched_attention_locked()
                   and not (self._draining and not self._prefilling)):
                self._work.wait()
            if (self._draining and not self._active
                    and self._inflight is None and not self._prefilling
                    and not self._sched.resume_pending_locked()):
                return "exit"
            if self._closed:
                # Hard close: abandon the in-flight window unread (the
                # device finishes it harmlessly) and fail the waiters.
                rec, self._inflight = self._inflight, None
                if rec is not None:
                    for _, req, adv in rec["parts"]:
                        req.inflight -= adv
                self._fail_active_locked(ServerClosed(
                    "server shut down mid-request"))
                self._fail_swapped_closed_locked()
                return "exit"
            t0 = time.perf_counter()
            try:
                if self._inflight is None:
                    self._sweep_cancelled_locked()
                    self._sweep_finished_locked()
                    # Preemption and resume join only here: nothing is in
                    # flight and every row's tokens are reconciled.
                    self._maybe_resume_locked()
                    self._maybe_preempt_locked()
                    self._maybe_step_bucket_locked()
                    # Checkpoints share the boundary: the swap-out bytes
                    # must cover a reconciled, nothing-in-flight state.
                    self._maybe_checkpoint_locked()
                    self._observe_boundary_locked()
                    if not self._active:
                        return "ran"
                    self._boundary_dispatch_locked()
                else:
                    prev, self._inflight = self._inflight, None
                    spec = prev.get("kind") in ("spec", "spec_sampled")
                    try:
                        if not self._boundary_wanted_locked(prev):
                            # Enqueue N+1 on the carry BEFORE reading N:
                            # the device starts N+1 the moment N retires.
                            # It rides the carry kind of N (plain and
                            # spec carries are separate device state); a
                            # kind change joins at a boundary.
                            if not spec:
                                self._inflight = (
                                    self._dispatch_window_locked(
                                        first=False))
                            elif self._spec > 0 and self._spec_window > 0:
                                # Both spec kinds share the spec carry: a
                                # mixed pipeline whose sampled rows
                                # finished goes on as plain "spec".
                                self._inflight = (
                                    self._dispatch_spec_window_locked(
                                        first=False))
                            else:
                                # Speculation went off with a spec window
                                # in flight: collapse to a boundary.
                                self._spec_window_fallbacks["spec_off"] += 1
                            if (self._inflight is not None
                                    and self._inflight["captured"]):
                                # N's round trip now spans N+1's capture.
                                prev["captured"] = True
                        elif self.tracer is not None:
                            # The pipeline collapses so a cancel, a
                            # newcomer or a swap joins reconciled.
                            self.tracer.event("boundary", "serve",
                                              args={"reason": "reconcile"})
                        if spec:
                            self._harvest_spec_window_locked(prev)
                        else:
                            self._harvest_locked(prev)
                    except Exception:
                        # prev was not reconciled: restore its in-flight
                        # accounting and wait it out, then poison below.
                        self._drain_rec_locked(prev)
                        raise
                self._decode_s += time.perf_counter() - t0
            except Exception as e:  # poison: typed, journaled requests park
                # Drain the window in flight first, so nothing queued on
                # the device still writes the pool being torn down.
                self._drain_inflight_locked()
                self._poison_locked(classify_failure(e))
                return "exit"
        return "ran"

    def _boundary_dispatch_locked(self) -> None:
        """The boundary's decode work (nothing in flight): a spec window
        when speculation is on with a greedy slot (and, with sampled
        co-tenants, ``spec_sampled_window``), else a per-pass verify
        (counted as a fallback when spec windows are configured), or a
        plain window for an all-sampled batch or speculation off."""
        if self._spec > 0 and any(req.sampling is None
                                  for req in self._active.values()):
            all_greedy = all(req.sampling is None
                             for req in self._active.values())
            if self._spec_window > 0 and (all_greedy
                                          or self._spec_sampled_window):
                self._inflight = self._dispatch_spec_window_locked(
                    first=True)
                return
            if self._spec_window > 0:
                self._spec_window_fallbacks["sampled"] += 1
            # Per-pass speculation drafts from the host's tokens, so its
            # passes run at boundaries and never overlap.
            self._spec_pass()
            return
        self._inflight = self._dispatch_window_locked(first=True)

    def _boundary_wanted_locked(self, prev: dict) -> bool:
        """Fall back to a boundary instead of dispatching the next
        window? Yes when a cancel must be honored, when a slot is active
        that the in-flight window never dispatched (a newcomer: it joins
        at a boundary, where its first token is host-known; the carry
        row of a slot that sat out is garbage), when stop finishes wait
        for one, when the scheduler's head could resume or has a victim
        to preempt (the swap joins at a boundary), or when a bucket step
        waits (the batch dim resizes with nothing in flight), or when the
        checkpoint clock is due (a saturated pipeline would otherwise
        never reach the boundary a checkpoint rides)."""
        dispatched = {slot for slot, _, _ in prev["parts"]}
        for slot, req in self._active.items():
            if req.cancelled or slot not in dispatched:
                return True
        return (self._bucket_step_wanted
                or self._stops_pending > 0
                or (self._checkpoint_every > 0
                    and self._ckpt_clock >= self._checkpoint_every)
                or self._sched_attention_locked(ignore_inflight=True))

    def _dispatch_window_locked(self, first: bool) -> dict | None:
        """Enqueue one capped window for every active slot with budget
        left (lock held); returns the in-flight record, or None when no
        slot can advance.

        ``first``: the boundary dispatch (host-known pending tokens), or
        the overlapped one (``tokens=None``: the cache feeds the previous
        window's last token row from the device). A row's cap is
        ``n_new - len(generated) - inflight - 1``: its committed position
        plus the pending token, which the finish check emits without a
        step. The widest cap sets the window (floored to a power of two,
        the serial path's graph set); rows with less freeze on the
        device."""
        parts = []
        for slot, req in self._active.items():
            cap = req.n_new - len(req.generated) - req.inflight - 1
            if cap > 0 and not req.stopped:
                parts.append((slot, req, cap))
            elif req.inflight == 0:
                # Bounds a missed finish registration at one iteration.
                self._finish_ready.add(slot)
        if not parts:
            return None
        w = min(self._window, max(cap for _, _, cap in parts))
        if w > 1:
            w = 1 << (w.bit_length() - 1)
        n = self._cache.slots
        tokens = np.zeros((n,), np.int64)
        mask = np.zeros((n,), bool)
        steps_left = np.zeros((n,), np.int64)
        stop_tokens = np.full((n,), -1, np.int64)
        recs = []
        for slot, req, cap in parts:
            adv = min(w, cap)
            tokens[slot] = req.next_token
            mask[slot] = True
            steps_left[slot] = adv
            stop_tokens[slot] = req.stop_token
            recs.append((slot, req, adv))
        samplers = {slot: req for slot, req, _ in parts
                    if req.sampling is not None}
        tok_arg = tokens if first else None
        if samplers:
            handle = self._cache.dispatch_window_sampled(
                self._params, tok_arg, w, mask,
                *self._sampling_rows(samplers), steps_left=steps_left,
                stop_tokens=stop_tokens)
        else:
            handle = self._cache.dispatch_window(
                self._params, tok_arg, w, active=mask,
                steps_left=steps_left, stop_tokens=stop_tokens)
        for _, req, adv in recs:
            req.inflight += adv
        self._decode_steps += w
        self._windows += 1
        if not first:
            self._depth1_windows += 1
        self._hist_depth.observe(0.0 if first else 1.0)
        return {"window": w, "parts": recs, "handle": handle,
                "depth": 0 if first else 1, "t0": time.perf_counter(),
                "captured": handle.captured}

    def _harvest_locked(self, rec: dict) -> None:
        """Read an in-flight window's block and reconcile (lock held):
        emission, stop and budget finishes, the new pending token. Each
        row's stream truncates at its dispatch-time cap (``adv``): past
        it the row was frozen and its entries repeat its last token."""
        t_force = time.perf_counter()
        produced = self._cache.harvest_window(rec["handle"])
        t_harvest = time.perf_counter()
        device_ms = self._observe_harvest_locked(rec, "window", t_force,
                                                 t_harvest)
        t_host = time.perf_counter()
        rec["counted"] = True
        self._ckpt_clock += 1  # a window of progress at risk
        for _, req, adv in rec["parts"]:
            req.inflight -= adv
        stop_row = produced[rec["window"] + 1]
        for slot, req, adv in rec["parts"]:
            if self._active.get(slot) is not req or req.stopped:
                continue
            stop_at = int(stop_row[slot])
            if stop_at > 0 and not req.cancelled:
                # The pending token, then everything up to AND including
                # the stop token; the steps after it are discarded.
                room = req.n_new - len(req.generated)
                # locklint: allow[device-sync-under-lock] numpy: harvest_window returned the block on the host
                seq = [req.next_token] + produced[:stop_at, slot].tolist()
                self._emit_many(req, seq[:room])
                self._finish_stopped_locked(slot, req)
                continue
            # locklint: allow[device-sync-under-lock] numpy: harvest_window returned the block on the host
            toks = produced[:adv, slot].tolist()
            self._emit_many(req, [req.next_token] + toks[:-1])
            req.next_token = toks[-1]
            if len(req.generated) + 1 >= req.n_new and not req.cancelled:
                # A saturated pipeline may never reach a boundary, so a
                # filled budget completes here; a cancel is left to the
                # boundary's sweep, as the serial loop orders them.
                self._emit(req, req.next_token)
                self._finish_request_locked(slot, req)
        self._overlap_windows += 1
        host_ms = (time.perf_counter() - t_host) * 1e3
        self._hist_host.observe(host_ms)
        if (self._autotune is not None and device_ms is not None
                and not self._autotune_skips_locked(rec)):
            # This window's split into the controller; its pick serves
            # the NEXT dispatch (the carry is one token row, whatever W).
            self._autotune.observe(
                rtt_ms=(t_harvest - rec["t0"]) * 1e3, device_ms=device_ms,
                host_ms=host_ms, window=rec["window"])
            self._window = self._autotune.window()

    def _autotune_skips_locked(self, rec: dict) -> bool:
        """True (and counted) when the controller must not learn from
        this harvested window: a graph capture ran inside its round trip,
        its own dispatch's or the next window's, dispatched while it
        flew."""
        if not rec["captured"]:
            return False
        self._autotune_skipped_captures += 1
        return True

    def _observe_harvest_locked(self, rec: dict, name: str, t_force: float,
                                t_harvest: float) -> float | None:
        """A harvested window's device, round-trip and span records;
        returns its device ms (None when not measurable, see
        ``PagedKVCache.window_device_ms``). The round trip is host
        ``perf_counter`` from dispatch to the harvest's return."""
        device_ms = self._cache.last_window_ms
        if device_ms is not None:
            self._hist_device.observe(device_ms)
        self._hist_rtt.observe((t_harvest - rec["t0"]) * 1e3)
        if self.tracer is not None:
            # Dispatch to harvest, with the depth it was dispatched at.
            self.tracer.span(name, "serve", rec["t0"], t_harvest,
                             args={"w": rec["window"],
                                   "rows": len(rec["parts"]),
                                   "depth": rec.get("depth", 0)})
        return device_ms

    def _dispatch_spec_window_locked(self, first: bool) -> dict | None:
        """Enqueue one spec window, ``spec_window`` draft + verify passes,
        for every active slot with budget left (lock held); returns the
        in-flight record (kind "spec", or "spec_sampled" when a sampled
        row rides), or None when no slot can advance.

        ``first``: the boundary dispatch (host-known pending tokens and
        each row's drafting context, prompt + generated + pending), or
        the overlapped one on the device spec carry. A row's budget is
        ``n_new - len(generated) - inflight``: the window consumes the
        pending token (each pass emits it), so there is no ``- 1``. Its
        ``inflight`` advances by the cache's worst-case cap; the true
        advance lands at harvest, truncated at the budget. A sampled row
        advances exactly one token a live pass, so ``base_steps =
        len(generated) + inflight + 1`` keeps the per-pass key schedule
        across pipelined windows."""
        k = self._spec
        w = self._spec_window
        n = self._cache.slots
        budgets = np.zeros((n,), np.int64)
        parts = []
        for slot, req in self._active.items():
            room = req.n_new - len(req.generated) - req.inflight
            if room > 0 and not req.stopped:
                budgets[slot] = room
                parts.append((slot, req))
            elif req.inflight == 0:
                # Bounds a missed finish registration at one iteration.
                self._finish_ready.add(slot)
        if not parts:
            return None
        samplers = {slot: req for slot, req in parts
                    if req.sampling is not None}
        sampling = self._sampling_rows(samplers) if samplers else None
        if first:
            ctx = np.zeros((n, self._spec_ctx_cap), np.int64)
            ctx_len = np.zeros((n,), np.int64)
            tokens = np.zeros((n,), np.int64)
            for slot, req in parts:
                seq = req.prompt + req.generated + [req.next_token]
                ctx[slot, :len(seq)] = seq
                ctx_len[slot] = len(seq)
                tokens[slot] = req.next_token
            handle = self._cache.dispatch_spec_window(
                self._params, tokens, w, k, budgets, ctx=ctx,
                ctx_len=ctx_len, sampling=sampling)
        else:
            handle = self._cache.dispatch_spec_window(
                self._params, None, w, k, budgets, sampling=sampling)
            self._spec_depth1_windows += 1
            self._depth1_windows += 1
        recs = []
        for slot, req in parts:
            cap = int(handle.caps[slot])
            req.inflight += cap
            recs.append((slot, req, cap))
        self._hist_depth.observe(0.0 if first else 1.0)
        return {"kind": "spec_sampled" if samplers else "spec",
                "window": w, "parts": recs, "handle": handle,
                "depth": 0 if first else 1, "t0": time.perf_counter(),
                "captured": handle.captured}

    def _harvest_spec_window_locked(self, rec: dict) -> None:
        """Read an in-flight spec window and reconcile (lock held). Each
        row replays its pending-token chain: pass p emits the pending
        token and the accepted drafts (``counts[p] - 1`` entries of the
        emitted row, whose entry ``counts[p] - 1`` is the next pending),
        truncated at the row's budget and at its stop token."""
        t_force = time.perf_counter()
        emitted, counts, _ = self._cache.harvest_spec_window(rec["handle"])
        t_harvest = time.perf_counter()
        device_ms = self._observe_harvest_locked(rec, "spec-window", t_force,
                                                 t_harvest)
        t_host = time.perf_counter()
        rec["counted"] = True
        self._ckpt_clock += 1  # a window of progress at risk
        for _, req, cap in rec["parts"]:
            req.inflight -= cap
        self._spec_passes += rec["window"]
        for slot, req, cap in rec["parts"]:
            if self._active.get(slot) is not req or req.stopped:
                continue
            before = len(req.generated)
            stopped = False
            # locklint: allow[device-sync-under-lock] numpy: harvest_spec_window returned the counts on the host
            counts_col = counts[:, slot].tolist()
            for p in range(rec["window"]):
                c = counts_col[p]
                if c == 0:
                    # A frozen pass: the row's budget ran out on the
                    # device.
                    continue
                room = max(req.n_new - len(req.generated), 0)
                # locklint: allow[device-sync-under-lock] numpy: harvest_spec_window returned the tokens on the host
                row = emitted[p, slot, :c].tolist()
                seq = ([req.next_token] + row[:-1])[:room]
                if req.stop_token in seq:
                    # Later passes decoded past the stop: discarded.
                    seq = seq[:seq.index(req.stop_token) + 1]
                    stopped = True
                self._emit_many(req, seq)
                req.next_token = row[-1]
                if req.sampling is None:
                    # Greedy acceleration only: sampled rows ride one
                    # token a pass by construction.
                    self._spec_emitted += len(seq)
                    self._spec_slot_passes += 1
                if stopped:
                    break
            self._hist_spec_tokens.observe(float(len(req.generated) - before))
            if stopped and not req.cancelled:
                self._finish_stopped_locked(slot, req)
            elif len(req.generated) >= req.n_new and not req.cancelled:
                # Inline finish, as in the plain harvest: a saturated
                # pipeline may never reach a boundary.
                self._finish_request_locked(slot, req)
            else:
                # The carried pending may itself be the stop token.
                self._note_finish_candidate_locked(slot, req)
        self._spec_windows += 1
        self._overlap_windows += 1
        host_ms = (time.perf_counter() - t_host) * 1e3
        self._hist_host.observe(host_ms)
        if (self._autotune is not None and device_ms is not None
                and not self._autotune_skips_locked(rec)):
            # The spec-depth channel keeps its own (R, t): a verify pass
            # costs another device time than a step. Its pick applies
            # only at a true boundary (the next spec dispatch rebuilds
            # from host tokens), never above the configured depth.
            self._autotune.observe(
                rtt_ms=(t_harvest - rec["t0"]) * 1e3, device_ms=device_ms,
                host_ms=host_ms, window=rec["window"], channel="spec")
            if self._inflight is None and self._spec_window_cap > 0:
                pick = self._autotune.window(
                    "spec", default=self._spec_window_cap)
                self._spec_window = max(1, min(self._spec_window_cap, pick))

    def _drain_rec_locked(self, rec: dict | None) -> None:
        """Unwind one in-flight record on the failure path: restore the
        in-flight counts and wait until the device has retired the
        window."""
        if rec is None:
            return
        if not rec.get("counted"):
            for _, req, adv in rec["parts"]:
                req.inflight -= adv
        try:
            if rec.get("kind") in ("spec", "spec_sampled"):
                self._cache.harvest_spec_window(rec["handle"])
            else:
                self._cache.harvest_window(rec["handle"])
        except Exception:  # the pool is being poisoned anyway
            pass

    def _drain_inflight_locked(self) -> None:
        rec, self._inflight = self._inflight, None
        self._drain_rec_locked(rec)
