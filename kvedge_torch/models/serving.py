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
``cancel``, ``close(drain)``, FIFO admission, chunked prefill, the
SERIAL window loop (``_loop_once``) with power-of-two windows
(``_window_steps``), the OVERLAPPED loop (``_loop_once_overlap``, the
``overlap`` knob: window N+1 is enqueued on the device-resident carry
before window N is harvested, each row capped at its own budget on the
device), greedy and seeded nucleus sampling with the reference's key
schedule, stop tokens (truncated on the host in the serial loop, found
on the device in the overlapped one), and server-wide speculative
decoding (``speculative``: per verify pass at boundaries, or as
device-resident spec windows in the overlap pipeline with
``spec_window``; the ``resolve_speculation`` boot probe). What it leaves
out (the reference's later rungs): the prefix cache, preemption and
swap, the journal and recovery, the SLO engine, tracing, autotune and
bucketing.

Greedy decode is token-for-token the port's ``forward`` argmax, and the
tokens of a request do not depend on what else is in flight: the paged
attention masks each row to its own positions, and token t of a sampled
request draws with ``fold_in(row_key, t)`` whatever the batch holds.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import queue
import threading
import time

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.models.sampling import as_key_tensor, fold_in, sample_token

_STREAM_DONE = object()


class ServerBusy(RuntimeError):
    """No slot/page capacity became available within the timeout."""


class ServerClosed(RuntimeError):
    """The server was shut down (or its pool was poisoned)."""


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
    pages_reserved: int = 0
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
    those windows. ``device`` is the card unless "cpu" is asked for.
    """

    def __init__(self, params: dict, cfg: TransformerConfig, *,
                 slots: int = 4, pages: int = 64, page_size: int = 16,
                 prefill_chunk: int = 0, speculative: int = 0,
                 spec_window: int = 0, spec_sampled_window: bool = True,
                 window: int = 64, kv_dtype: str = "",
                 overlap: str = "auto",
                 device: torch.device | str | None = None):
        if not isinstance(window, int) or window < 1:
            raise ValueError("window must be an int >= 1")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole prompt)")
        if overlap not in ("auto", "on", "off"):
            raise ValueError("overlap must be 'auto', 'on' or 'off'")
        self._overlap_on = overlap != "off"
        self._params = params
        self._cfg = cfg
        self._window = window
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
        # n_new == max_seq) greedy request still admits.
        self._cache = PagedKVCache(
            cfg, slots=slots, pages=pages, page_size=page_size,
            max_pages_per_seq=-(-(cfg.max_seq + self._spec) // page_size),
            kv_dtype=kv_dtype, device=device,
        )
        self._pages_total = pages
        self._reserved = 0  # worst-case pages of every admitted request
        self._work = threading.Condition(threading.Lock())
        self._free_slots = list(range(slots))  # a heap: lowest slot first
        self._waiting: collections.deque = collections.deque()  # FIFO
        self._active: dict[int, _Request] = {}
        self._finish_ready: set[int] = set()
        self._prefilling = 0
        self._closed = False
        self._draining = False
        self._poison: Exception | None = None
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
        self._tokens_done_total = 0
        self._stop_finishes = 0
        # Host-clock seconds spent in prefill chunks (to the first-token
        # pick) and in decode windows/steps (serial: to the tokens' host
        # copy; overlapped: the loop's iterations that dispatch or
        # harvest, under the lock); both end in a device sync, so they
        # include the device's time.
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._thread = threading.Thread(target=self._loop,
                                        name="kvedge-torch-serve",
                                        daemon=True)
        self._thread.start()

    # ---- public API ------------------------------------------------------

    def submit(self, prompt: list[int], n_new: int, timeout: float = 120.0,
               sampling: tuple | None = None,
               stop_token: int | None = None) -> list[int]:
        """Blocking generate: the prompt plus UP TO ``n_new`` generated
        tokens. Greedy unless ``sampling = (key_data, temperature,
        top_p)``, with ``key_data`` the raw uint32 ``[2]`` data of the
        row's seed key. Raises :class:`ServerBusy` when capacity does not
        free up within ``timeout``, ValueError for requests that can
        never fit."""
        req = self._start(prompt, n_new, timeout, sampling, stream=False,
                          stop_token=stop_token)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.prompt + req.generated

    def submit_stream(self, prompt: list[int], n_new: int,
                      timeout: float = 120.0, sampling: tuple | None = None,
                      stop_token: int | None = None) -> StreamHandle:
        """Streaming generate: an iterator over the generated tokens as
        they land, with ``cancel()``."""
        req = self._start(prompt, n_new, timeout, sampling, stream=True,
                          stop_token=stop_token)
        return StreamHandle(self, req)

    def cancel(self, req: _Request) -> None:
        """Drop a request at the next boundary (idempotent)."""
        with self._work:
            req.cancelled = True
            self._work.notify_all()

    def close(self, drain: bool = False) -> None:
        """Shut down. A hard close fails in-flight requests with
        :class:`ServerClosed`; ``drain=True`` refuses new submits at once
        but lets every admitted request decode out its budget first."""
        with self._work:
            if drain:
                self._draining = True
            else:
                self._closed = True
            self._work.notify_all()
        self._thread.join(timeout=600 if drain else 60)
        with self._work:
            self._closed = True
            self._work.notify_all()

    @property
    def healthy(self) -> bool:
        """False once the server is closed or its pool poisoned."""
        return not self._closed

    def stats(self) -> dict:
        with self._work:
            return {
                "slots": self._cache.slots,
                "pages_total": self._pages_total,
                "pages_reserved": self._reserved,
                "active": len(self._active),
                "waiting": len(self._waiting),
                "decode_steps": self._decode_steps,
                "windows": self._windows,
                "overlap": 1 if self._overlap_on else 0,
                "overlap_windows": self._overlap_windows,
                "overlap_depth1_windows": self._depth1_windows,
                "requests_done": self._done_total,
                "tokens_done": self._tokens_done_total,
                "stop_finishes": self._stop_finishes,
                "prefill_s": self._prefill_s,
                "decode_s": self._decode_s,
                "page_accounting": self._cache.page_accounting(),
                "spec_window_fallbacks": dict(self._spec_window_fallbacks),
                **self._spec_stats_locked(),
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
        if self._poison is not None:
            return ServerClosed(f"serving pool poisoned by {self._poison!r}")
        return ServerClosed("server is shut down")

    def _start(self, prompt, n_new: int, timeout: float, sampling,
               stream: bool, stop_token: int | None) -> _Request:
        if not prompt or n_new < 1:
            raise ValueError("need a non-empty prompt and n_new >= 1")
        if stop_token is not None and stop_token < 0:
            raise ValueError("stop_token must be >= 0 (or None)")
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
        )
        deadline = time.monotonic() + timeout
        with self._work:
            if self._closed or self._draining:
                raise self._refusal()
            # FIFO admission: only the head of the queue takes capacity.
            self._waiting.append(req)
            try:
                while True:
                    if self._closed or self._draining:
                        raise self._refusal()
                    if req.cancelled:
                        raise RequestCancelled(
                            "request cancelled while queued for admission"
                        )
                    if (self._waiting[0] is req and self._free_slots
                            and self._reserved + pages_needed
                            <= self._pages_total):
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ServerBusy(
                            f"no capacity within the timeout "
                            f"({len(self._active)} requests in flight, "
                            f"{self._pages_total - self._reserved}/"
                            f"{self._pages_total} pages unreserved, "
                            f"{len(self._waiting)} queued)"
                        )
                    self._work.wait(timeout=remaining)
            finally:
                self._waiting.remove(req)
                self._work.notify_all()  # the next head re-checks
            slot = heapq.heappop(self._free_slots)
            self._reserved += pages_needed
            try:
                self._cache.admit(slot, len(req.prompt))
            except Exception:
                self._release_locked(slot, pages_needed)
                raise
            self._prefilling += 1
        # Chunked prefill, the lock held per chunk: the decode loop runs
        # windows for in-flight requests between chunks (this slot is not
        # active yet, so they never touch it).
        chunk = self._prefill_chunk or len(req.prompt)
        activated = False
        try:
            logits = None
            off = 0
            while off < len(req.prompt):
                piece = req.prompt[off:off + chunk]
                with self._work:
                    if self._closed:
                        raise self._refusal()
                    if req.cancelled:
                        raise RequestCancelled("request cancelled during "
                                               "prefill")
                    t0 = time.perf_counter()
                    logits = self._cache.prefill_chunk(self._params, slot,
                                                       piece, off)
                    self._prefill_s += time.perf_counter() - t0
                off += len(piece)
            with self._work:
                if self._closed:
                    raise self._refusal()
                t0 = time.perf_counter()
                req.next_token = req.pick(logits, 0)
                self._prefill_s += time.perf_counter() - t0
                self._active[slot] = req
                self._note_finish_candidate_locked(slot, req)
                self._prefilling -= 1
                activated = True
                self._work.notify_all()  # wake the decode loop
        except Exception:
            with self._work:
                if not activated:
                    self._prefilling -= 1
                    self._release_locked(slot, req.pages_reserved)
            raise
        return req

    # ---- finishing -------------------------------------------------------

    def _release_locked(self, slot: int, pages: int) -> None:
        if self._cache.is_admitted(slot):
            self._cache.release(slot)
        heapq.heappush(self._free_slots, slot)
        self._reserved -= pages
        self._work.notify_all()

    def _finish_request_locked(self, slot: int, req: _Request) -> None:
        del self._active[slot]
        self._done_total += 1
        self._tokens_done_total += len(req.generated)
        self._release_locked(slot, req.pages_reserved)
        if req.stream is not None:
            req.stream.put(_STREAM_DONE)
        req.done.set()

    @staticmethod
    def _emit(req: _Request, token: int) -> None:
        req.generated.append(token)
        if req.stream is not None:
            req.stream.put(token)

    @staticmethod
    def _emit_many(req: _Request, tokens: list) -> None:
        """Bulk :meth:`_emit`: a harvested row's tokens in one extend."""
        req.generated.extend(tokens)
        if req.stream is not None:
            for token in tokens:
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
            self._release_locked(slot, req.pages_reserved)
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

    def _poison_locked(self, cause: Exception) -> None:
        """A decode failure fails every in-flight request loudly and
        refuses new work: the pool state is no longer trustworthy."""
        self._poison = cause
        self._closed = True
        self._fail_active_locked(ServerClosed(
            f"serving pool poisoned by {cause!r}"))
        self._work.notify_all()

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

    def _loop(self) -> None:
        step = (self._loop_once_overlap if self._overlap_on
                else self._loop_once)
        while step() != "exit":
            # Yield the interpreter lock with the work lock released, so
            # admission waiters can take it between windows.
            time.sleep(0)

    def _loop_once(self) -> str:
        """One decode-loop iteration under the lock ("exit" ends it)."""
        with self._work:
            while (not self._active and not self._closed
                   and not (self._draining and not self._prefilling)):
                self._work.wait()
            if self._closed:
                self._fail_active_locked(ServerClosed(
                    "server shut down mid-request"))
                return "exit"
            if self._draining and not self._active and not self._prefilling:
                return "exit"
            try:
                self._sweep_cancelled_locked()
                self._sweep_finished_locked()
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
                    produced = produced.cpu().numpy()
                    self._decode_s += time.perf_counter() - t0
                    self._decode_steps += window
                    self._windows += 1
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
                self._decode_s += time.perf_counter() - t0
                self._decode_steps += 1
                for slot, req in self._active.items():
                    self._emit(req, req.next_token)
                    req.next_token = next_tokens[slot]
                    self._note_finish_candidate_locked(slot, req)
            except Exception as e:  # poison: fail every waiter loudly
                self._poison_locked(e)
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
                   and not (self._draining and not self._prefilling)):
                self._work.wait()
            if (self._draining and not self._active
                    and self._inflight is None and not self._prefilling):
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
                return "exit"
            t0 = time.perf_counter()
            try:
                if self._inflight is None:
                    self._sweep_cancelled_locked()
                    self._sweep_finished_locked()
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
            except Exception as e:  # poison: fail every waiter loudly
                # Drain the window in flight first, so nothing queued on
                # the device still writes the pool being torn down.
                self._drain_inflight_locked()
                self._poison_locked(e)
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
        row of a slot that sat out is garbage), or when stop finishes
        wait for one."""
        dispatched = {slot for slot, _, _ in prev["parts"]}
        for slot, req in self._active.items():
            if req.cancelled or slot not in dispatched:
                return True
        return self._stops_pending > 0

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
        return {"window": w, "parts": recs, "handle": handle}

    def _harvest_locked(self, rec: dict) -> None:
        """Read an in-flight window's block and reconcile (lock held):
        emission, stop and budget finishes, the new pending token. Each
        row's stream truncates at its dispatch-time cap (``adv``): past
        it the row was frozen and its entries repeat its last token."""
        produced = self._cache.harvest_window(rec["handle"])
        rec["counted"] = True
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
                seq = [req.next_token] + produced[:stop_at, slot].tolist()
                self._emit_many(req, seq[:room])
                self._finish_stopped_locked(slot, req)
                continue
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
        return {"kind": "spec_sampled" if samplers else "spec",
                "window": w, "parts": recs, "handle": handle}

    def _harvest_spec_window_locked(self, rec: dict) -> None:
        """Read an in-flight spec window and reconcile (lock held). Each
        row replays its pending-token chain: pass p emits the pending
        token and the accepted drafts (``counts[p] - 1`` entries of the
        emitted row, whose entry ``counts[p] - 1`` is the next pending),
        truncated at the row's budget and at its stop token."""
        emitted, counts, _ = self._cache.harvest_spec_window(rec["handle"])
        rec["counted"] = True
        for _, req, cap in rec["parts"]:
            req.inflight -= cap
        self._spec_passes += rec["window"]
        for slot, req, cap in rec["parts"]:
            if self._active.get(slot) is not req or req.stopped:
                continue
            stopped = False
            counts_col = counts[:, slot].tolist()
            for p in range(rec["window"]):
                c = counts_col[p]
                if c == 0:
                    # A frozen pass: the row's budget ran out on the
                    # device.
                    continue
                room = max(req.n_new - len(req.generated), 0)
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
