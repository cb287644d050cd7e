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
(``_window_steps``), greedy and seeded nucleus sampling with the
reference's key schedule, and host-side stop-token truncation. What it
leaves out (the reference's later rungs): speculative decoding, the
overlap pipeline, the prefix cache, preemption and swap, the journal
and recovery, the SLO engine, tracing and bucketing.

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
    ``window`` caps the decode steps one device window runs.
    """

    def __init__(self, params: dict, cfg: TransformerConfig, *,
                 slots: int = 4, pages: int = 64, page_size: int = 16,
                 prefill_chunk: int = 0, window: int = 64,
                 kv_dtype: str = "", device: torch.device | str = "cpu"):
        if not isinstance(window, int) or window < 1:
            raise ValueError("window must be an int >= 1")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole prompt)")
        self._params = params
        self._cfg = cfg
        self._window = window
        self._prefill_chunk = prefill_chunk
        self._cache = PagedKVCache(
            cfg, slots=slots, pages=pages, page_size=page_size,
            max_pages_per_seq=-(-cfg.max_seq // page_size),
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
        self._done_total = 0
        self._tokens_done_total = 0
        self._stop_finishes = 0
        # Host-clock seconds spent in prefill chunks (to the first-token
        # pick) and in decode windows/steps (to the tokens' host copy);
        # both end in a device sync, so they include the device's time.
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
                "requests_done": self._done_total,
                "tokens_done": self._tokens_done_total,
                "stop_finishes": self._stop_finishes,
                "prefill_s": self._prefill_s,
                "decode_s": self._decode_s,
                "page_accounting": self._cache.page_accounting(),
            }

    # ---- admission and prefill -------------------------------------------

    def _pages_needed(self, total: int) -> int:
        return -(-total // self._cache.page_size)

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
        pages_needed = self._pages_needed(total)
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

    def _note_finish_candidate_locked(self, slot: int, req: _Request) -> None:
        """Register a slot whose pending token completes the request
        (budget filled or stop token) for the boundary sweep."""
        if (len(req.generated) + 1 >= req.n_new
                or req.next_token == req.stop_token):
            self._finish_ready.add(slot)

    def _sweep_finished_locked(self) -> None:
        """A request whose pending token completes its budget, or IS its
        stop token, needs no step: emit it and finish before the batch."""
        for slot in sorted(self._finish_ready):
            req = self._active.get(slot)
            if req is None or req.cancelled:
                continue
            if len(req.generated) + 1 >= req.n_new:
                self._emit(req, req.next_token)
                self._finish_request_locked(slot, req)
            elif req.next_token == req.stop_token:
                self._emit(req, req.next_token)
                self._stop_finishes += 1
                self._finish_request_locked(slot, req)
        self._finish_ready.clear()

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

    def _sampled_window(self, tokens, window: int, mask, samplers):
        n = self._cache.slots
        key_data = np.zeros((n, 2), np.uint32)
        base_steps = np.zeros((n,), np.int64)
        temps = np.ones((n,), np.float32)
        top_ps = np.ones((n,), np.float32)
        smask = np.zeros((n,), bool)
        for slot, req in samplers.items():
            key_data[slot] = req.sampling[0]
            base_steps[slot] = len(req.generated) + 1
            temps[slot] = req.sampling[1]
            top_ps[slot] = req.sampling[2]
            smask[slot] = True
        return self._cache.step_window_sampled(
            self._params, tokens, window, mask, key_data, base_steps,
            temps, top_ps, smask,
        )

    def _next_tokens(self, logits: torch.Tensor) -> dict[int, int]:
        """Every active slot's next token from one step's logits."""
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        out = {slot: int(greedy[slot]) for slot in self._active}
        samplers = {slot: req for slot, req in self._active.items()
                    if req.sampling is not None}
        if samplers:
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
            out.update({s: int(picked[i]) for i, s in enumerate(slots)})
        return out

    def _loop(self) -> None:
        while self._loop_once() != "exit":
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
