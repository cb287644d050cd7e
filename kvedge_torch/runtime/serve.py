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

``ServeRuntime`` builds everything (device check, weights, the server,
the HTTP listener); ``python -m kvedge_torch serve`` (``cli.py``) runs
it until interrupted. The weights are the params of the latest
checkpoint that ``train`` wrote under the state directory
(``restored_step`` in every response names its step), as the
reference's serve restores them, or else the seeded numpy init.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import heartbeat
from kvedge_torch.runtime.config import (
    RuntimeConfigError,
    ServeConfig,
    _spec_draft_len,
)
from kvedge_torch.runtime.devicecheck import resolve_device, run_device_check
from kvedge_torch.runtime.failures import ServingFailure
from kvedge_torch.runtime.recovery import (
    RECOVERING,
    RecoveryPolicy,
    RecoverySupervisor,
    sweep_stranded_tmp,
)
from kvedge_torch.runtime.train import restore_latest_params

# Request-body ceiling: a token grid is small; anything bigger is refused
# before json.loads.
_MAX_GENERATE_BODY = 1 << 20


class GenerateUnavailable(RuntimeError):
    """Capacity or lifecycle refusal: the client should retry (503),
    after ``retry_after_s`` when the refusal carried a hint."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


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


class ServeRuntime:
    """The serving data path: device check, weights, the paged server
    (``server``; None on the contiguous backend), ``serve_fn`` and (with
    ``port`` set) the HTTP listener.

    ``device`` is the card unless "cpu" is asked for; ``params`` is a
    numpy param tree (the reference's layout) or None for the latest
    checkpoint's params, or weights made from ``seed`` when there is no
    checkpoint; ``dtype`` is the compute dtype. ``supervisor`` is the
    paged pool's :class:`RecoverySupervisor` (None with
    ``serving_recovery_attempts = 0`` or the contiguous backend); its
    warm restart re-restores the params served, copied in place.
    """

    def __init__(self, cfg: ServeConfig, *, device=None,
                 dtype: str = "bfloat16", seed: int = 0, params=None,
                 host: str | None = None, port: int | None = None):
        self.device = resolve_device(device)
        self.device_check = run_device_check(self.device)
        if not self.device_check.ok:
            raise RuntimeError(f"device check failed: "
                               f"{self.device_check.error}")
        self.cfg = cfg
        self.tcfg = cfg.model_config(dtype)
        # Atomic-write leftovers of a killed predecessor, before anything
        # writes to the state directory.
        swept = sweep_stranded_tmp(cfg.state_dir)
        if swept:
            print(f"[kvedge-serve] swept {len(swept)} stranded tmp "
                  f"file(s) from the state dir: {', '.join(swept)}",
                  flush=True)
        self.restored_step = None
        given = params
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
            self.server = PagedGenerationServer(
                self.weights, self.tcfg, slots=slots, pages=pages,
                page_size=page_size,
                prefill_chunk=cfg.serving_prefill_chunk,
                prefix_cache=cfg.serving_prefix_cache,
                prefix_host_mb=cfg.serving_prefix_host_mb,
                window=cfg.serving_window, kv_dtype=cfg.serving_kv_dtype,
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
            )
            if cfg.state_dir:
                self.server.on_degraded = self._record_failure
            if spec_draft > 0:
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
                    and cfg.state_dir):
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

                self.supervisor = RecoverySupervisor(
                    self.server,
                    policy=RecoveryPolicy(
                        max_attempts=cfg.serving_recovery_attempts),
                    state_dir=cfg.state_dir,
                    prefix_path=self.prefix_path or "",
                    prefix_fingerprint=self.prefix_fingerprint or "",
                    restore_params=restore_params,
                ).attach()
        # Rows submit together on a bounded pool (2 x slots workers):
        # excess rows queue here instead of spawning threads.
        self._rows = concurrent.futures.ThreadPoolExecutor(
            max_workers=2 * slots, thread_name_prefix="kvedge-torch-row")
        self.httpd = None
        self._http_thread = None
        if port is not None:
            self._start_http(host or cfg.status_bind, port)

    def _start_prefix_persistence(self) -> None:
        """Re-pin the previous run's prefix registry, then dump it every
        30 s while it changes (the reference's wiring and fingerprint:
        the checkpoint step and the model's geometry and dtype)."""
        t = self.tcfg
        self.prefix_path = os.path.join(self.cfg.state_dir,
                                        "prefix-cache.npz")
        self.prefix_fingerprint = (
            f"step={self.restored_step} {t.vocab}v {t.d_model}d "
            f"{t.n_heads}h {t.kv_heads}kv {t.n_layers}L {t.d_ff}ff "
            f"{t.max_seq}T {t.dtype}")
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
        ``<state_dir>/last-failure.json``, which outlives the pod."""
        heartbeat.write_failure_record(self.cfg.state_dir, {
            "payload": "serve", "backend": "paged",
            "type": type(failure).__name__, "reason": reason,
            "retryable": bool(getattr(failure, "retryable", False)),
        })

    def health(self) -> tuple[int, dict]:
        """``GET /healthz``: 200 ``{"status": "ok"}``, or 503 with the
        reference's detail. A poisoned pool under recovery is NOT
        terminal (``recovering``, a retry hint, the capacity probe);
        with no supervisor, or after its escalation, it is."""
        if self.healthy:
            return 200, {"status": "ok"}
        doc: dict = {"status": "degraded"}
        reason = self.server.degraded if self.server is not None else None
        if reason is None:
            return 503, doc
        rec = (self.supervisor.health() if self.supervisor is not None
               else None)
        if rec is not None and rec["state"] == RECOVERING:
            doc.update({"reason": reason, "terminal": False,
                        "recovering": True,
                        "retry_after_s": (
                            rec["retry_after_s"]
                            if rec.get("retry_after_s") is not None
                            else self.cfg.serving_retry_after_s)})
            doc.update(self.server.capacity_probe())
        else:
            doc.update({"reason": reason, "terminal": True})
        return 503, doc

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def healthy(self) -> bool:
        if self.server is not None:
            return self.server.healthy
        return not self._closed

    def serve_fn(self, doc: dict) -> dict:
        """One ``POST /generate`` body -> the response document, or for
        ``"stream": true`` a document whose ``"_stream"`` iterates the
        newline-delimited JSON records (one ``{"row": r, "token": t}``
        per token, then ``{"done": true, ...}``)."""
        (tokens, n_new, temperature, top_p, seed, stream, spec, priority,
         deadline_ms) = _parse_generate_request(
            doc, self.tcfg, max_rows=self.max_rows, paged=self.paged)
        if not self.paged:
            return self._serve_contiguous(tokens, n_new, temperature, top_p,
                                          seed, spec)
        timeout = 120.0
        prompts = [[t % self.tcfg.vocab for t in row] for row in tokens]

        def row_sampling(i: int):
            if temperature <= 0.0:
                return None
            return (row_key_data(seed, i), temperature, top_p)

        if stream:
            return {"_stream": self._stream(prompts, n_new, timeout,
                                            row_sampling, priority,
                                            deadline_ms)}
        rows: list = [None] * len(prompts)

        def one_row(i: int) -> None:
            rows[i] = self.server.submit(prompts[i], n_new, timeout=timeout,
                                         sampling=row_sampling(i),
                                         priority=priority,
                                         deadline_ms=deadline_ms)

        self._fan_out(len(prompts), one_row)
        return {"tokens": rows, "n_new": n_new,
                "restored_step": self.restored_step}

    def _serve_contiguous(self, tokens, n_new: int, temperature: float,
                          top_p: float, seed: int, spec: int) -> dict:
        """One request through ``generate``: its rows as one batch, row r
        sampling with ``fold_in(PRNGKey(seed), r)`` when ``temperature >
        0``; with ``spec`` (one greedy row, as the parser guarantees),
        through ``generate_speculative`` at draft length ``spec``."""
        prompt = [[t % self.tcfg.vocab for t in row] for row in tokens]
        if spec:
            with self._generate_lock:
                if self._closed:
                    raise GenerateUnavailable("server is shut down")
                out, rate = generate_speculative(
                    self.weights, prompt, self.tcfg, n_new, draft_len=spec,
                    device=self.device)
                rows = out.cpu().tolist()
            # The mean tokens emitted per verify pass (1.0 = speculation
            # never paid; spec + 1 = every draft accepted).
            return {"tokens": rows, "n_new": n_new,
                    "restored_step": self.restored_step,
                    "accepted_per_step": round(rate, 3)}
        sampled = temperature > 0.0
        sampling = None
        if sampled:
            keys = np.stack([row_key_data(seed, i)
                             for i in range(len(prompt))])
            sampling = (keys, temperature, top_p)
        with self._generate_lock:
            if self._closed:
                raise GenerateUnavailable("server is shut down")
            out = generate(self.weights, prompt, self.tcfg, n_new,
                           sampling=sampling, sampled=sampled,
                           device=self.device)
            rows = out.cpu().tolist()
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
                deadline_ms: int | None = None):
        """Admit every row and wait for its first token HERE, so a refusal
        is still a clean 503 before the 200 is committed; then return the
        generator that merges the rows' tokens as they land."""
        sources: list = [None] * len(prompts)
        firsts: list = [None] * len(prompts)

        def prime(i: int) -> None:
            src = self.server.submit_stream(prompts[i], n_new,
                                            timeout=timeout,
                                            sampling=row_sampling(i),
                                            priority=priority,
                                            deadline_ms=deadline_ms)
            sources[i] = src
            firsts[i] = next(src)

        try:
            self._fan_out(len(prompts), prime)
        except Exception:
            for src in sources:
                if src is not None:
                    src.cancel()
            raise
        return self._merge(prompts, n_new, sources, firsts)

    def _merge(self, prompts, n_new: int, sources, firsts):
        done = object()
        out_q: queue.SimpleQueue = queue.SimpleQueue()

        def pump(i: int) -> None:
            # One pump per row: the streams block on the decode loop, so
            # a round-robin reader would stall every row behind the
            # slowest.
            try:
                out_q.put((i, firsts[i]))
                for token in sources[i]:
                    out_q.put((i, token))
                out_q.put((i, done))
            except Exception as e:  # handed to the merger, which raises
                out_q.put((i, e))

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
                    raise item
                generated[i].append(item)
                yield {"row": i, "token": item}
        except GeneratorExit:
            # The client is gone: free every row's slot and pages at the
            # next decode boundary instead of decoding out the budgets.
            for src in sources:
                src.cancel()
            raise
        yield {"done": True,
               "tokens": [p + g for p, g in zip(prompts, generated)],
               "n_new": n_new, "restored_step": self.restored_step}

    def _start_http(self, host: str, port: int) -> None:
        runtime = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # keep the server quiet
                pass

            def _send(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(*runtime.health())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/generate":
                    self._send(404, {"error": f"no route {self.path}"})
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
                try:
                    result = runtime.serve_fn(doc)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except GenerateUnavailable as e:
                    body = {"error": str(e)}
                    if e.retry_after_s is not None:
                        body["retry_after_s"] = e.retry_after_s
                    self._send(503, body)
                except Exception as e:  # generation failed; stay serving
                    self._send(500, {"error": f"generate failed: {e!r}"})
                else:
                    if "_stream" in result:
                        self._send_stream(result["_stream"])
                    else:
                        self._send(200, result)

            def _send_stream(self, stream) -> None:
                # ndjson, the end of the body delimited by the connection
                # closing; a failure after the 200 is a final error line.
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                self.close_connection = True
                try:
                    for item in stream:
                        self.wfile.write((json.dumps(item) + "\n").encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    stream.close()  # cancels the rows
                except Exception as e:  # reported in-band, stay serving
                    self.wfile.write((json.dumps(
                        {"error": f"generate failed: {e!r}"}) + "\n").encode())

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="kvedge-torch-http",
            daemon=True)
        self._http_thread.start()

    def close(self, drain: bool = False) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._http_thread.join(timeout=30)
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
        self._rows.shutdown(wait=True)

