"""The ``serve`` payload: ``POST /generate`` over the paged server.

The counterpart of the JAX package's ``run_serve_payload`` /
``_build_serve`` (``runtime/workload.py``) and of the ``/generate``
route of its status server, for one single-host paged pool. The request
contract is the reference's::

    {"tokens": [[int, ...], ...], "n_new": int,
     "temperature": float = 0, "top_p": float = 1, "seed": int = 0}
    -> {"tokens": [[prompt + generated], ...], "n_new": N,
        "restored_step": null}

Each row of a request is its own request into the shared page pool,
submitted concurrently so rows (and other clients' rows) ride the same
batched decode window. Token ids wrap modulo the vocabulary. Sampling
(``temperature > 0``) is seeded: row r's key is
``fold_in(PRNGKey(seed), r)``, so the same request returns the same
tokens. Errors map as the reference's: 400 for a malformed body, 503
when capacity does not free up (or the server is closing), 500 for a
failure. ``"stream": true`` answers newline-delimited JSON instead: one
``{"row": r, "token": t}`` record per token as it lands, rows
interleaved, then ``{"done": true, "tokens": ..., "n_new": N,
"restored_step": null}``; a failure after the 200 is a final
``{"error": ...}`` record, and a client that disconnects cancels its
rows.

``ServeRuntime`` builds everything (device check, weights from a seed,
the server, the HTTP listener); ``python -m kvedge_torch serve`` runs
it until interrupted.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.sampling import as_key_tensor, fold_in, prng_key
from kvedge_torch.models.serving import (
    PagedGenerationServer,
    ServerBusy,
    ServerClosed,
)
from kvedge_torch.models.transformer import init_params
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.devicecheck import resolve_device, run_device_check

# Request-body ceiling: a token grid is small; anything bigger is refused
# before json.loads.
_MAX_GENERATE_BODY = 1 << 20
_CLASSES = ("interactive", "batch")


class GenerateUnavailable(RuntimeError):
    """Capacity or lifecycle refusal: the client should retry (503)."""


def _serving_pool_dims(cfg: ServeConfig, tcfg: TransformerConfig
                       ) -> tuple[int, int, int, int]:
    """``(slots, pages, page_size, max_pages_per_seq)``. ``serving_pages
    = 0`` sizes the pool so every slot can hold a max_seq request."""
    slots, page_size = cfg.serving_slots, cfg.serving_page_size
    mpps = -(-tcfg.max_seq // page_size)
    pages = cfg.serving_pages or slots * mpps
    return slots, pages, page_size, mpps


def _serve_max_rows(cfg: ServeConfig, tcfg: TransformerConfig) -> int:
    """Row ceiling of one request: 4 waves of the pool's worst-case
    concurrency."""
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
    """The serving data path: device check, weights, the paged server,
    ``serve_fn`` and (with ``port`` set) the HTTP listener.

    ``device`` is the card unless "cpu" is asked for; ``params`` is a
    numpy param tree (the reference's layout) or None for weights made
    from ``seed``; ``dtype`` is the compute dtype.
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
        tree = params if params is not None else init_params(seed, self.tcfg)
        weights = params_from_numpy(tree, self.tcfg, self.device)
        slots, pages, page_size, _ = _serving_pool_dims(cfg, self.tcfg)
        self.max_rows = _serve_max_rows(cfg, self.tcfg)
        self.server = PagedGenerationServer(
            weights, self.tcfg, slots=slots, pages=pages,
            page_size=page_size, prefill_chunk=cfg.serving_prefill_chunk,
            window=cfg.serving_window, kv_dtype=cfg.serving_kv_dtype,
            device=self.device,
        )
        # Rows submit together on a bounded pool (2 x slots workers):
        # excess rows queue here instead of spawning threads.
        self._rows = concurrent.futures.ThreadPoolExecutor(
            max_workers=2 * slots, thread_name_prefix="kvedge-torch-row")
        self.httpd = None
        self._http_thread = None
        if port is not None:
            self._start_http(host or cfg.status_bind, port)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_fn(self, doc: dict) -> dict:
        """One ``POST /generate`` body -> the response document, or for
        ``"stream": true`` a document whose ``"_stream"`` iterates the
        newline-delimited JSON records (one ``{"row": r, "token": t}``
        per token, then ``{"done": true, ...}``)."""
        (tokens, n_new, temperature, top_p, seed, stream, _spec, priority,
         deadline_ms) = _parse_generate_request(
            doc, self.tcfg, max_rows=self.max_rows, paged=True)
        if priority not in _CLASSES:
            raise ValueError(f"unknown priority class {priority!r} "
                             f"(known: {list(_CLASSES)})")
        timeout = 120.0 if deadline_ms is None else deadline_ms / 1000.0
        prompts = [[t % self.tcfg.vocab for t in row] for row in tokens]

        def row_sampling(i: int):
            if temperature <= 0.0:
                return None
            return (row_key_data(seed, i), temperature, top_p)

        if stream:
            return {"_stream": self._stream(prompts, n_new, timeout,
                                            row_sampling)}
        rows: list = [None] * len(prompts)

        def one_row(i: int) -> None:
            rows[i] = self.server.submit(prompts[i], n_new, timeout=timeout,
                                         sampling=row_sampling(i))

        self._fan_out(len(prompts), one_row)
        return {"tokens": rows, "n_new": n_new, "restored_step": None}

    def _fan_out(self, n_rows: int, fn) -> None:
        """Run ``fn(i)`` for every row on the bounded row pool, rows
        together so they ride the same decode windows; then raise the
        first real fault (500), else the first capacity or lifecycle
        refusal as :class:`GenerateUnavailable` (503)."""
        errors: list = [None] * n_rows

        def guarded(i: int) -> None:
            try:
                fn(i)
            except Exception as e:  # collected; mapped to a status below
                errors[i] = e

        for fut in [self._rows.submit(guarded, i) for i in range(n_rows)]:
            fut.result()
        retriable = [e for e in errors
                     if isinstance(e, (ServerBusy, ServerClosed))]
        for e in errors:
            if e is not None and e not in retriable:
                raise e
        if retriable:
            raise GenerateUnavailable(str(retriable[0])) from retriable[0]

    def _stream(self, prompts, n_new: int, timeout: float, row_sampling):
        """Admit every row and wait for its first token HERE, so a refusal
        is still a clean 503 before the 200 is committed; then return the
        generator that merges the rows' tokens as they land."""
        sources: list = [None] * len(prompts)
        firsts: list = [None] * len(prompts)

        def prime(i: int) -> None:
            src = self.server.submit_stream(prompts[i], n_new,
                                            timeout=timeout,
                                            sampling=row_sampling(i))
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
               "n_new": n_new, "restored_step": None}

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
                    ok = runtime.server.healthy
                    self._send(200 if ok else 503,
                               {"status": "ok" if ok else "degraded"})
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
                    self._send(503, {"error": str(e)})
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
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._http_thread.join(timeout=30)
        self.server.close(drain=drain)
        self._rows.shutdown(wait=True)


def main(argv=None) -> int:
    """``python -m kvedge_torch serve [--config x.toml] [--preset P]
    [--max-seq N] [--port P] [--bind H] [--device cuda|cpu] [--seed S]
    [--dtype bfloat16|float32]``."""
    import argparse
    import dataclasses
    import signal

    ap = argparse.ArgumentParser(prog="python -m kvedge_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="serve POST /generate")
    sp.add_argument("--config", help="runtime TOML ([model], [payload], "
                    "[status])")
    sp.add_argument("--preset", choices=("probe", "flagship"))
    sp.add_argument("--max-seq", type=int)
    sp.add_argument("--port", type=int)
    sp.add_argument("--bind")
    sp.add_argument("--device", choices=("cuda", "cpu"), default=None)
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the numpy-made weights")
    sp.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)

    cfg = ServeConfig()
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = ServeConfig.parse(f.read())
    overrides = {k: v for k, v in (("preset", args.preset),
                                   ("max_seq", args.max_seq),
                                   ("status_port", args.port),
                                   ("status_bind", args.bind))
                 if v is not None}
    cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()
    runtime = ServeRuntime(cfg, device=args.device, dtype=args.dtype,
                           seed=args.seed, port=cfg.status_port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(json.dumps({"serving": f"http://{cfg.status_bind}:{runtime.port}",
                      "device": str(runtime.device),
                      "device_check": runtime.device_check.to_dict(),
                      "model": dataclasses.asdict(runtime.tcfg)}),
          flush=True)
    stop.wait()
    runtime.close(drain=True)
    return 0
