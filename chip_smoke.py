#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin``, PATH or
``/usr/local/cuda/bin``) and the repository checkout around this file;
imports nothing of JAX. Phases, each printing one JSON line:

1. device   torch's device name and count, and ``nvidia-smi``'s name and
            power limit (printed raw on a line of its own as well).
2. build    nvcc of every kernel source for sm_90a into build/kvedge_torch.
3. kernel   the paged-decode kernel against its plain PyTorch version on
            the card: bf16 and fp32, MHA (H=K=8) and GQA (H=8, K=2), page
            16 at live lengths {1, 15, 16, 17, 300} and page 128 at
            {511, 512, 513, 4096} in ragged batches, int8 pools at pages
            16 and 128. Tolerance rtol=atol=1e-5 for fp32, 1e-2 for bf16
            and int8. The plain version is itself held to a float64
            recomputation of the same rounding chain.
4. serve    the port's entry point (``kvedge_torch.runtime.serve``) on
            127.0.0.1 at the flagship preset (vocab 32000, d_model 512,
            8 heads, 8 layers, d_ff 2048, bf16, numpy-seeded weights),
            max_seq 2048, 4 slots, page 16, prefill chunk 64, window 64;
            9 concurrent POST /generate requests (prompts 8..1500 tokens,
            n_new 64..128, one two-row request, two seeded sampled ones).
            Launch counts are zeroed just before this burst and read just
            after it. Checks: response shape, launches >= n_layers x
            decode steps, a sampled request resubmitted alone returns the
            same tokens, the two-row request streamed as ndjson returns
            its buffered tokens, and at fp32 the kernel path returns the tokens of
            the plain ``paged_attention="gather"`` path and of the naive
            forward pass.
5. timings  CUDA-event times at the serve phase's decode shapes (L2
            flushed before each launch): the kernel, its plain version,
            ``F.scaled_dot_product_attention`` over the gathered K/V as a
            library yardstick the port never calls, the byte bound; and
            the serve burst's decode tokens/s and request latency p50/p99.
6. kernels  one line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``; any failed check
exits non-zero before it. Without a card, or without the repository
around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CARD: dict = {}  # the nvidia-smi name and power limit, once read


class CheckFailed(RuntimeError):
    pass


def emit(doc: dict) -> None:
    """Print one phase's JSON line, stamped with the card it ran on."""
    print(json.dumps({**doc, **CARD}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ---- phase 3: kernel vs plain -------------------------------------------

def make_case(torch, *, dtype, heads, kv_heads, page, lives, int8, seed,
              device="cuda"):
    """Ragged inputs on the card: row b lives through ``lives[b]`` keys."""
    gen = torch.Generator().manual_seed(seed)
    dh = 64
    q_pos = [n - 1 for n in lives]
    max_pages = max(p // page + 1 for p in q_pos) + 1
    pages = sum(p // page + 1 for p in q_pos) + 2
    tables = torch.zeros((len(lives), max_pages), dtype=torch.int32)
    # Pages handed out in a shuffled order, as a live pool hands them out.
    order = torch.randperm(pages - 1, generator=gen) + 1
    nxt = 0
    for b, p in enumerate(q_pos):
        for j in range(p // page + 1):
            tables[b, j] = int(order[nxt])
            nxt += 1
    td = getattr(torch, dtype)
    q = torch.randn((len(lives), heads, dh), generator=gen).to(td)
    shape = (pages, page, kv_heads, dh)
    kw = {}
    if int8:
        pool_k = torch.randint(-127, 128, shape, generator=gen,
                               dtype=torch.int8)
        pool_v = torch.randint(-127, 128, shape, generator=gen,
                               dtype=torch.int8)
        kw = {"scale_k": torch.rand(shape[:3], generator=gen) * 0.02 + 1e-3,
              "scale_v": torch.rand(shape[:3], generator=gen) * 0.02 + 1e-3}
    else:
        pool_k = torch.randn(shape, generator=gen).to(td)
        pool_v = torch.randn(shape, generator=gen).to(td)
    dev = torch.device(device)
    args = [t.to(dev) for t in (q, pool_k, pool_v, tables,
                                torch.tensor(q_pos, dtype=torch.int32))]
    return args, {k: v.to(dev) for k, v in kw.items()}


def float64_chain(torch, q, pool_k, pool_v, tables, q_pos, scale_k=None,
                  scale_v=None):
    """The gather's rounding chain with float64 arithmetic between the
    rounding points (dot, divide, weights, output rounded to q's dtype)."""
    dt = q.dtype

    def rnd(x):
        return x.to(dt).double()

    b, h, dh = q.shape
    page, kv = pool_k.shape[1], pool_k.shape[2]
    idx = tables.long()
    k, v = pool_k[idx].double(), pool_v[idx].double()
    if scale_k is not None:
        k = rnd(k * scale_k[idx].double()[..., None])
        v = rnd(v * scale_v[idx].double()[..., None])
    s_cap = idx.shape[1] * page
    k = k.reshape(b, s_cap, kv, dh)
    v = v.reshape(b, s_cap, kv, dh)
    g = h // kv
    qg = q.double().reshape(b, kv, g, dh)
    div = torch.tensor(math.sqrt(dh), dtype=dt).double()
    s = rnd(rnd(torch.einsum("bkgd,bskd->bkgs", qg, k)) / div)
    live = torch.arange(s_cap, device=q.device)[None] <= q_pos[:, None].long()
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    w = rnd(torch.softmax(s, dim=-1))
    out = torch.einsum("bkgs,bskd->bkgd", w, v).reshape(b, h, dh)
    return out.to(dt)


def phase_kernel_vs_plain(torch, pa, device="cuda"):
    cases = []
    for dtype in ("bfloat16", "float32"):
        for heads, kv in ((8, 8), (8, 2)):
            for page, lives in ((16, [1, 15, 16, 17, 300]),
                                (128, [511, 512, 513, 4096])):
                cases.append(dict(dtype=dtype, heads=heads, kv_heads=kv,
                                  page=page, lives=lives, int8=False))
    for dtype in ("bfloat16", "float32"):
        for page, lives in ((16, [37, 16, 300, 1]),
                            (128, [511, 512, 513, 2000])):
            cases.append(dict(dtype=dtype, heads=8, kv_heads=2, page=page,
                              lives=lives, int8=True))
    worst = 0.0
    for i, case in enumerate(cases):
        args, kw = make_case(torch, seed=100 + i, device=device, **case)
        got = pa.paged_decode_attention(*args, **kw)
        if device == "cuda":
            torch.cuda.synchronize()  # a fault surfaces here, attributed
        plain = pa.paged_decode_attention_reference(*args, **kw)
        chain = float64_chain(torch, *args, **kw)
        tol = TOL[case["dtype"]] if not case["int8"] else 1e-2
        err = float((got.float() - plain.float()).abs().max())
        err64 = float((plain.float() - chain.float()).abs().max())
        ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
            got.float(), plain.float(), rtol=tol, atol=tol) and \
            torch.allclose(plain.float(), chain.float(), rtol=tol, atol=tol)
        emit({"phase": "kernel", "case": i, **case, "tol": tol,
              "max_abs_err": err, "plain_vs_float64_err": err64, "ok": ok})
        check(ok, f"kernel case {i} {case} disagrees (kernel-plain {err}, "
              f"plain-float64 {err64})")
        worst = max(worst, err / tol)
    return cases, worst


# ---- phase 4: serve -----------------------------------------------------

def post(url, doc, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_stream(url, doc, timeout=600):
    """A streamed request's ndjson records, in arrival order."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return [json.loads(ln) for ln in r.read().splitlines()]


def serve_requests(np, vocab):
    rng = np.random.default_rng(2026)

    def prompt(n):
        return rng.integers(0, vocab, n).tolist()

    reqs = [{"tokens": [prompt(n)], "n_new": m}
            for n, m in ((8, 128), (100, 96), (333, 64), (700, 128),
                         (1000, 80), (1500, 128))]
    two = prompt(200)
    reqs.append({"tokens": [two, list(reversed(two))], "n_new": 72})
    reqs.append({"tokens": [prompt(50)], "n_new": 100, "temperature": 0.8,
                 "top_p": 0.9, "seed": 7})
    reqs.append({"tokens": [prompt(400)], "n_new": 64, "temperature": 1.2,
                 "top_p": 0.95, "seed": 12345})
    return reqs


def check_response(doc, req, vocab):
    check(set(doc) >= {"tokens", "n_new", "restored_step"},
          f"response keys {sorted(doc)}")
    check(doc["n_new"] == req["n_new"] and doc["restored_step"] is None,
          "n_new / restored_step")
    rows = doc["tokens"]
    check(len(rows) == len(req["tokens"]), "row count")
    for row, p in zip(rows, req["tokens"]):
        check(len(row) == len(p) + req["n_new"], "row length")
        check(row[:len(p)] == [t % vocab for t in p], "prompt echo")
        check(all(isinstance(t, int) and 0 <= t < vocab for t in row),
              "token ids in range")


def run_burst(url, reqs):
    out = [None] * len(reqs)
    lat = [0.0] * len(reqs)

    def one(i):
        t0 = time.perf_counter()
        out[i] = post(url, reqs[i])
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a request never returned")
    return out, lat, time.perf_counter() - t0


def phase_serve(torch, np, pa, serve, ServeConfig, forward, device="cuda",
                preset="flagship", max_seq=2048):
    cfg = ServeConfig(preset=preset, max_seq=max_seq, serving_slots=4,
                      serving_page_size=16, serving_prefill_chunk=64,
                      serving_window=64)
    rt = serve.ServeRuntime(cfg, device=device, dtype="bfloat16", seed=0,
                            host="127.0.0.1", port=0)
    try:
        vocab, layers = rt.tcfg.vocab, rt.tcfg.n_layers
        url = f"http://127.0.0.1:{rt.port}/generate"
        check(post(url, {"tokens": [[1, 2, 3]], "n_new": 4})[0] == 200,
              "warm-up request")
        reqs = serve_requests(np, vocab)
        stats0 = rt.server.stats()
        pa.paged_decode_attention.launches = 0
        results, lat, wall = run_burst(url, reqs)
        launches = pa.paged_decode_attention.launches
        stats = rt.server.stats()
        steps = stats["decode_steps"] - stats0["decode_steps"]
        decode_s = stats["decode_s"] - stats0["decode_s"]
        prefill_s = stats["prefill_s"] - stats0["prefill_s"]
        for (code, doc), req in zip(results, reqs):
            check(code == 200, f"HTTP {code}: {doc}")
            check_response(doc, req, vocab)
        check(steps > 0 and launches >= layers * steps,
              f"{launches} kernel launches < {layers} x {steps} steps")
        again = post(url, reqs[-1])
        check(again[0] == 200 and again[1]["tokens"] ==
              results[-1][1]["tokens"], "sampled request not reproducible")
        streamed = post_stream(url, dict(reqs[6], stream=True))
        check(streamed[-1].get("done") is True and
              streamed[-1]["tokens"] == results[6][1]["tokens"] and
              len(streamed) - 1 == reqs[6]["n_new"] * 2,
              "streamed request differs from its buffered answer")
        gen_tokens = sum(r["n_new"] * len(r["tokens"]) for r in reqs)
        lat_sorted = sorted(lat)
        serve_doc = {
            "phase": "serve", "model": preset, "dtype": "bfloat16",
            "requests": len(reqs), "rows": sum(len(r["tokens"]) for r in reqs),
            "generated_tokens": gen_tokens, "decode_steps": steps,
            "windows": stats["windows"] - stats0["windows"],
            "kernel_launches": launches,
            "decode_s": decode_s, "prefill_s": prefill_s,
            "ms_per_decode_step": decode_s / steps * 1e3,
            "launches_per_step": launches / steps, "wall_s": wall,
            "decode_tokens_per_s": gen_tokens / wall,
            "latency_p50_s": float(np.percentile(lat_sorted, 50)),
            "latency_p99_s": float(np.percentile(lat_sorted, 99)),
            "latencies_s": lat, "ok": True,
        }
        emit(serve_doc)
        emit(profile_request(torch, url, dict(reqs[3], n_new=65)))
        # Decode shapes of the burst for the timing phase: the first four
        # single-row requests half-way through their generation.
        lives = [len(r["tokens"][0]) + r["n_new"] // 2 for r in reqs[:4]]
    finally:
        rt.close()

    # fp32: the kernel path against the plain gather path and against
    # the naive forward pass, on the burst's greedy single-row requests.
    greedy = [dict(r, n_new=24) for r in reqs[:6]]
    tokens = {}
    counts = {}
    for mode in ("auto", "gather"):
        cfg32 = ServeConfig(preset=preset, max_seq=max_seq, serving_slots=4,
                            serving_page_size=16, serving_prefill_chunk=64,
                            serving_window=64, payload_paged_attention=mode)
        rt = serve.ServeRuntime(cfg32, device=device, dtype="float32",
                                seed=0)
        try:
            pa.paged_decode_attention.launches = 0
            out = [None] * len(greedy)

            def one(i, rt=rt, out=out):
                out[i] = rt.serve_fn(greedy[i])

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(greedy))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            tokens[mode] = [d["tokens"] for d in out]
            counts[mode] = pa.paged_decode_attention.launches
            if mode == "auto":
                seq = torch.tensor(tokens[mode][1], device=device)
                logits = forward(rt.server._params, seq, rt.tcfg)
                n_p = len(greedy[1]["tokens"][0])
                want = logits[0, n_p - 1:-1].argmax(-1).tolist()
                forward_ok = tokens[mode][1][0][n_p:] == want
        finally:
            rt.close()
    same = tokens["auto"] == tokens["gather"]
    emit({"phase": "serve_fp32", "requests": len(greedy),
          "kernel_launches": counts["auto"],
          "gather_launches": counts["gather"],
          "kernel_equals_gather": same, "kernel_equals_forward": forward_ok,
          "ok": same and forward_ok and counts["auto"] > 0
          and counts["gather"] == 0})
    check(same, "fp32 kernel tokens differ from the gather path's")
    check(forward_ok, "fp32 kernel tokens differ from forward's argmax")
    check(counts["auto"] > 0 and counts["gather"] == 0,
          f"launch counts auto={counts['auto']} gather={counts['gather']}")
    return serve_doc, lives, launches


def profile_request(torch, url, req):
    """One request under torch.profiler: the device's busy share of the
    request's wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        code, _ = post(url, req)
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(code == 200, f"profiled request: HTTP {code}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "profile", "request_prompt": len(req["tokens"][0]),
            "n_new": req["n_new"], "wall_ms": wall_ms,
            "device_busy_ms": busy if kernels else None,
            "device_idle_share": 1 - busy / wall_ms if kernels else None,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top], "ok": True}


# ---- phase 5: timings ---------------------------------------------------

def _median_ms(torch, run, flush, reps):
    times = []
    for _ in range(reps):
        flush.zero_()  # L2 cold, as the decode loop finds it
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_ms(torch, fn, flush, reps=30):
    """(device ms, call ms) of ``fn``, medians over ``reps`` with L2
    flushed before each. Device ms replays ``fn`` captured in a CUDA
    graph, so host launch overhead is not on the clock; call ms runs
    ``fn`` eagerly, as the serving loop does, and includes the gaps the
    host leaves between its kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return (_median_ms(torch, graph.replay, flush, reps),
            _median_ms(torch, fn, flush, reps))


def bound(lives, heads, kv_heads, dh, itemsize, page, int8=False):
    """(least ms, "bytes" | "operations", bytes) for one call: each live
    K/V row read once (int8 rows with their two fp32 scales), q, q_pos
    and the live table entries read once, the output written once."""
    live = sum(lives)
    kv_bytes = live * kv_heads * dh * 2 * (1 if int8 else itemsize)
    if int8:
        kv_bytes += live * kv_heads * 4 * 2
    io_bytes = len(lives) * (2 * heads * dh * itemsize + 4) + \
        sum(4 * math.ceil(n / page) for n in lives)
    flops = 4 * live * heads * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if itemsize == 2 else FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv_bytes + io_bytes


def phase_timings(torch, pa, lives, serve_doc, max_seq=2048, page=16):
    """The serve burst's decode shape: 4 rows, flagship heads, page 16."""
    import torch.nn.functional as F

    heads = kv = 8
    dh = 64
    gen = torch.Generator().manual_seed(5)
    max_pages = max_seq // page
    pages = 4 * max_pages
    dev = torch.device("cuda")
    perm = torch.randperm(pages, generator=gen).to(torch.int32)
    tables = perm.reshape(4, max_pages).to(dev)
    q = torch.randn((4, heads, dh), generator=gen).to(torch.bfloat16).to(dev)
    pool_k = torch.randn((pages, page, kv, dh), generator=gen).to(
        torch.bfloat16).to(dev)
    pool_v = torch.randn((pages, page, kv, dh), generator=gen).to(
        torch.bfloat16).to(dev)
    q_pos = torch.tensor([n - 1 for n in lives], dtype=torch.int32,
                         device=dev)
    args = (q, pool_k, pool_v, tables, q_pos)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    got = pa.paged_decode_attention(*args)
    plain = pa.paged_decode_attention_reference(*args)
    err = float((got.float() - plain.float()).abs().max())
    # Library yardstick: SDPA over the gathered K/V with a length mask
    # (the gather itself is outside the timed call).
    k = pa.gather_pages(pool_k, None, tables, q.dtype).transpose(1, 2)
    v = pa.gather_pages(pool_v, None, tables, q.dtype).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    mask = (torch.arange(k.shape[2], device=dev)[None] <= q_pos[:, None])
    mask = mask[:, None, None, :]
    qs = q[:, :, None]
    lib = F.scaled_dot_product_attention(qs, k, v, attn_mask=mask)[:, :, 0]
    lib_err = float((lib.float() - plain.float()).abs().max())
    ms, call_ms = time_ms(torch, lambda: pa.paged_decode_attention(*args),
                          flush)
    plain_ms, plain_call_ms = time_ms(
        torch, lambda: pa.paged_decode_attention_reference(*args), flush)
    library_ms, library_call_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qs, k, v,
                                                      attn_mask=mask), flush)
    bound_ms, bound_by, nbytes = bound(lives, heads, kv, dh, 2, page)
    # A long-context leg at page 128 (one row at live 4096), for PERF.md.
    long_args, _ = make_case(torch, dtype="bfloat16", heads=8, kv_heads=8,
                             page=128, lives=[4096], int8=False, seed=9)
    long_ms, _ = time_ms(torch, lambda: pa.paged_decode_attention(*long_args),
                         flush)
    long_plain_ms, _ = time_ms(
        torch, lambda: pa.paged_decode_attention_reference(*long_args), flush)
    long_bound, _, _ = bound([4096], 8, 8, dh, 2, 128)
    doc = {"phase": "timings", "shape": {"rows": 4, "heads": heads,
                                         "kv_heads": kv, "d_head": dh,
                                         "page": page, "max_pages": max_pages,
                                         "lives": lives, "dtype": "bfloat16"},
           "timing": "device ms: CUDA-graph replay, L2 flushed, median of "
                     "30; call ms: eager call on the stream, same",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "call_ms": call_ms, "plain_call_ms": plain_call_ms,
           "library_call_ms": library_call_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention "
                      "over pre-gathered K/V, bool length mask",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "longctx_page128_live4096": {"ms": long_ms,
                                        "plain_ms": long_plain_ms,
                                        "bound_ms": long_bound},
           "l2_flushed": True,
           "e2e": {k: serve_doc[k] for k in (
               "decode_tokens_per_s", "latency_p50_s", "latency_p99_s",
               "ms_per_decode_step")},
           "ok": err <= 1e-2}
    emit(doc)
    check(err <= 1e-2, f"timing-shape kernel disagrees by {err}")
    return doc


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures "
              "the port on the card and has nothing to run here",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from kvedge_torch.models.transformer import forward
        from kvedge_torch.ops import _build
        from kvedge_torch.ops import paged_attention as pa
        from kvedge_torch.runtime import serve
        from kvedge_torch.runtime.config import ServeConfig
        from kvedge_torch.runtime.devicecheck import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the kvedge_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    phase = "device"
    try:
        resolve_device("cuda")
        smi = nvidia_smi()
        print(smi, flush=True)
        CARD["card"] = smi
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        emit({"phase": "device", "kind": name, "count": count,
              "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "ok": True})

        phase = "build"
        t0 = time.perf_counter()
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
            list(ex.map(_build.build, sources))
        ptxas = {s: [ln.strip() for ln in _build.build_info[s]["log"]
                     .splitlines() if "registers" in ln]
                 for s in sources}
        emit({"phase": "build", "sources": sources,
              "seconds": time.perf_counter() - t0,
              "per_source_seconds": {s: _build.build_info[s]["seconds"]
                                     for s in sources},
              "ptxas_registers": ptxas, "ok": True})

        phase = "kernel"
        _, worst = phase_kernel_vs_plain(torch, pa)

        phase = "serve"
        serve_doc, lives, launches = phase_serve(torch, np, pa, serve,
                                                 ServeConfig, forward)

        phase = "timings"
        t = phase_timings(torch, pa, lives, serve_doc)

        phase = "kernels"
        kernels = [{
            "name": "paged_decode", "route": "cuda",
            "source": "kvedge_torch/ops/csrc/paged_decode.cu",
            "replaces": "kvedge_tpu/ops/paged_attention.py:95",
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "max_err": t["max_abs_err"], "worst_err_over_tol": worst,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ok": True,
        }]
        print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    except Exception as e:  # the run failed: say where, print no result
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
