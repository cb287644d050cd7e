"""Time the bf16 flash forward (B2) against variants of its own source.

    python -m kvedge_torch.tools.flash_fwd_variants [OTHER.cu ...]

Needs one CUDA card and ``nvcc``. Each variant is
``csrc/flash_attention.cu`` with a few lines replaced (the K/V rings'
depth, the shared-memory carveout), built beside the shipped library
under ``build/kvedge_torch/`` with nvcc's log beside it; each
``OTHER.cu`` named on the command line (an earlier
version of the source, say) is built and timed beside them. A variant
that does not build is reported and left out. Every variant is first
held to the plain forward on 8 heads (O within 1e-2, LSE within 1e-5;
one that disagrees is reported and not timed). A diagnostic variant
drops part of the work (the exponentials, a product, a head's own Q or
K/V, the O store) to show that part's share of the time; its output is
wrong by construction and it is timed all the same. ``diag_timeline``
writes a record per CTA to a device array (its SM, its start and length
on the global timer, its cycles, and the cycles warps 0-2 spent waiting
on mbarriers), and one JSON line sums them up: the CTAs an SM held at
once, the SM clock, and the share of time the warps waited.

All are timed in turns with ``F.scaled_dot_product_attention(
is_causal=True)`` on the same inputs, at the flagship training shape
(BH 512, T 512, Dh 64, bf16): 10 calls captured in one CUDA graph,
CUDA events around a replay, per call, median of 5 replays, two rounds.
Prints one JSON line per variant's check and per round; the card's name
and power limit on the first line.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F

from kvedge_torch.ops import _build
from kvedge_torch.ops import attention as fa

LAUNCH = ("    if (int rc = launch_setup(flash_fwd_bf16_kernel<DH>, smem)) "
          "return rc;\n")
CARVEOUT = ("    if (int rc = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DH>,\n"
            "            cudaFuncAttributePreferredSharedMemoryCarveout, 100))\n"
            "      return rc;\n")
# name -> ((text in the shipped source, its replacement), ...)
VARIANTS = {
    "shipped": (),
    "stages3": (("constexpr int kStages = 2;",
                 "constexpr int kStages = 3;"),),
    # All of the SM's unified L1/shared memory as shared memory.
    "max_carveout": ((LAUNCH, LAUNCH + CARVEOUT),),
}
_EXP = ("s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));",
        "s[i] = fmaf(s[i], c, -mc[(i >> 1) & 1]);")
_PV = ("issue_pv<DH>(o, a, sv + sp * L::kBytes);", "")
_QK = ("issue_qk<DH>(s, sqt, sk + st * L::kBytes);", "")
# Per-CTA records for a timeline (``timeline_edits``): each warp's cycles
# waiting on mbarriers, counted in shared memory, and at the kernel's end
# a record of 8 words a CTA in a device array that ``kvedge_diag_records``
# copies out: SM, global-timer start (two words), ns, cycles, and the
# waits of warps 0-2.
_END = ("  if (tid == 0) bulk_wait_read();  // shared memory outlives the "
        "stores\n")
_WAITS = (
    ("__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {\n"
     "  uint32_t done = 0;\n",
     "__device__ __forceinline__ unsigned long long* diag_wait() {\n"
     "  __shared__ unsigned long long w[16];\n"
     "  return w;\n"
     "}\n"
     "__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {\n"
     "  const long long diag_t0 = clock64();\n"
     "  uint32_t done = 0;\n"),
    ('        : "=r"(done) : "r"(bar), "r"(parity) : "memory");\n  }\n}\n',
     '        : "=r"(done) : "r"(bar), "r"(parity) : "memory");\n  }\n'
     "  if ((threadIdx.x & 31) == 0)\n"
     "    diag_wait()[threadIdx.x >> 5] += clock64() - diag_t0;\n}\n"),
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n__device__ unsigned kvedge_diag_rec[8 * 65536];\n"),
    ("// C entry points bound with ctypes",
     'extern "C" int kvedge_diag_records(void* dst, int bytes) {\n'
     "  return static_cast<int>(\n"
     "      cudaMemcpyFromSymbol(dst, kvedge_diag_rec, bytes));\n}\n\n"
     "// C entry points bound with ctypes"),
)
_START = ("  unsigned long long diag_g0;\n"
          '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(diag_g0));\n'
          "  const long long diag_c0 = clock64();\n"
          "  if (threadIdx.x < 16) diag_wait()[threadIdx.x] = 0;\n")
_RECORD = ("  __syncthreads();\n"
           "  if (tid == 0) {\n"
           "    unsigned long long g1;\n"
           '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
           "    const long long c1 = clock64();\n"
           "    unsigned smid;\n"
           '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
           "    unsigned* rec = kvedge_diag_rec +\n"
           "                    8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
           "    rec[0] = smid;\n"
           "    rec[1] = static_cast<unsigned>(diag_g0);\n"
           "    rec[2] = static_cast<unsigned>(diag_g0 >> 32);\n"
           "    rec[3] = static_cast<unsigned>(g1 - diag_g0);\n"
           "    rec[4] = static_cast<unsigned>(c1 - diag_c0);\n"
           "    for (int w = 0; w < 3; ++w)\n"
           "      rec[5 + w] = static_cast<unsigned>(diag_wait()[w]);\n"
           "  }\n")


def timeline_edits(*kernels, end_mark=_END):
    """The edits of a timeline variant: for each kernel, a line of its own
    near its start (the timer starts after it) and the text just before
    ``end_mark``, its last line before every thread meets at its end (by
    default its final ``bulk_wait_read``; the record is written after
    it)."""
    edits = list(_WAITS)
    for start, end in kernels:
        edits += [(start, start + _START),
                  (end + end_mark, end + end_mark + _RECORD)]
    return tuple(edits)


_EXP = ("s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));",
        "s[i] = fmaf(s[i], c, -mc[(i >> 1) & 1]);")
_PV = ("issue_pv<DH>(o, a, sv + sp * L::kBytes);", "")
_QK = ("issue_qk<DH>(s, sqt, sk + st * L::kBytes);", "")
DIAGNOSTICS = {
    "diag_no_exp": (_EXP,),
    "diag_no_products": (_PV, _QK),
    # Every CTA reads head 0's K and V (all from L2 after the first).
    "diag_kv_of_one_head": (
        ("ring_load<DH, kStages>(&map_k, sk, full_k, g, stream_tile(g, first),"
         "\n                             bh);\n"
         "      ring_load<DH, kStages>(&map_v, sv, full_v, g, stream_tile(g, "
         "first),\n                             bh);",
         "ring_load<DH, kStages>(&map_k, sk, full_k, g, stream_tile(g, first),"
         "\n                             0);\n"
         "      ring_load<DH, kStages>(&map_v, sv, full_v, g, stream_tile(g, "
         "first),\n                             0);"),
        ("release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g0, n_loads,"
         "\n                               first, bh);",
         "release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g0, n_loads,"
         "\n                               first, 0);"),
        ("release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g, n_loads,"
         "\n                                   first, bh);",
         "release_stage<DH, kStages>(&map_k, sk, full_k, empty_k, g, n_loads,"
         "\n                                   first, 0);"),
        ("release_stage<DH, kStages>(&map_v, sv, full_v, empty_v, g - 1, "
         "n_loads,\n                                 first, bh);",
         "release_stage<DH, kStages>(&map_v, sv, full_v, empty_v, g - 1, "
         "n_loads,\n                                 first, 0);")),
    # Every CTA reads head 0's Q tiles.
    "diag_q_of_one_head": (("it == 0 ? first : pair, bh);",
                            "it == 0 ? first : pair, 0);"),),
    # O is staged in shared memory but never stored.
    "diag_no_o_store": (("    store_tile<DH>(&map_o, sqt, qt, bh);\n",
                         "    __syncthreads();\n"),),
    # A record per CTA (see timeline()); the outputs stay right.
    "diag_timeline": timeline_edits(
        ("  const uint32_t sq = (smem_u32(fwd_smem) + 1023u) & ~1023u;  "
         "// 2 Q tiles\n",
         "m[h] * scale + logf(l[h]);\n    }\n  }\n")),
}
BH, T, DH = 512, 512, 64


def build(name: str, edits, kernel: str = "flash_attention") -> ctypes.CDLL:
    """The library of the shipped ``csrc/<kernel>.cu`` (its local headers
    inlined, ``_build.source``) with ``edits`` applied, or of the file
    ``edits`` names (its headers taken from beside it where they are
    there, so an older version builds with its own)."""
    if not edits:
        return _build.load(kernel)
    if isinstance(edits, pathlib.Path):
        src = _build.expand_includes(edits)
    else:
        src = _build.source(kernel)
        for old, new in edits:
            assert old in src, f"{name}: {old!r} is not in the source"
            src = src.replace(old, new)
    path = _build.BUILD_DIR / f"{kernel}_{name}.cu"
    lib = _build.BUILD_DIR / f"lib{kernel}_{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(path)], capture_output=True,
                          text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    proc.check_returncode()
    return ctypes.CDLL(str(lib))


def graph_ms(fn, reps=10, runs=5, stream=None) -> float:
    """Device ms of one call: ``reps`` calls captured in one CUDA graph,
    CUDA events around a replay, per call, the median of ``runs``.
    ``stream`` is the side stream to capture on (a new one when None): an
    autograd backward runs on its forward's stream, so that forward must
    have run there."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def timeline(lib, call, n_cta) -> dict:
    """What a timeline variant's records say of one warm ``call`` of its
    library ``lib`` launching ``n_cta`` CTAs: per CTA its SM, start and
    length on the global timer (ns), its cycles, and the cycles warps 0-2
    spent waiting on mbarriers (warp 0 also waits for ring stages to
    empty before it refills them)."""
    call()
    call()
    torch.cuda.synchronize()
    rec = torch.empty(8 * n_cta, dtype=torch.int32)
    rc = lib.kvedge_diag_records(ctypes.c_void_p(rec.data_ptr()),
                                 ctypes.c_int(rec.numel() * 4))
    assert rc == 0, f"reading the records failed: {rc}"
    return timeline_stats(rec)


def timeline_stats(rec) -> dict:
    """Sums up 8 int32 words a CTA (SM, global-timer start low and high
    words, ns, cycles, the cycles warps 0-2 waited on mbarriers)."""
    n_cta = rec.numel() // 8
    rec = rec.view(n_cta, 8).cpu().long() & 0xFFFFFFFF
    sm, ns, cyc = rec[:, 0], rec[:, 3], rec[:, 4]
    start = rec[:, 1] | (rec[:, 2] << 32)
    start = start - start.min()
    end = start + ns
    most = 0
    for s in sm.unique().tolist():  # most CTAs an SM held at once
        on = (sm == s).nonzero().flatten()
        ev = sorted([(int(start[i]), 1) for i in on] +
                    [(int(end[i]), -1) for i in on])
        now = 0
        for _, d in ev:
            now += d
            most = max(most, now)
    span = int(end.max())
    n_sm = int(sm.unique().numel())
    return {"ctas": n_cta, "sms": n_sm, "span_us": span / 1e3,
            "cta_us_mean": float(ns.float().mean()) / 1e3,
            "cta_us_min": int(ns.min()) / 1e3,
            "cta_us_max": int(ns.max()) / 1e3,
            "ctas_an_sm_most": most,
            "ctas_an_sm_mean": float(ns.sum()) / (span * n_sm),
            "sm_ghz": float(cyc.sum()) / float(ns.sum()),
            "wait_share_warps_0_1_2": [
                float(rec[:, 5 + w].sum()) / float(cyc.sum())
                for w in range(3)]}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    every = {**VARIANTS, **DIAGNOSTICS,
             **{pathlib.Path(a).stem: pathlib.Path(a) for a in sys.argv[1:]}}
    with concurrent.futures.ThreadPoolExecutor(len(every)) as ex:
        futures = {n: ex.submit(build, n, e) for n, e in every.items()}
    libs = {}
    for name, fut in futures.items():
        try:
            libs[name] = fut.result()
        except Exception as exc:  # noqa: BLE001 - report it, time the rest
            print(json.dumps({"variant": name, "built": False,
                              "error": str(exc)[-2000:]}), flush=True)
    gen = torch.Generator().manual_seed(77)
    q, k, v = (torch.randn((BH, T, DH), generator=gen).to(torch.bfloat16)
               .cuda() for _ in range(3))
    want_o, want_lse = fa.flash_forward_reference(q[:8], k[:8], v[:8])
    calls = {}
    for name, lib in libs.items():
        fn = lib.kvedge_flash_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        out = torch.empty_like(q)
        lse = torch.empty((BH, T), device="cuda")

        def call(fn=fn, out=out, lse=lse):
            rc = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), BH, T, DH,
                    fa.softmax_scale(DH),
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch failed: {rc}"

        call()
        torch.cuda.synchronize()
        err = (float((out[:8].float() - want_o.float()).abs().max()),
               float((lse[:8] - want_lse).abs().max()))
        agrees = (torch.allclose(out[:8].float(), want_o.float(), rtol=1e-2,
                                 atol=1e-2)
                  and torch.allclose(lse[:8], want_lse, rtol=1e-5, atol=1e-5))
        print(json.dumps({"variant": name, "agrees": agrees,
                          "max_abs_err": err,
                          "diagnostic": name in DIAGNOSTICS}), flush=True)
        if agrees or name in DIAGNOSTICS:
            calls[name] = call
        if name == "diag_timeline":
            n_cta = len(fa.cta_tiles(T, "fwd")) * BH
            print(json.dumps({"timeline": timeline(lib, call, n_cta),
                              "card": smi}), flush=True)
    shaped = [x.reshape(BH // 8, 8, T, DH) for x in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*shaped, is_causal=True)
    for rnd in range(2):
        row = {"round": rnd, "sdpa_ms": graph_ms(sdpa)}
        row.update({f"{n}_ms": graph_ms(c) for n, c in calls.items()})
        row["sdpa_ms_after"] = graph_ms(sdpa)
        print(json.dumps({**row, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
