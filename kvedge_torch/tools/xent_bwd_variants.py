"""Time the bf16 fused cross-entropy forward (B5) and backward (B6 dx,
B7 dE) against other versions of their source, and against the
library's forward and backward.

    python -m kvedge_torch.tools.xent_bwd_variants [--forward | --backward]
        [OTHER.cu ...]

Needs one CUDA card and ``nvcc``. Builds the shipped ``csrc/xent.cu``,
its variants (string edits of it) and each ``OTHER.cu`` named on the
command line (an earlier version of the source, say ``git show
HEAD~1:kvedge_torch/ops/csrc/xent.cu``, with the ``hopper.cuh`` of its
commit beside it where the current one no longer builds it) beside them
under ``build/kvedge_torch/``; a version that does not build is reported
and left out. ``--forward`` takes the forward's versions only,
``--backward`` the backward's; by default both.

Forward versions: a ring of 4 stages for 6; 2 or 3 K-chunk products
left running while the last tile is folded for 1; the fold after the
tile's products instead of beside them; the fold on the accumulator
itself instead of a copy (ptxas then serializes the wgmmas); clusters of
2 CTAs sharing each K-chunk by TMA multicast. Each is first held to
the plain forward at N 1032, 200, 136 and 8 (V 32000, 1000, 330, 640;
D 512, 256, 128, 64: lse and the target logit within 1e-5 relative and
1e-4 absolute) and run twice, which must agree bit for bit. Diagnostics
drop the score product, the exponentials or the fold.

Backward versions: each streamed tile shared by a cluster of 2 or 4 CTAs
through TMA multicast, a deeper ring, another L2 promotion. The shipped
layout splits D between the two consumer warpgroups for the score
product as well and sums the fp32 partials; the other layout of the
design, each warpgroup computing half of the score columns over all of D
and sharing ds through a bf16 tile, is such an older version. Each
version's dx and dE passes are first held to the plain backward at N
1032, V 32000 and at N 200, V 1000 (D 512 and 256, bf16: dx within two
bf16 ulps and dE within one of their largest entry) and run twice, which
must agree bit for bit; one that fails or does not launch (a ring too
deep for shared memory) is reported and not timed. Diagnostics drop the
score product, the gradient product, the exponentials, the exchange of
the score partials.

A diagnostic's output is wrong by construction; it is timed all the
same, to show the share of the time of what it drops.
``diag_timeline`` (backward) and ``fwd_diag_timeline`` write a record
per CTA (flash_fwd_variants.timeline): CTAs an SM, the SM clock, and the
share of time consumer warps 0-2 waited on mbarriers.

Then, at the flagship training shape (N 32768, V 32000, D 512, bf16),
every version and the library's pass are timed in turns by CUDA-graph
replay (10 calls captured in one graph, CUDA events around a replay, per
call, the median of 5 replays), two rounds. The library's forward is a
bf16 ``torch.mm`` upcast to fp32 logits, then ``F.cross_entropy``; its
backward is ``autograd.grad`` through that, whose forward ran once
outside the clock (dx and dE in one call). Each round prints one JSON
line: the times and, per version, its ratio to the library (the
backward's (dx + dE) / library). The card's name and power limit are on
the first line.
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

from kvedge_torch.ops import xent as xe
from kvedge_torch.tools.flash_fwd_variants import (build, graph_ms,
                                                   timeline, timeline_edits)

# The kernel's last line before it ends, after its output stores.
_KERNEL_END = ("            make_float2(acc[i], acc[i + 1]);\n      }\n    }\n"
               "  }\n")
# The shipped kernel with clusters of ``c`` CTAs that own neighbouring
# resident blocks and share the stream: each loads 64 / c rows of every
# tile and multicasts them to all, and a stage is refilled once every
# consumer warp of the cluster has released it.
_CLUSTER_HELPERS = """\
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask) : "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\\n.reg .b32 remote;\\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\\n}\\n"
      ::"r"(bar), "r"(cta) : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\\n"
      "barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
}
"""


def cluster_edits(c: int):
    """The edits that share each streamed tile across a cluster of ``c``."""
    return (
        ("// The warpgroup's registers a thread drop to (dec) or rise to (inc) N;\n",
         _CLUSTER_HELPERS + "// The warpgroup's registers a thread drop to "
         "(dec) or rise to (inc) N;\n"),
        ("constexpr int kBwdStages = 2;  // streamed tiles in flight\n",
         "constexpr int kBwdStages = 2;  // streamed tiles in flight\n"
         f"constexpr int kBwdCluster = {c};\n"),
        ("  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8u * s);\n",
         "  if ((threadIdx.x & 31) == 0)\n"
         "    for (int r = 0; r < kBwdCluster; ++r)\n"
         "      mbar_arrive_cluster(empty + 8u * s, r);\n"),
        ("mbar_init(empty + 8u * s, L::kConsumers / 32);",
         "mbar_init(empty + 8u * s, L::kConsumers / 32 * kBwdCluster);"),
        ("  __syncthreads();  // the barriers exist before any thread uses them\n",
         "  cluster_sync();\n"),
        ("        for (int p = 0; p < L::kPanels; ++p)\n"
         "          tma_load_2d(sb + s * L::kTileBytes + p * L::kPanelBytes, &map_b,\n"
         "                      bar, 64 * p, t * kBwdRows);\n",
         "        const int rank = static_cast<int>(cluster_rank());\n"
         "        constexpr int kSlice = kBwdRows / kBwdCluster;\n"
         "        for (int p = 0; p < L::kPanels; ++p)\n"
         "          tma_load_2d_multicast(\n"
         "              sb + s * L::kTileBytes + p * L::kPanelBytes +\n"
         "                  rank * kSlice * 128,\n"
         "              &map_b, bar, 64 * p, t * kBwdRows + rank * kSlice,\n"
         "              (1u << kBwdCluster) - 1);\n"),
        (_KERNEL_END, _KERNEL_END + "  __syncwarp();\n  cluster_sync();\n"),
        ("kDx ? v : n,\n                                  kBwdRows))",
         "kDx ? v : n,\n                                  kBwdRows / kBwdCluster))"),
        ("  kernel<<<(a_rows + kBwdRows - 1) / kBwdRows, L::kThreads, L::kSmem,\n"
         "           stream>>>(map_a, map_b, map_lse, map_g, map_tgt, tgt, lse, g, out,\n"
         "                     n, v);\n",
         "  const int clusters = (a_rows + kBwdRows * kBwdCluster - 1) /\n"
         "                       (kBwdRows * kBwdCluster);\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(clusters * kBwdCluster);\n"
         "  cfg.blockDim = dim3(L::kThreads);\n"
         "  cfg.dynamicSmemBytes = L::kSmem;\n"
         "  cfg.stream = stream;\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = kBwdCluster;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  if (int rc = static_cast<int>(cudaLaunchKernelEx(\n"
         "          &cfg, kernel, map_a, map_b, map_lse, map_g, map_tgt, tgt, lse, g,\n"
         "          out, n, v)))\n"
         "    return rc;\n"),
    )


# name -> ((text in the shipped source, its replacement), ...)
VARIANTS = {
    "shipped": (),
    "cluster2": cluster_edits(2),
    "cluster4": cluster_edits(4),
    # 274 KB at D 512: does not fit a block, so it cannot launch there.
    "stages3": (("constexpr int kBwdStages = 2;",
                 "constexpr int kBwdStages = 3;"),),
    # 256-byte L2 promotion of the tiles' loads.
    "l2_256": (("CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,",
                "CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,"),),
    # A record per CTA; the outputs stay right.
    "diag_timeline": timeline_edits(
        ("  const int n_tiles = (b_rows + kBwdRows - 1) / kBwdRows;\n", ""),
        end_mark=_KERNEL_END),
}
_EXCHANGE = ("        for (int i = 0; i < 32; ++i) part[(w * 32 + i) * 128 + lt] = sc[i];\n"
             "        named_sync(1, L::kConsumers);\n"
             "#pragma unroll\n"
             "        for (int i = 0; i < 32; ++i)\n"
             "          sc[i] += part[((1 - w) * 32 + i) * 128 + lt];\n"
             "        named_sync(1, L::kConsumers);\n", "")
# Each drops part of the work to show its share of the time; their
# outputs are wrong by construction and they are timed all the same.
DIAGNOSTICS = {
    "diag_no_scores": (("issue_scores<D>(sc, sa, sb + s * L::kTileBytes, w);",
                        ""),),
    "diag_no_grad": (("issue_grad<D>(acc, a, sbn + ((t - 1) % S) * L::kTileBytes);",
                      ""),),
    "diag_no_exp": (("ex2((sc[i + k] - l) * kLog2e)", "(sc[i + k] - l)"),),
    "diag_no_exchange": (_EXCHANGE,),
}
N, V, D = 32768, 32000, 512
CHECKS = ((1032, 32000, 512), (200, 1000, 256))

_P, _I = ctypes.c_void_p, ctypes.c_int


def inputs(n, v, d, seed, lse=True):
    """x, E (bf16), int32 targets (every other one in the last vocab
    tile), g in [0.5, 1.5] and, with ``lse``, the shipped forward's lse,
    on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen).to(torch.bfloat16).cuda()
    e = (torch.randn((v, d), generator=gen) * 0.02).to(torch.bfloat16).cuda()
    tg = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
    tg[1::2] = v - 1 - torch.arange(n)[1::2] % (v % 64 or 64)
    tg = tg.cuda()
    g = (torch.rand(n, generator=gen) + 0.5).cuda()
    return x, e, tg, g, xe.xent_forward(x, e, tg)[0] if lse else None


def passes(lib, x, e, tg, g, lse):
    """(run the dx pass, run the dE pass, their outputs) of a built
    library, on the tensors given."""
    fdx, fde = lib.kvedge_xent_bwd_dx, lib.kvedge_xent_bwd_de
    for fn in (fdx, fde):
        fn.argtypes = [_I] + [_P] * 6 + [_I] * 3 + [_P]
    (n, d), v = x.shape, e.shape[0]
    dx = torch.empty_like(x)
    de = torch.empty((v, d), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, e, tg, lse, g)]

    def run(fn, out, what):
        def call():
            rc = fn(1, *ptrs, out.data_ptr(), n, v, d,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"{what} launch failed: {rc}"
        return call

    return run(fdx, dx, "dx"), run(fde, de, "dE"), (dx, de)


def check(lib) -> dict:
    """One version's dx and dE against the plain backward at each of
    ``CHECKS``, and two runs against each other."""
    errs, agrees, same = {}, True, True
    for n, v, d in CHECKS:
        x, e, tg, g, lse = inputs(n, v, d, seed=n + v)
        run_dx, run_de, got = passes(lib, x, e, tg, g, lse)
        run_dx()
        run_de()
        first = [t.clone() for t in got]
        run_dx()
        run_de()
        torch.cuda.synchronize()
        want = (xe.xent_backward_dx_reference(x, e, tg, lse, g).float(),
                xe.xent_backward_de_reference(x, e, tg, lse, g))
        for name, a, w, ulps in zip(("dx", "de"), got, want, (2, 1)):
            atol = min(3e-2, ulps * 2.0 ** -7 * float(w.abs().max()))
            errs[f"{name}_{n}_{v}_{d}"] = float((a.float() - w).abs().max())
            agrees = agrees and torch.allclose(a.float(), w, rtol=0.0,
                                               atol=atol)
        same = same and all(torch.equal(a, b) for a, b in zip(first, got))
    return {"agrees": agrees, "bitwise_deterministic": same,
            "max_abs_err": errs}


def library_backward(x, e, tg):
    """The library's backward alone, and the stream to capture it on:
    its forward runs once here, on that stream."""
    xa, ea = (t.detach().requires_grad_(True) for t in (x, e))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        loss = F.cross_entropy(torch.mm(xa, ea.t()).float(), tg.long())
    torch.cuda.current_stream().wait_stream(stream)
    return (lambda: torch.autograd.grad(loss, (xa, ea), retain_graph=True),
            stream)


# ---- the forward (B5) ------------------------------------------------------

_FWD_END = "        tlogit[row] = t;\n      }\n    }\n  }\n"
_FWD_FOLD = "        if (k == L::kLag - 1 && j > 0) fold(held, j - 1);\n"
_FWD_STEP_END = ("      wgmma_wait<0>();\n      fence_regs(cur);\n"
                 "      for (int k = 0; k < L::kLag; ++k) release();\n")
_FWD_COPY = ("      float held[64];\n#pragma unroll\n"
             "      for (int i = 0; i < 64; ++i) held[i] = prev[i];\n")


def fwd_cluster_edits(c: int):
    """The shipped forward with clusters of ``c`` CTAs owning neighbouring
    row blocks: each loads 128 / c rows of every K-chunk of E and
    multicasts them to all, and a stage is refilled once every consumer
    warp of the cluster has released it."""
    return (
        ("// The warpgroup's registers a thread drop to (dec) or rise to (inc) N;\n",
         _CLUSTER_HELPERS + "// The warpgroup's registers a thread drop to "
         "(dec) or rise to (inc) N;\n"),
        ("constexpr int kFwdStages = 6;   // K-chunks of E in flight\n",
         "constexpr int kFwdStages = 6;   // K-chunks of E in flight\n"
         f"constexpr int kFwdCluster = {c};\n"),
        ("mbar_init(empty + 8u * s, L::kConsumerWarps);",
         "mbar_init(empty + 8u * s, L::kConsumerWarps * kFwdCluster);"),
        ("  __syncthreads();  // the barriers are initialized before any use\n",
         "  cluster_sync();\n"),
        ("          tma_load_2d(sb + s * L::kChunkBytes, &map_e, full + 8u * s, 64 * k,\n"
         "                      j * kFwdCols);\n",
         "          constexpr int kSlice = kFwdCols / kFwdCluster;\n"
         "          const int rank = static_cast<int>(cluster_rank());\n"
         "          tma_load_2d_multicast(\n"
         "              sb + s * L::kChunkBytes + rank * kSlice * 128, &map_e,\n"
         "              full + 8u * s, 64 * k, j * kFwdCols + rank * kSlice,\n"
         "              (1u << kFwdCluster) - 1);\n"),
        ("      if (lane == 0) mbar_arrive(empty + 8u * rs);\n",
         "      if (lane == 0)\n"
         "        for (int r = 0; r < kFwdCluster; ++r)\n"
         "          mbar_arrive_cluster(empty + 8u * rs, r);\n"),
        (_FWD_END, _FWD_END + "  __syncwarp();\n  cluster_sync();\n"),
        ("  if (int rc = encode_rows_map<D>(&map_e, e, v, kFwdCols)) return rc;",
         "  if (int rc = encode_rows_map<D>(&map_e, e, v, kFwdCols / kFwdCluster))\n"
         "    return rc;"),
        ("  kernel<<<(n + kFwdRows - 1) / kFwdRows, L::kThreads, L::kSmem, stream>>>(\n"
         "      map_x, map_e, tgt, lse, tlogit, n, v);\n",
         "  const int clusters = (n + kFwdRows * kFwdCluster - 1) /\n"
         "                       (kFwdRows * kFwdCluster);\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(clusters * kFwdCluster);\n"
         "  cfg.blockDim = dim3(L::kThreads);\n"
         "  cfg.dynamicSmemBytes = L::kSmem;\n"
         "  cfg.stream = stream;\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = kFwdCluster;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  if (int rc = static_cast<int>(cudaLaunchKernelEx(\n"
         "          &cfg, kernel, map_x, map_e, tgt, lse, tlogit, n, v)))\n"
         "    return rc;\n"),
    )


# name -> edits of the shipped source, as VARIANTS.
FWD_VARIANTS = {
    "fwd_stages4": (("constexpr int kFwdStages = 6;",
                     "constexpr int kFwdStages = 4;"),),
    "fwd_lag2": (("constexpr int kFwdLag = 1;", "constexpr int kFwdLag = 2;"),),
    "fwd_lag3": (("constexpr int kFwdLag = 1;", "constexpr int kFwdLag = 3;"),),
    # The fold after tile j's products instead of beside them.
    "fwd_fold_after": ((_FWD_FOLD, ""),
                       (_FWD_STEP_END,
                        _FWD_STEP_END + "      if (j > 0) fold(held, j - 1);\n")),
    # The fold on the accumulator itself, not on a copy: ptxas serializes
    # the wgmmas (C7515).
    "fwd_fold_in_place": (
        ("const float (&prev)[64], int j) {", "float (&prev)[64], int j) {"),
        (_FWD_COPY, ""), (_FWD_FOLD, _FWD_FOLD.replace("held", "prev"))),
    "fwd_cluster2": fwd_cluster_edits(2),
    # A record per CTA; the outputs stay right.
    "fwd_diag_timeline": timeline_edits(
        ("  const int n_tiles = (v + kFwdCols - 1) / kFwdCols;\n", ""),
        end_mark=_FWD_END),
}
FWD_DIAGNOSTICS = {
    "fwd_diag_no_scores": (("""#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // a descriptor counts 16 bytes
          wgmma_ss_n128(cur, da + (k * L::kPanelBytes + kk * 32) / 16,
                        db + 2 * kk, k > 0 || kk > 0);
""", ""),),
    "fwd_diag_no_exp": (("sum[k] += ex2(fmaf(sc[4 * c + 2 * h + k], kLog2e, -base));",
                         "sum[k] += fmaf(sc[4 * c + 2 * h + k], kLog2e, -base);"),),
    "fwd_diag_no_fold": ((_FWD_FOLD, ""),),
}
FWD_CHECKS = ((1032, 32000, 512), (200, 1000, 256), (136, 330, 128),
              (8, 640, 64))


def forward_call(lib, x, e, tg):
    """(run the forward of a built library, its outputs (lse, tlogit))."""
    fn = lib.kvedge_xent_fwd
    fn.argtypes = [_I] + [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = ctypes.c_int
    (n, d), v = x.shape, e.shape[0]
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    tl = torch.empty_like(lse)
    ptrs = [t.data_ptr() for t in (x, e, tg, lse, tl)]

    def call(outputs=(lse, tl)):  # the outputs live as long as the call
        rc = fn(1, *ptrs, n, v, d, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"forward launch failed: {rc}"
    return call, (lse, tl)


def check_forward(lib) -> dict:
    """One version's lse and target logit against the plain forward at
    each of ``FWD_CHECKS`` (1e-5 relative, 1e-4 absolute), and two runs
    against each other."""
    errs, agrees, same = {}, True, True
    for n, v, d in FWD_CHECKS:
        x, e, tg, _, _ = inputs(n, v, d, seed=n + v, lse=False)
        call, got = forward_call(lib, x, e, tg)
        call()
        first = [t.clone() for t in got]
        call()
        torch.cuda.synchronize()
        want = xe.xent_forward_reference(x, e, tg)
        for name, a, w in zip(("lse", "tlogit"), got, want):
            errs[f"{name}_{n}_{v}_{d}"] = float((a - w).abs().max())
            agrees = agrees and torch.allclose(a, w, rtol=1e-5, atol=1e-4)
        same = same and all(torch.equal(a, b) for a, b in zip(first, got))
    return {"agrees": agrees, "bitwise_deterministic": same,
            "max_abs_err": errs}


def library_forward(x, e, tg):
    """The library's forward: one bf16 ``torch.mm``, its logits upcast,
    then ``F.cross_entropy`` per row."""
    t = tg.long()
    return lambda: F.cross_entropy(torch.mm(x, e.t()).float(), t,
                                   reduction="none")


def forward_rounds(libs, smi) -> None:
    """Check every forward version, then time them in turns with the
    library's forward, two rounds."""
    x, e, tg, _, _ = inputs(N, V, D, seed=78, lse=False)
    calls = {}
    for name, lib in libs.items():
        try:
            doc = check_forward(lib)
        except AssertionError as exc:  # a launch refused: report it
            print(json.dumps({"forward": name, "launched": False,
                              "error": str(exc)}), flush=True)
            continue
        print(json.dumps({"forward": name, **doc,
                          "diagnostic": name in FWD_DIAGNOSTICS}), flush=True)
        if (doc["agrees"] and doc["bitwise_deterministic"]) or (
                name in FWD_DIAGNOSTICS):
            calls[name] = forward_call(lib, x, e, tg)[0]
    if "fwd_diag_timeline" in calls:
        call = calls.pop("fwd_diag_timeline")
        print(json.dumps({"timeline": {
            "fwd": timeline(libs["fwd_diag_timeline"], call, -(-N // 128))},
            "card": smi}), flush=True)
    lib_fwd = library_forward(x, e, tg)
    for rnd in range(2):
        row = {"round": rnd, "library_fwd_ms": graph_ms(lib_fwd)}
        for name, call in calls.items():
            row[f"{name}_fwd_ms"] = graph_ms(call)
        row["library_fwd_ms_after"] = graph_ms(lib_fwd)
        lib_ms = (row["library_fwd_ms"] + row["library_fwd_ms_after"]) / 2
        row["xent_forward_ratio"] = {
            name: row[f"{name}_fwd_ms"] / lib_ms
            for name in calls if name not in FWD_DIAGNOSTICS}
        print(json.dumps({**row, "card": smi}), flush=True)


# ---- the backward (B6, B7) ---------------------------------------------------

def backward_rounds(libs, smi) -> None:
    """Check every backward version, then time them in turns with the
    library's backward, two rounds."""
    x, e, tg, g, lse = inputs(N, V, D, seed=78)
    calls = {}
    for name, lib in libs.items():
        try:
            doc = check(lib)
        except AssertionError as exc:  # a launch refused: report it
            print(json.dumps({"variant": name, "launched": False,
                              "error": str(exc)}), flush=True)
            continue
        print(json.dumps({"variant": name, **doc,
                          "diagnostic": name in DIAGNOSTICS}), flush=True)
        if (doc["agrees"] and doc["bitwise_deterministic"]) or (
                name in DIAGNOSTICS):
            calls[name] = passes(lib, x, e, tg, g, lse)[:2]
    if "diag_timeline" in calls:
        run_dx, run_de = calls.pop("diag_timeline")
        lib = libs["diag_timeline"]
        print(json.dumps({"timeline": {
            "dx": timeline(lib, run_dx, -(-N // 64)),
            "de": timeline(lib, run_de, -(-V // 64))},
            "card": smi}), flush=True)

    lib_bwd, lib_stream = library_backward(x, e, tg)
    for rnd in range(2):
        row = {"round": rnd,
               "library_bwd_ms": graph_ms(lib_bwd, stream=lib_stream)}
        for name, (run_dx, run_de) in calls.items():
            row[f"{name}_dx_ms"] = graph_ms(run_dx)
            row[f"{name}_de_ms"] = graph_ms(run_de)
        row["library_bwd_ms_after"] = graph_ms(lib_bwd, stream=lib_stream)
        lib_ms = (row["library_bwd_ms"] + row["library_bwd_ms_after"]) / 2
        row["xent_backward_ratio"] = {
            name: (row[f"{name}_dx_ms"] + row[f"{name}_de_ms"]) / lib_ms
            for name in calls if name not in DIAGNOSTICS}
        print(json.dumps({**row, "card": smi}), flush=True)


def main() -> None:
    args = sys.argv[1:]
    which = ({"fwd"} if "--forward" in args else set()) | (
        {"bwd"} if "--backward" in args else set()) or {"fwd", "bwd"}
    others = {pathlib.Path(a).stem: pathlib.Path(a) for a in args
              if not a.startswith("--")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    every = {"shipped": (), **others}
    if "bwd" in which:
        every.update({**VARIANTS, **DIAGNOSTICS})
    if "fwd" in which:
        every.update({**FWD_VARIANTS, **FWD_DIAGNOSTICS})
    with concurrent.futures.ThreadPoolExecutor(len(every)) as ex:
        futures = {n: ex.submit(build, n, e, "xent") for n, e in every.items()}
    libs = {}
    for name, fut in futures.items():
        try:
            libs[name] = fut.result()
        except Exception as exc:  # noqa: BLE001 - report it, time the rest
            print(json.dumps({"variant": name, "built": False,
                              "error": str(exc)[-2000:]}), flush=True)
    shared = ("shipped", *others)
    if "fwd" in which:
        forward_rounds({n: lib for n, lib in libs.items()
                        if n in shared or n in FWD_VARIANTS
                        or n in FWD_DIAGNOSTICS}, smi)
    if "bwd" in which:
        backward_rounds({n: lib for n, lib in libs.items()
                         if n in shared or n in VARIANTS
                         or n in DIAGNOSTICS}, smi)


if __name__ == "__main__":
    main()
