"""Time the bf16 flash backward (B3 dq, B4 dk/dv) against other versions
of its source, and against SDPA's backward.

    python -m kvedge_torch.tools.flash_bwd_variants [OTHER.cu ...]

Needs one CUDA card and ``nvcc``. Builds the shipped
``csrc/flash_attention.cu``, its variants (a few lines replaced: the
rings' depths) and each ``OTHER.cu`` named on the command line (an
earlier version of the source, say ``git show
HEAD~1:kvedge_torch/ops/csrc/flash_attention.cu``) beside it under
``build/kvedge_torch/``; a version that does not build is reported and
left out. Each version's dq and dk/dv passes are first held to the plain
backward on 8 heads (within 3e-2) and run twice, which must agree bit for
bit; one that fails is reported and not timed.

Then, at the flagship training shape (BH 512, T 512, Dh 64, bf16), every
version's two passes, the port's ``attention_delta`` and SDPA's backward
(``torch.autograd.grad`` through ``F.scaled_dot_product_attention(
is_causal=True)``: dq, dk and dv in one call, its delta included) are
timed in turns by CUDA-graph replay (10 calls captured in one graph, CUDA
events around a replay, per call, the median of 5 replays), two rounds.
Each round prints one JSON line: the times and, per version,
``(delta + dq + dkv) / SDPA``. The card's name and power limit are on the
first line.
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

from kvedge_torch.ops import attention as fa
from kvedge_torch.tools.flash_fwd_variants import (build, graph_ms,
                                                   timeline, timeline_edits)

# Each CTA of B3 and B4 writes a record, as B2's does in
# flash_fwd_variants' diag_timeline; the outputs stay right.
DIAG_TIMELINE = timeline_edits(
    ("  constexpr int SV = kStagesDqV;\n",
     "    store_tile<DH>(&map_dq, sqt, qt, bh);\n  }\n"),
    ("  constexpr int S = kStagesDkv;\n",
     "      bulk_commit();\n    }\n  }\n"))
# name -> ((text in the shipped source, its replacement), ...)
VARIANTS = {
    "shipped": (),
    "dq_k_stages2": (("constexpr int kStagesDqK = 3;",
                      "constexpr int kStagesDqK = 2;"),),
    "dkv_stages3": (("constexpr int kStagesDkv = 2;",
                     "constexpr int kStagesDkv = 3;"),),
    "diag_timeline": DIAG_TIMELINE,
}
BH, T, DH, HEADS = 512, 512, 64, 8
GRAD_TOL = 3e-2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def passes(lib, q, k, v, do, lse, delta):
    """(run the dq pass, run the dk/dv pass, their outputs) of a built
    library, on the tensors given."""
    fdq, fdkv = lib.kvedge_flash_bwd_dq, lib.kvedge_flash_bwd_dkv
    fdq.argtypes = [_I] + [_P] * 7 + [_I] * 3 + [_F, _P]
    fdkv.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_F, _P]
    bh, seq, dh = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
    scale = fa.softmax_scale(dh)

    def run_dq():
        rc = fdq(1, *ptrs, dq.data_ptr(), bh, seq, dh, scale,
                 torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"dq launch failed: {rc}"

    def run_dkv():
        rc = fdkv(1, *ptrs, dk.data_ptr(), dv.data_ptr(), bh, seq, dh, scale,
                  torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"dk/dv launch failed: {rc}"

    return run_dq, run_dkv, (dq, dk, dv)


def check(lib, q, k, v, do) -> dict:
    """One version's dq, dk and dv on the first 8 heads against the plain
    backward, and two runs against each other."""
    q, k, v, do = (x[:HEADS].contiguous() for x in (q, k, v, do))
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(do, out)
    run_dq, run_dkv, got = passes(lib, q, k, v, do, lse, delta)
    run_dq()
    run_dkv()
    first = [x.clone() for x in got]
    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    want = (fa.flash_backward_dq_reference(q, k, v, do, lse, delta),
            *fa.flash_backward_dkv_reference(q, k, v, do, lse, delta))
    errs = {n: float((g.float() - w.float()).abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    agrees = all(torch.allclose(g.float(), w.float(), rtol=GRAD_TOL,
                                atol=GRAD_TOL) for g, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(first, got))
    return {"agrees": agrees, "bitwise_deterministic": same,
            "max_abs_err": errs}


def timelines(lib, run_dq, run_dkv) -> dict:
    """What ``diag_timeline``'s records say of one warm call of each pass
    (``flash_fwd_variants.timeline``)."""
    return {name: timeline(lib, run, len(fa.cta_tiles(T, name)) * BH)
            for name, run in (("dq", run_dq), ("dkv", run_dkv))}


def delta_forms(do, out) -> dict:
    """Other ways plain torch computes ``rowsum(dO * O)`` in fp32, timed
    beside the shipped ``attention_delta`` (on the card, the diagonals of
    64-row block products): both operands cast to fp32 first; only dO
    cast; fp32-output batched products (CUDA only), one a row, or of
    8-row blocks; one ``addcmul`` promoting both, then a sum."""
    n, d = do.shape[0] * do.shape[1], do.shape[2]

    def block_diag(rows):  # the diagonals of [rows, rows] blocks of dO O^T
        return lambda: torch.bmm(
            do.view(n // rows, rows, d),
            out.view(n // rows, rows, d).transpose(1, 2),
            out_dtype=torch.float32).diagonal(dim1=1, dim2=2).reshape(
                do.shape[:2])

    return {
        "two_casts": lambda: (do.float() * out.float()).sum(dim=-1),
        "one_cast": lambda: (do.float() * out).sum(dim=-1),
        "bmm_fp32_out": lambda: torch.bmm(
            do.view(n, 1, d), out.view(n, d, 1),
            out_dtype=torch.float32).view(do.shape[:2]),
        "bmm_block8_diag": block_diag(8),
        "addcmul": lambda: torch.addcmul(
            torch.zeros((1, 1, 1), device=do.device), do, out).sum(dim=-1),
    }


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    every = {**VARIANTS,
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
    q, k, v, do = (torch.randn((BH, T, DH), generator=gen).to(torch.bfloat16)
                   .cuda() for _ in range(4))
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(do, out)
    calls = {}
    for name, lib in libs.items():
        doc = check(lib, q, k, v, do)
        print(json.dumps({"variant": name, **doc}), flush=True)
        if doc["agrees"] and doc["bitwise_deterministic"]:
            calls[name] = passes(lib, q, k, v, do, lse, delta)[:2]
    if "diag_timeline" in calls:
        print(json.dumps({"timeline": timelines(libs["diag_timeline"],
                                                *calls.pop("diag_timeline")),
                          "card": smi}), flush=True)

    # SDPA's backward, captured on the stream its forward ran on.
    shaped = [x.reshape(BH // HEADS, HEADS, T, DH) for x in (q, k, v, do)]
    leaves = [x.detach().requires_grad_(True) for x in shaped[:3]]
    sdpa_stream = torch.cuda.Stream()
    sdpa_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(sdpa_stream):
        s_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    torch.cuda.current_stream().wait_stream(sdpa_stream)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        s_out, leaves, shaped[3], retain_graph=True)
    delta_fn = lambda: fa.attention_delta(do, out)  # noqa: E731
    forms = delta_forms(do, out)
    want = delta_fn()
    print(json.dumps({"delta_forms_max_abs_diff": {
        n: float((f() - want).abs().max()) for n, f in forms.items()}}),
        flush=True)
    for rnd in range(2):
        row = {"round": rnd,
               "sdpa_bwd_ms": graph_ms(sdpa_bwd, stream=sdpa_stream),
               "delta_ms": graph_ms(delta_fn),
               **{f"delta_{n}_ms": graph_ms(f) for n, f in forms.items()}}
        for name, (run_dq, run_dkv) in calls.items():
            row[f"{name}_dq_ms"] = graph_ms(run_dq)
            row[f"{name}_dkv_ms"] = graph_ms(run_dkv)
        row["sdpa_bwd_ms_after"] = graph_ms(sdpa_bwd, stream=sdpa_stream)
        sdpa = (row["sdpa_bwd_ms"] + row["sdpa_bwd_ms_after"]) / 2
        row["backward_ratio"] = {
            name: (row["delta_ms"] + row[f"{name}_dq_ms"]
                   + row[f"{name}_dkv_ms"]) / sdpa for name in calls}
        print(json.dumps({**row, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
