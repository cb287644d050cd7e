"""Time the RMSNorm forward (B8) against other versions of its source and
against ``F.rms_norm``.

    python -m kvedge_torch.tools.rmsnorm_versions [OTHER.cu ...]

Needs one CUDA card and ``nvcc``. Builds the shipped ``csrc/rmsnorm.cu``,
its variants (string edits of it: streaming stores, a grid not capped at
the SMs' occupancy, loads kept in L1, at most 32 registers a thread,
CTAs of 4 warps) and each
``OTHER.cu`` named on the command line (an earlier version of the source,
say ``git show HEAD~1:kvedge_torch/ops/csrc/rmsnorm.cu``) beside them
under ``build/kvedge_torch/``; a version that does not build is reported
and left out. Each is first held to the plain forward at [32768, 512]
and [33, 512] bf16 (one bf16 ulp) and [2048, 512] and [7, 100] fp32 (1e-6
relative); one that disagrees is reported and not timed.

Then at the flagship's [32768, 512] bf16 and at the swapped fp32 step's
[2048, 512], every version and ``F.rms_norm`` (its weight in x's dtype)
are timed in turns by CUDA-graph replay (10 calls captured in one graph,
CUDA events around a replay, per call, the median of 5 replays), two
rounds, beside ``y.copy_(x)`` (the same bytes read and written with no
arithmetic, the practical floor). Each round prints one JSON line with
the times and each version's ratio to ``F.rms_norm``; the card's name
and power limit are on the first line.
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

from kvedge_torch.ops import rmsnorm as rn
from kvedge_torch.tools.flash_fwd_variants import build, graph_ms

# name -> ((text in the shipped source, its replacement), ...)
VARIANTS = {
    "shipped": (),
    "stream_stores": ((
        "    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&c);",
        "    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&c));"),),
    "uncapped_grid": ((
        "  const int grid = want < sms * per_sm ? want : sms * per_sm;",
        "  const int grid = want;"),),
    "l1_loads": (("ld.global.nc.L1::no_allocate.v4.u32", "ld.global.nc.v4.u32"),),
    # At most 32 registers a thread: 8 CTAs, 64 warps an SM.
    "occupancy8": (("__global__ void __launch_bounds__(32 * kWarps)\n",
                    "__global__ void __launch_bounds__(32 * kWarps, 8)\n"),),
    "warps4": (("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),),
}
CHECKS = (((32768, 512), torch.bfloat16), ((33, 512), torch.bfloat16),
          ((2048, 512), torch.float32), ((7, 100), torch.float32))
TIMED = (((32768, 512), torch.bfloat16), ((2048, 512), torch.float32))

_P, _I = ctypes.c_void_p, ctypes.c_int


def inputs(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype).cuda()
    gain = (torch.randn(shape[-1:], generator=gen) * 0.1 + 1.0).cuda()
    return x, gain


def forward_call(lib, x, gain):
    """(run a built library's forward on x, its output)."""
    fn = lib.kvedge_rmsnorm_fwd
    fn.argtypes = [_I, _P, _P, _P, _I, _I, _P]
    fn.restype = ctypes.c_int
    n, d = x.shape
    y = torch.empty_like(x)
    code = 1 if x.dtype == torch.bfloat16 else 0

    def call():
        rc = fn(code, x.data_ptr(), gain.data_ptr(), y.data_ptr(), n, d,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"launch failed: {rc}"
    return call, y


def check(lib) -> dict:
    errs, agrees = {}, True
    for i, (shape, dtype) in enumerate(CHECKS):
        x, gain = inputs(shape, dtype, seed=700 + i)
        call, y = forward_call(lib, x, gain)
        call()
        torch.cuda.synchronize()
        want = rn.rmsnorm_reference(x, gain)
        errs[f"{shape[0]}x{shape[1]}"] = float((y.float() - want.float())
                                               .abs().max())
        rtol, atol = (2.0 ** -7, 0.0) if dtype == torch.bfloat16 else \
            (1e-6, 1e-7)
        agrees = agrees and torch.allclose(y.float(), want.float(),
                                           rtol=rtol, atol=atol)
    return {"agrees": agrees, "max_abs_err": errs}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    every = {**VARIANTS,
             **{pathlib.Path(a).stem: pathlib.Path(a) for a in sys.argv[1:]}}
    with concurrent.futures.ThreadPoolExecutor(len(every)) as ex:
        futures = {n: ex.submit(build, n, e, "rmsnorm")
                   for n, e in every.items()}
    libs = {}
    for name, fut in futures.items():
        try:
            libs[name] = fut.result()
        except Exception as exc:  # noqa: BLE001 - report it, time the rest
            print(json.dumps({"version": name, "built": False,
                              "error": str(exc)[-2000:]}), flush=True)
    for name, lib in list(libs.items()):
        doc = check(lib)
        print(json.dumps({"version": name, **doc}), flush=True)
        if not doc["agrees"]:
            del libs[name]
    cases = []
    for shape, dtype in TIMED:
        x, gain = inputs(shape, dtype, seed=78)
        w = gain.to(dtype)
        lib_call = (lambda x=x, w=w:  # noqa: E731
                    F.rms_norm(x, (x.shape[1],), w, 1e-6))
        y = torch.empty_like(x)
        copy = (lambda x=x, y=y: y.copy_(x))  # noqa: E731
        cases.append((f"{shape[0]}x{shape[1]}_{str(dtype)[6:]}", lib_call,
                      copy, {n: forward_call(lib, x, gain)[0]
                             for n, lib in libs.items()}))
    for rnd in range(2):
        for label, lib_call, copy, calls in cases:
            row = {"round": rnd, "shape": label,
                   "library_ms": graph_ms(lib_call), "copy_ms": graph_ms(copy)}
            for name, call in calls.items():
                row[f"{name}_ms"] = graph_ms(call)
            row["library_ms_after"] = graph_ms(lib_call)
            lib_ms = (row["library_ms"] + row["library_ms_after"]) / 2
            row["ratio_to_library"] = {n: row[f"{n}_ms"] / lib_ms
                                       for n in calls}
            print(json.dumps({**row, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
