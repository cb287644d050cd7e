"""Where a booted serve payload's resident set goes, stage by stage.

    python -m kvedge_torch.tools.boot_rss [--preset flagship]
        [--device cuda|cpu] [--out PATH]

One process, which the GPU chart's memory request for each local rank
(``kvedge_torch/render/manifests.py``'s ``POD_MEMORY_PER_RANK_GI``) must
cover,
walked through what a pod's entrypoint does, reading its resident set
(``VmRSS`` from ``/proc/self/status``) and its peak (``ru_maxrss``) after
each stage:

1. ``python``: the interpreter and numpy;
2. ``import_torch``;
3. ``cuda_context``: the first tensor on the card;
4. ``cublas``: one bf16 product (cuBLAS and its kernels);
5. ``port_imports``: ``kvedge_torch.runtime.boot`` and ``serve``;
6. ``start_runtime``: the ``serve`` payload booted at the main path's
   settings (``--preset``, bf16 on the card, max_seq 2048, 4 slots, page
   16, prefill chunk 64, window 64): the numpy-seeded weights, the pool,
   the self-check, B1's library and the first graph captures;
7. ``requests``: three greedy requests (prompts of 1025, 300 and 40
   tokens, as chip_smoke's boot phase sends), which capture the graphs
   their shapes need;
8. ``shutdown``: the runtime closed, its prefix registry dumped.

Prints one JSON line a stage and writes them, with the card's name and
power limit, to ``--out``. On the card unless ``--device cpu`` is given
(with ``--preset probe``, to try it on a host with no card).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import tempfile
import time


def _rss() -> dict:
    """This process's resident set now and its peak, in bytes (None
    where ``/proc`` has no ``VmRSS`` line)."""
    now = None
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return {"rss_bytes": now, "maxrss_bytes": peak}


def _card(device: str) -> str:
    if device != "cuda":
        return "cpu"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def _toml(state_dir: str, preset: str, device: str) -> str:
    return (
        "[runtime]\n"
        'name = "boot-rss"\n'
        f"state_dir = {json.dumps(state_dir)}\n"
        "[tpu]\n"
        f'platform = "{"gpu" if device == "cuda" else "cpu"}"\n'
        "[model]\n"
        f'preset = "{preset}"\n'
        "[payload]\n"
        'kind = "serve"\nserving = "paged"\n'
        "seq = 2048\nserving_slots = 4\nserving_page_size = 16\n"
        "serving_prefill_chunk = 64\nserving_window = 64\n"
        "[status]\n"
        'port = 0\nbind = "127.0.0.1"\n')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="flagship")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="build/boot_rss.json")
    args = ap.parse_args(argv)
    lines: list = []
    t0 = time.perf_counter()

    def stage(name, **extra):
        doc = {"stage": name, "t_s": round(time.perf_counter() - t0, 3),
               **_rss(), **extra}
        print(json.dumps(doc), flush=True)
        lines.append(doc)

    import numpy as np

    stage("python")
    import torch

    stage("import_torch", torch=torch.__version__)
    if args.device == "cuda":
        x = torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        stage("cuda_context")
        a = torch.ones(512, 512, device="cuda", dtype=torch.bfloat16)
        (a @ a).sum().item()
        stage("cublas")
        del x, a
    from kvedge_torch.runtime import boot, serve  # noqa: F401
    from kvedge_torch.runtime.config import RuntimeConfig

    stage("port_imports")
    state = tempfile.mkdtemp(prefix="boot-rss-")
    try:
        cfg = RuntimeConfig.parse(_toml(state, args.preset, args.device))
        handle = boot.start_runtime(
            cfg, device=args.device,
            dtype="bfloat16" if args.device == "cuda" else "float32")
        try:
            if not handle.check.ok:
                print(f"boot_rss: boot failed: {handle.check.error}")
                return 1
            stage("start_runtime")
            vocab = cfg.model_config().vocab
            rng = np.random.default_rng(1515)
            for n, m in ((1025, 64), (300, 96), (40, 128)):
                handle.serve_fn({"tokens": [rng.integers(0, vocab, n)
                                            .tolist()], "n_new": m})
            stage("requests")
        finally:
            handle.shutdown()
        stage("shutdown")
    finally:
        shutil.rmtree(state, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": _card(args.device), "stages": lines}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
