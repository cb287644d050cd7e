"""Time the serve phase's burst across checkouts on one card, in turns.

    python -m kvedge_torch.tools.serve_ab TREE [TREE ...] [--bursts N]
        [--overlap auto|off]

Each TREE is a checkout holding ``chip_smoke.py`` and its package (for
the parent commit: ``git archive <commit> | tar -x -C build/parent``).
For each TREE in the order given (pass them as parent, change, change,
parent to cancel drift), a fresh process in that directory boots the
serve runtime of ``chip_smoke.serve_burst`` (flagship, bf16, 4 slots,
page 16, window 64, the warm-ups that capture its graphs), runs the
serve phase's burst of 9 requests, then ``--bursts`` more on the same
runtime, in a fixed admission order where the tree's ``run_burst``
takes one, and prints one JSON line: per burst the decode tokens/s, wall,
``prefill_s``, ``decode_s``, decode steps and the prefix counters,
beside the card's name and power limit. Needs one CUDA card.

Each tree runs the serve payload's default, the prefix cache on, where
its ``serve_burst`` takes that option; a tree without the cache runs as
it is and reports ``"prefix_cache": null``. Every later burst shifts
the token ids of every prompt by a burst's own offset, so no burst
shares a prefix with an earlier one: the cache registers, pins and
evicts, and never hits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import inspect, json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from kvedge_torch.ops import paged_attention as pa
from kvedge_torch.runtime import serve
from kvedge_torch.runtime.config import ServeConfig

bursts, overlap = int(sys.argv[1]), sys.argv[2]
cs.CARD["card"] = cs.nvidia_smi()
kw = ({"prefix_cache": True}
      if "prefix_cache" in inspect.signature(cs.serve_burst).parameters
      else {})
ordered = "queued" in inspect.signature(cs.run_burst).parameters
doc, _, rt = cs.serve_burst(torch, np, pa, serve, ServeConfig, overlap,
                            "cuda", "flagship", 2048, **kw)
PREFIX = ("prefix_hits", "prefix_tokens_saved", "prefix_entries",
          "prefix_evictions")
try:
    url = f"http://127.0.0.1:{rt.port}/generate"
    vocab = rt.tcfg.vocab
    base = cs.serve_requests(np, vocab)
    gen = sum(r["n_new"] * len(r["tokens"]) for r in base)
    stats = rt.server.stats()
    out = [{"tokens_per_s": doc["decode_tokens_per_s"],
            "wall_s": doc["wall_s"], "prefill_s": doc["prefill_s"],
            "decode_s": doc["decode_s"], "decode_steps": doc["decode_steps"],
            **{k: stats[k] for k in PREFIX if k in stats}}]
    for b in range(1, bursts + 1):
        reqs = [{**r, "tokens": [[(t + 7919 * b) % vocab for t in row]
                                 for row in r["tokens"]]} for r in base]
        s0 = rt.server.stats()
        res, _, wall = cs.run_burst(
            url, reqs, **({"queued": lambda: rt.server.requests_queued}
                          if ordered else {}))
        s1 = rt.server.stats()
        cs.check(all(code == 200 for code, _ in res), "a burst request failed")
        out.append({"tokens_per_s": gen / wall, "wall_s": wall,
                    **{k: s1[k] - s0[k] for k in ("prefill_s", "decode_s",
                                                  "decode_steps")},
                    **{k: s1[k] for k in PREFIX if k in s1}})
finally:
    rt.close()
print(json.dumps({"overlap": overlap,
                  "prefix_cache": kw.get("prefix_cache"),
                  "bursts": out, **cs.CARD}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--bursts", type=int, default=5)
    ap.add_argument("--overlap", default="auto", choices=("auto", "off"))
    args = ap.parse_args(argv)
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(args.bursts), args.overlap],
            cwd=tree, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.path.abspath(tree)})
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"overlap"')]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        doc = json.loads(lines[-1])
        print(json.dumps({"tree": tree, **doc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
