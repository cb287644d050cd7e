"""Run a ``kvedge_torch`` function in a gloo world of N CPU ranks.

:func:`run_world` starts N child processes, each running
``python -m kvedge_torch.testing.world <spec> <rank>``: the child sets
``torch.set_num_threads(1)`` (a test machine runs several test workers
at once), joins a gloo world through ``parallel.distributed.init_world``
with a ``FileStore`` in the caller's scratch directory (so two worlds
can never collide on a port), calls the named function with the given
arguments, and pickles its return value. The children import only
``kvedge_torch`` and the named module, never a test module.

A world has a deadline. On a timeout or any rank's failure every child
is killed and :class:`WorldError` carries each rank's exit code and the
tail of its output, so a hung collective fails its test in seconds
instead of hanging the suite. The spawning and watching is
``parallel/launch.Ranks``, the runtime's own.
"""

from __future__ import annotations

import importlib
import os
import pickle
import sys
import time

from kvedge_torch.parallel.launch import Ranks

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class WorldError(RuntimeError):
    """A rank failed, or the world outlived its deadline."""


def run_world(target: str, n: int, *args, tmp_dir: str,
              timeout_s: float = 120.0, **kwargs) -> list:
    """``target`` ("package.module:function") called on every rank of a
    gloo world of ``n`` CPU processes with ``args`` and ``kwargs``;
    returns the ranks' return values in rank order (module doc)."""
    os.makedirs(tmp_dir, exist_ok=True)
    spec = os.path.join(tmp_dir, "world-spec.pkl")
    store = os.path.join(tmp_dir, "world-store")
    for stale in [store] + [os.path.join(tmp_dir, f"rank{r}.out.pkl")
                            for r in range(n)]:
        if os.path.exists(stale):
            os.remove(stale)
    with open(spec, "wb") as fh:
        pickle.dump({"target": target, "n": n, "args": args,
                     "kwargs": kwargs, "store": store}, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ranks = Ranks(
        [[sys.executable, "-m", "kvedge_torch.testing.world", spec, str(rank)]
         for rank in range(n)],
        [os.path.join(tmp_dir, f"rank{rank}.err") for rank in range(n)],
        env, cwd=tmp_dir)
    deadline = time.monotonic() + timeout_s
    failed = ""
    try:
        while not ranks.done():
            if ranks.failed() is not None:
                failed = "a rank failed"
                break
            if time.monotonic() > deadline:
                failed = f"the world outlived its {timeout_s} s deadline"
                break
            time.sleep(0.02)
    finally:
        ranks.kill()
    if failed:
        tails = [f"--- rank {rank} (exit {p.returncode}) ---\n"
                 f"{ranks.tail(rank)}" for rank, p in enumerate(ranks.procs)]
        raise WorldError(f"{target} on {n} ranks: {failed}\n"
                         + "\n".join(tails))
    out = []
    for rank in range(n):
        with open(os.path.join(tmp_dir, f"rank{rank}.out.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _child(spec_path: str, rank: int) -> None:
    import torch

    from kvedge_torch.parallel import distributed

    torch.set_num_threads(1)
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    distributed.init_world("gloo", spec["n"], rank, "file://" + spec["store"],
                           "cpu")
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(*spec["args"], **spec["kwargs"])
    out = os.path.join(os.path.dirname(spec_path), f"rank{rank}.out.pkl")
    with open(out + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(out + ".tmp", out)
    distributed.shutdown_world()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
