"""One rank a card: the local ranks of a pod, and the world they join.

The reference lays out every chip its process sees as the mesh
(``kvedge_tpu/parallel/mesh.py``, ``jax.devices()``). The port drives
one card a process, so a pod that sees L cards runs L ranks: the booting
process is local rank 0 on ``cuda:0``, and :func:`join_world` starts
local ranks 1 to L-1 beside it, each a fresh interpreter running this
module (``python -m kvedge_torch.parallel.launch``), never a fork of a
process that holds threads and a CUDA context. Global rank
``process_id x L + local_rank`` runs on ``cuda:<local_rank>``, with every
card left visible to every rank so NCCL sees the peer links; a world of
``[distributed] num_processes x L`` ranks joins through
``parallel/distributed.init_world`` (a ``FileStore`` under the state dir
for one pod, the coordinator's ``TCPStore`` across pods).

The cards a pod sees (:func:`visible_cards`): ``torch.cuda.device_count()``
on the card, which honours ``CUDA_VISIBLE_DEVICES``. The CPU has none to
count: there it is the chart's ``KVEDGE_EXPECTED_CARDS`` when set, else
the fewest cards a process over which the mesh resolves
(``runtime/config.fewest_cards``: the mesh's fixed product, an axis of 0
counting as 1, over ``num_processes``).

A local rank joins the world, makes its card the current device before
any CUDA work, and runs the collective side of the payload every rank
runs (the device check, the probes, ``train``, ``eval``; for ``serve``
the follower loop of the leader's op stream, on its main thread). It has
no status server, no heartbeat and no HTTP, and it dies with its parent
(``PR_SET_PDEATHSIG``: the thread that boots the runtime must outlive
it). The parent watches its ranks (:class:`LocalWorld`): one that exits
non-zero during the join fails the join at once, and later degrades the
runtime, the reason naming its local rank, exit code and the tail of
its output (``<state_dir>/local-world/rank<k>.log``).
:class:`Ranks` is the spawn-and-watch code, shared with
``testing/world.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Mapping

import torch

from kvedge_torch.parallel import distributed
from kvedge_torch.runtime.config import (
    RuntimeConfig,
    RuntimeConfigError,
    fewest_cards,
)
from kvedge_torch.runtime.devicecheck import resolve_device

# The chart's cards a pod (gpusPerHost), set in the pod's env.
CARDS_ENV = "KVEDGE_EXPECTED_CARDS"
# The local world's store, configuration and logs, under the state dir.
LOCAL_DIR = "local-world"
# Bytes of a rank's log a failure quotes.
TAIL_BYTES = 2000
# Seconds between two looks at the ranks.
POLL_S = 0.05
_PR_SET_PDEATHSIG = 1
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class LocalRankFailed(RuntimeError):
    """A local rank exited before the world was joined."""


def visible_cards(cfg: RuntimeConfig, device=None,
                  environ: Mapping[str, str] | None = None) -> int:
    """The cards this pod runs a rank on (module doc): the CUDA devices
    visible on the card; on the CPU ``KVEDGE_EXPECTED_CARDS``, else
    ``fewest_cards`` of the mesh. Raises when the card is asked for and
    there is none."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        resolve_device(dev)  # raises when no card is visible
        return torch.cuda.device_count()
    environ = os.environ if environ is None else environ
    raw = environ.get(CARDS_ENV, "")
    if not raw:
        return fewest_cards(cfg.mesh_axes, cfg.num_processes)
    try:
        cards = int(raw)
    except ValueError:
        raise RuntimeConfigError(
            f"{CARDS_ENV}={raw!r} is not an integer") from None
    if cards < 1:
        raise RuntimeConfigError(f"{CARDS_ENV}={raw!r} is not positive")
    return cards


class Ranks:
    """Child processes, each running ``commands[i]`` with its output in
    ``logs[i]``, watched by polling."""

    def __init__(self, commands: list, logs: list, env: dict,
                 cwd: str | None = None):
        self.logs = logs
        self.procs = []
        try:
            for command, log in zip(commands, logs):
                with open(log, "wb") as fh:
                    self.procs.append(subprocess.Popen(
                        command, stdout=fh, stderr=subprocess.STDOUT,
                        stdin=subprocess.DEVNULL, env=env, cwd=cwd))
        except BaseException:
            self.kill()
            raise

    def failed(self) -> tuple[int, int] | None:
        """(index, exit code) of the first child that exited non-zero."""
        for i, p in enumerate(self.procs):
            code = p.poll()
            if code not in (None, 0):
                return i, code
        return None

    def done(self) -> bool:
        """Every child exited 0."""
        return all(p.poll() == 0 for p in self.procs)

    def tail(self, i: int) -> str:
        with open(self.logs[i], "rb") as fh:
            fh.seek(max(0, os.path.getsize(self.logs[i]) - TAIL_BYTES))
            return fh.read().decode(errors="replace")

    def wait(self, timeout_s: float) -> bool:
        """Wait up to ``timeout_s`` for every child to exit; True if all
        did."""
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in self.procs):
            if time.monotonic() > deadline:
                return False
            time.sleep(POLL_S)
        return True

    def kill(self) -> None:
        """Kill every child still running and reap them all."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def child_command(config_path: str, local_rank: int,
                  layout: distributed.WorldLayout, device: torch.device,
                  dtype: str, seed: int) -> list:
    """The command of ``local_rank``: this module's entry point."""
    return [sys.executable, "-m", "kvedge_torch.parallel.launch",
            "--config", config_path, "--local-rank", str(local_rank),
            "--cards", str(layout.cards),
            "--process-id", str(layout.process_id),
            "--coordinator", layout.coordinator, "--device", device.type,
            "--dtype", dtype, "--seed", str(seed),
            "--parent", str(os.getpid())]


class LocalWorld:
    """This pod's local ranks 1 to L-1 and the layout of their world."""

    def __init__(self, layout: distributed.WorldLayout, ranks: Ranks):
        self.layout = layout
        self.ranks = ranks
        self._closed = threading.Event()

    def failure(self) -> str | None:
        """Why a local rank failed, or None: its local rank, exit code
        and the tail of its output."""
        failed = self.ranks.failed()
        if failed is None:
            return None
        i, code = failed
        return (f"local rank {i + 1} (global rank "
                f"{self.layout.rank(i + 1)}) exited with code {code}: "
                f"{self.ranks.tail(i).strip()[-TAIL_BYTES:]}")

    def watch(self, on_failure) -> None:
        """Call ``on_failure(reason)`` every :data:`POLL_S` x 5 seconds
        while a local rank has failed, until :meth:`close`."""
        def loop():
            while not self._closed.wait(POLL_S * 5):
                why = self.failure()
                if why is not None:
                    on_failure(why)

        threading.Thread(target=loop, name="kvedge-local-ranks",
                         daemon=True).start()

    def close(self, grace_s: float = 30.0) -> None:
        """Stop watching, give the ranks ``grace_s`` to finish (a serve
        follower leaves at the leader's STOP), then kill the rest."""
        self._closed.set()
        self.ranks.wait(grace_s)
        self.ranks.kill()


def join_world(cfg: RuntimeConfig, cards: int, device=None,
               dtype: str = "bfloat16", seed: int = 0
               ) -> tuple[distributed.DistributedState, LocalWorld]:
    """Boot's join of the world: ``num_processes`` pods of ``cards`` > 1
    ranks. Local ranks 1 to ``cards - 1`` start (module doc) and this
    process joins as local rank 0 once each has marked itself ready on
    the store, watching them until then: one that exits first raises
    :class:`LocalRankFailed` within :data:`POLL_S`, every rank killed.
    Returns the state ``/status`` reports and the local world."""
    if cards < 2:
        raise ValueError(f"a local world needs 2 cards or more, got {cards}")
    store_dir = os.path.join(cfg.state_dir, LOCAL_DIR)
    layout = distributed.resolve_layout(cfg.distributed, cards,
                                        store_dir=store_dir)
    dev = distributed.local_device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    os.makedirs(store_dir, exist_ok=True)
    stale = os.path.join(store_dir, "store")
    if os.path.exists(stale):
        os.remove(stale)  # a dead boot's rendezvous
    config_path = os.path.join(store_dir, "config.toml")
    with open(config_path, "w", encoding="utf-8") as fh:
        fh.write(cfg.to_toml())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    local = LocalWorld(layout, Ranks(
        [child_command(config_path, k, layout, dev, dtype, seed)
         for k in range(1, cards)],
        [os.path.join(store_dir, f"rank{k}.log") for k in range(1, cards)],
        env))
    backend = "gloo" if dev.type == "cpu" else "nccl"
    try:
        # Each local rank marks itself ready on the store before its own
        # join: this rank joins once all have, and sees a death before.
        store = distributed.make_store(layout.coordinator, layout.world_size,
                                       layout.rank(0))
        ready = [_ready_key(layout.rank(k)) for k in range(1, cards)]
        deadline = time.monotonic() + distributed.JOIN_TIMEOUT_S
        while not store.check(ready):
            why = local.failure()
            if why is not None:
                raise LocalRankFailed(f"{why} (before the world of "
                                      f"{layout.world_size} was joined)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"local ranks not ready after {distributed.JOIN_TIMEOUT_S}"
                    " s")
            time.sleep(POLL_S)
        distributed.init_world(backend, layout.world_size, layout.rank(0),
                               layout.coordinator, dev, store=store,
                               cards=cards)
    except BaseException:
        local.close(grace_s=0.0)
        raise
    return layout.state(), local


def _ready_key(rank: int) -> str:
    return f"kvedge/local-ready/{rank}"


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent dies."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong,
                               ctypes.c_ulong, ctypes.c_ulong]
        libc.prctl.restype = ctypes.c_int
        if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:  # the parent died before the prctl
        os._exit(1)


def run_rank_payload(cfg: RuntimeConfig, device: torch.device,
                     dtype: str, seed: int):
    """The collective side of ``cfg``'s payload on a local rank: the
    payload every rank runs, or for ``serve`` the device check and then
    the follower loop until the leader's STOP. Returns the rank's
    ``DeviceCheckResult``."""
    from types import SimpleNamespace

    from kvedge_torch.runtime import boot
    from kvedge_torch.runtime.devicecheck import run_device_check

    if cfg.payload != "serve":
        return boot._run_payload(cfg, SimpleNamespace(), device, dtype, seed)
    from kvedge_torch.runtime import serve

    check = run_device_check(cfg, device)
    if check.ok:
        serve.follow_slice(cfg, device, dtype, seed)
    return check


def main(argv=None) -> int:
    """A local rank (module doc); exits 0 when its payload succeeded."""
    ap = argparse.ArgumentParser(prog="python -m kvedge_torch.parallel.launch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--local-rank", type=int, required=True)
    ap.add_argument("--cards", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    with open(args.config, encoding="utf-8") as fh:
        cfg = RuntimeConfig.parse(fh.read())
    layout = distributed.WorldLayout(cfg.num_processes, args.process_id,
                                     args.cards, args.coordinator)
    dev = distributed.local_device(args.device, args.local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before any CUDA work of this rank
    rank = layout.rank(args.local_rank)
    current = (f" (current device {torch.cuda.current_device()})"
               if dev.type == "cuda" else "")
    print(f"[kvedge-launch] local rank {args.local_rank}: global rank "
          f"{rank} of {layout.world_size} on {dev}{current}", flush=True)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    store = distributed.make_store(layout.coordinator, layout.world_size,
                                   rank)
    store.set(_ready_key(rank), "1")
    distributed.init_world(backend, layout.world_size, rank,
                           layout.coordinator, dev, store=store,
                           cards=args.cards)
    print(f"[kvedge-launch] local rank {args.local_rank} joined a {backend} "
          f"world of {layout.world_size}", flush=True)
    try:
        check = run_rank_payload(cfg, dev, args.dtype, args.seed)
    finally:
        distributed.shutdown_world()
    print(f"[kvedge-launch] local rank {args.local_rank}: payload "
          f"{cfg.payload!r} ok={check.ok} device_count={check.device_count} "
          f"mesh_shape={list(check.mesh_shape)} "
          f"probe_checksum={check.probe_checksum}", flush=True)
    if not check.ok:
        print(f"[kvedge-launch] {check.error}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
