"""Join the world of processes at runtime boot: ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``. The
world holds one rank a card: ``[distributed] num_processes`` pods, each
with the L cards it sees (``parallel/launch.py`` starts local ranks 1 to
L-1 beside the booting process, local rank 0). Global rank
``process_id x L + local_rank`` runs on ``cuda:<local_rank>`` (or the
CPU when the caller asks for it); the world's size is ``num_processes x
L`` (:class:`WorldLayout`).

Identity resolution is the reference's, with its order of sources and
its messages:

* process id: explicit config > ``KVEDGE_PROCESS_ID`` env >
  ``TPU_WORKER_ID`` env > trailing ``-<ordinal>`` of the pod hostname
  (StatefulSet convention);
* coordinator: explicit config > ``KVEDGE_COORDINATOR`` env > first host
  of ``TPU_WORKER_HOSTNAMES`` env (comma-separated).

One pod with one card is a strict no-op: it never forms a process
group. Across pods the rendezvous is a ``TCPStore`` at the coordinator
(hosted by global rank 0); one pod with several cards meets on a
``FileStore`` in a private directory under its state dir, so two pods
never collide on a port. :func:`init_world` then calls
``init_process_group`` with a finite timeout, so a missing peer fails
the join instead of hanging it; it runs once a process, as the
reference's ``_initialized_as`` guard has it. The backend is NCCL with
``device_id`` set on a CUDA device; gloo only where the CPU was asked
for. A failed NCCL init is an error, never retried on gloo.
:func:`maybe_initialize` joins a pod of one card a process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import socket
from typing import Mapping

import torch

from kvedge_torch.runtime.config import DistributedSpec, RuntimeConfigError

_HOST_ORDINAL = re.compile(r"-(\d+)$")

# Seconds a rank waits for its peers at the rendezvous and in a
# collective before the join (or the collective) fails.
JOIN_TIMEOUT_S = 300.0

# The arguments of this process's join and its pod's cards, once it
# succeeded: a process joins one world.
_world: tuple | None = None
_cards = 1


@dataclasses.dataclass(frozen=True)
class DistributedState:
    """What the runtime joined (or why it didn't need to)."""

    active: bool
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class WorldLayout:
    """Where a pod's ranks sit in the world: ``cards`` local ranks (one a
    card) in each of ``num_processes`` pods, meeting at ``coordinator``
    (``host:port`` or ``file://<path>``; "" for a world of one)."""

    num_processes: int
    process_id: int
    cards: int
    coordinator: str

    @property
    def world_size(self) -> int:
        return self.num_processes * self.cards

    def rank(self, local_rank: int) -> int:
        """The global rank of this pod's ``local_rank``."""
        if not 0 <= local_rank < self.cards:
            raise ValueError(f"local rank {local_rank} out of range for "
                             f"{self.cards} cards")
        return self.process_id * self.cards + local_rank

    def state(self) -> DistributedState:
        """``/status``'s ``distributed``: the reference's four keys."""
        if self.world_size == 1:
            return DistributedState(active=False)
        return DistributedState(active=True,
                                num_processes=self.num_processes,
                                process_id=self.process_id,
                                coordinator=self.coordinator)


def resolve_layout(spec: DistributedSpec, cards: int,
                   environ: Mapping[str, str] | None = None,
                   hostname: str | None = None,
                   store_dir: str = "") -> WorldLayout:
    """This pod's :class:`WorldLayout` for ``cards`` cards a pod: with one
    pod, process 0 and a ``FileStore`` under ``store_dir`` (none for one
    card); across pods, the identity and the coordinator the reference
    resolves."""
    spec.validate()
    if cards < 1:
        raise RuntimeConfigError(f"a pod needs a card, got {cards}")
    if spec.num_processes == 1:
        store = os.path.join(store_dir, "store") if cards > 1 else ""
        return WorldLayout(1, 0, cards, f"file://{store}" if store else "")
    environ = os.environ if environ is None else environ
    hostname = socket.gethostname() if hostname is None else hostname
    return WorldLayout(spec.num_processes,
                       resolve_process_id(spec, environ, hostname), cards,
                       resolve_coordinator(spec, environ))


def resolve_process_id(spec: DistributedSpec,
                       environ: Mapping[str, str],
                       hostname: str) -> int:
    """This pod's process index, from config > env > hostname ordinal."""
    if spec.process_id >= 0:
        return spec.process_id
    for var in ("KVEDGE_PROCESS_ID", "TPU_WORKER_ID"):
        if var in environ:
            try:
                pid = int(environ[var])
            except ValueError:
                raise RuntimeConfigError(
                    f"env {var}={environ[var]!r} is not an integer"
                ) from None
            break
    else:
        m = _HOST_ORDINAL.search(hostname)
        if not m:
            raise RuntimeConfigError(
                "cannot infer process_id: set [distributed] process_id, "
                "KVEDGE_PROCESS_ID / TPU_WORKER_ID env, or run with an "
                f"ordinal hostname (got {hostname!r})"
            )
        pid = int(m.group(1))
    if not (0 <= pid < spec.num_processes):
        raise RuntimeConfigError(
            f"resolved process_id {pid} out of range for "
            f"num_processes={spec.num_processes}"
        )
    return pid


def resolve_coordinator(spec: DistributedSpec,
                        environ: Mapping[str, str]) -> str:
    """The process-0 coordination endpoint, as ``host:port``."""
    addr = spec.coordinator_address or environ.get("KVEDGE_COORDINATOR", "")
    if not addr:
        hostnames = environ.get("TPU_WORKER_HOSTNAMES", "")
        addr = hostnames.split(",")[0].strip() if hostnames else ""
    if not addr:
        raise RuntimeConfigError(
            "cannot infer coordinator: set [distributed] "
            "coordinator_address, KVEDGE_COORDINATOR, or "
            "TPU_WORKER_HOSTNAMES env"
        )
    if ":" not in addr:
        addr = f"{addr}:{spec.coordinator_port}"
    return addr


def local_device(device=None, local_rank: int = 0) -> torch.device:
    """The card of ``local_rank`` (``cuda:<local_rank>``), or the CPU when
    asked for."""
    from kvedge_torch.runtime.devicecheck import resolve_device

    dev = resolve_device(device)
    return dev if dev.type == "cpu" else torch.device("cuda", local_rank)


def make_store(coordinator: str, world_size: int, rank: int):
    """The rendezvous store of ``coordinator``: a ``FileStore`` for
    ``file://<path>``, else a ``TCPStore`` at ``host:port`` hosted by
    rank 0, which does not wait for the others to connect (the join's
    own barrier does, bounded by :data:`JOIN_TIMEOUT_S`)."""
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world_size)
    host, _, port = coordinator.rpartition(":")
    return dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
                         wait_for_workers=False)


def init_world(backend: str, world_size: int, rank: int, coordinator: str,
               device=None, *, store=None, cards: int = 1) -> None:
    """Form the process group: ``coordinator`` is ``host:port`` or
    ``file://<path>`` (:func:`make_store`; ``store`` is one made
    already). ``backend`` is "nccl" (``device`` a CUDA device, made this
    thread's current device and bound as ``device_id``) or "gloo";
    ``cards`` is the local ranks of each pod. Runs once a process: a
    second call with the same arguments returns, with others raises."""
    global _world, _cards
    import torch.distributed as dist

    args = (backend, world_size, rank, coordinator, str(device))
    if _world is not None:
        if _world != args:
            raise RuntimeConfigError(
                f"torch.distributed already initialized as {_world}, "
                f"cannot re-initialize as {args}")
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    kw = {}
    if backend == "nccl":
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    if store is None:
        store = make_store(coordinator, world_size, rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
                            **kw)
    _world, _cards = args, cards


def shutdown_world() -> None:
    """Leave the process group this process joined, if any."""
    global _world, _cards
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None
    _cards = 1


def maybe_initialize(spec: DistributedSpec,
                     environ: Mapping[str, str] | None = None,
                     hostname: str | None = None,
                     device=None) -> DistributedState:
    """Join the world of ``spec``'s pods, one card each, if it has more
    than one.

    Returns the resulting state; raises ``RuntimeConfigError`` on an
    unresolvable identity and propagates a failed join (the caller
    degrades the runtime rather than crash-looping). Idempotent within a
    process as long as the spec doesn't change (:func:`init_world`'s
    guard). ``device`` is the card unless the CPU is asked for (then the
    backend is gloo). A pod of several cards joins through
    ``parallel/launch.py``.
    """
    spec.validate()
    if spec.num_processes <= 1:
        return DistributedState(active=False)
    layout = resolve_layout(spec, 1, environ, hostname)
    dev = local_device(device)
    init_world("gloo" if dev.type == "cpu" else "nccl", layout.world_size,
               layout.rank(0), layout.coordinator, dev)
    return layout.state()


def world_size() -> int:
    """The joined world's size; 1 when no process group exists."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_cards() -> int:
    """The cards (local ranks) of each pod of the joined world; 1 when no
    process group exists."""
    return _cards
