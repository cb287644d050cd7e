"""Join the world of processes at runtime boot: ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``. The
port runs one card a process, so the world size is
``[distributed] num_processes`` and each process's device is its one
card (``cuda:0``, or the CPU when the caller asks for it).

Identity resolution is the reference's, with its order of sources and
its messages:

* process id: explicit config > ``KVEDGE_PROCESS_ID`` env >
  ``TPU_WORKER_ID`` env > trailing ``-<ordinal>`` of the pod hostname
  (StatefulSet convention);
* coordinator: explicit config > ``KVEDGE_COORDINATOR`` env > first host
  of ``TPU_WORKER_HOSTNAMES`` env (comma-separated).

``num_processes == 1`` is a strict no-op: a single-host install never
forms a process group. Above 1, :func:`maybe_initialize` calls
:func:`init_world`: a ``TCPStore`` at the coordinator (hosted by rank
0), then ``init_process_group`` with a finite timeout, so a missing peer
fails the join instead of hanging it; it runs once a process, as the
reference's ``_initialized_as`` guard has it. The backend is NCCL with
``device_id`` set on a CUDA device; gloo only where the CPU was asked
for. A failed NCCL init is an error, never retried on gloo.
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

# The arguments of this process's join, once it succeeded: a process
# joins one world.
_world: tuple | None = None


@dataclasses.dataclass(frozen=True)
class DistributedState:
    """What the runtime joined (or why it didn't need to)."""

    active: bool
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


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


def local_device(device=None) -> torch.device:
    """The process's one card (``cuda:0``), or the CPU when asked for."""
    from kvedge_torch.runtime.devicecheck import resolve_device

    dev = resolve_device(device)
    return dev if dev.type == "cpu" else torch.device("cuda", 0)


def init_world(backend: str, world_size: int, rank: int, coordinator: str,
               device=None) -> None:
    """Form the process group: ``coordinator`` is ``host:port`` (a
    ``TCPStore`` there, hosted by rank 0) or ``file://<path>`` (a
    ``FileStore``, for worlds on one machine). ``backend`` is "nccl"
    (``device`` a CUDA device, bound as ``device_id``) or "gloo". Runs
    once a process: a second call with the same arguments returns, with
    others raises."""
    global _world
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
    timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], world_size)
    else:
        host, _, port = coordinator.rpartition(":")
        store = dist.TCPStore(host, int(port), world_size,
                              is_master=rank == 0, timeout=timeout)
    kw = {}
    if backend == "nccl":
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kw)
    _world = args


def shutdown_world() -> None:
    """Leave the process group this process joined, if any."""
    global _world
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def maybe_initialize(spec: DistributedSpec,
                     environ: Mapping[str, str] | None = None,
                     hostname: str | None = None,
                     device=None) -> DistributedState:
    """Join the world if the config declares one.

    Returns the resulting state; raises ``RuntimeConfigError`` on an
    unresolvable identity and propagates a failed join (the caller
    degrades the runtime rather than crash-looping). Idempotent within a
    process as long as the spec doesn't change (:func:`init_world`'s
    guard). ``device`` is the card unless the CPU is asked for (then the
    backend is gloo).
    """
    spec.validate()
    if spec.num_processes <= 1:
        return DistributedState(active=False)
    environ = os.environ if environ is None else environ
    hostname = socket.gethostname() if hostname is None else hostname

    process_id = resolve_process_id(spec, environ, hostname)
    coordinator = resolve_coordinator(spec, environ)
    dev = local_device(device)
    init_world("gloo" if dev.type == "cpu" else "nccl", spec.num_processes,
               process_id, coordinator, dev)
    return DistributedState(
        active=True,
        num_processes=spec.num_processes,
        process_id=process_id,
        coordinator=coordinator,
    )


def world_size() -> int:
    """The joined world's size; 1 when no process group exists."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0
