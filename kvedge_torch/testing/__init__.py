"""Test harnesses of the port: the fake-cluster layer (``fakecluster``,
``faults``: a deterministic in-process simulation of the Kubernetes
controllers the GPU chart depends on, able to run the real
``kvedge_torch`` entrypoint against per-PVC backing directories) and
seeded fault injection at the serving path's device seams and a slice's
broadcasts (``servingfaults``), and the gloo worlds of CPU ranks the
parallel and slice cases run in (``world``, ``parallelcases``,
``slicecases``)."""

from kvedge_torch.testing.fakecluster import FakeCluster, FakeNode
from kvedge_torch.testing.faults import (
    FaultSchedule,
    FaultScheduleResult,
    InvariantViolation,
)
from kvedge_torch.testing.servingfaults import (
    FaultPlan,
    FaultyCache,
    FaultySliceTransport,
    InjectedFault,
    ServingFaultResult,
    ServingFaultSchedule,
    prefix_file_intact,
)

__all__ = [
    "FakeCluster",
    "FakeNode",
    "FaultPlan",
    "FaultSchedule",
    "FaultScheduleResult",
    "FaultyCache",
    "FaultySliceTransport",
    "InjectedFault",
    "InvariantViolation",
    "ServingFaultResult",
    "ServingFaultSchedule",
    "prefix_file_intact",
]
