"""The device mesh over the world of processes: the counterpart of the
JAX package's ``parallel/mesh.py``.

Each rank drives one card, so a mesh's devices are the world's ranks:
every card of every pod (``parallel/launch.py``). :func:`build_mesh`
resolves the ``[mesh]`` axes against the world size with the reference's
``MeshSpec`` rules and lays the ranks out with
``torch.distributed.device_mesh.init_device_mesh`` under the axis names
(each rank made its card, ``cuda:<local rank>``, the current device
before the join, which ``init_device_mesh`` keeps):
each axis gets its process group (``data``, ``model``, ``seq``,
``stage`` and ``expert`` alike), and each rank knows its coordinate on
every axis and, for point-to-point hand-offs along an axis (the
pipeline's stages), the global ranks of its two neighbours
(:meth:`Mesh.neighbours`). Without a process group (one plain process)
every axis is 1 and there is no group: every collective is skipped, so
the model runs the single-device computation through the same code. In
a world of one rank (``init_world`` with one process) the axes are all
1 too, but the groups exist, so the collectives run through the
backend.
:data:`NO_MESH`, a mesh with no axes, is the default of every model
function that takes a mesh.
"""

from __future__ import annotations

import dataclasses

from kvedge_torch.parallel.distributed import world_size
from kvedge_torch.runtime.config import MeshSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, this rank's coordinates, and one process
    group an axis (``None`` without a world)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple | None = None

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on the axis; 0 for an absent axis."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The axis's process group, or None (no world, or no such axis):
        a collective over None is skipped."""
        if self.groups is None or axis not in self.axis_names:
            return None
        return self.groups[self.axis_names.index(axis)]

    @property
    def distributed(self) -> bool:
        return self.groups is not None

    def neighbours(self, axis: str) -> tuple[int | None, int | None]:
        """The global ranks of the previous and the next member along
        ``axis`` (None past either end, and without a group): a stage's
        two neighbours for the pipeline's point-to-point hand-offs."""
        group = self.group(axis)
        if group is None:
            return None, None
        import torch.distributed as dist

        i, n = self.index(axis), self.size(axis)
        return (dist.get_global_rank(group, i - 1) if i > 0 else None,
                dist.get_global_rank(group, i + 1) if i < n - 1 else None)

    def without(self, *axes: str) -> "Mesh":
        """This mesh without ``axes``: code given it treats this rank's
        block of those axes as the whole (the pipeline's MoE layers bind
        capacity on their own microbatch's tokens)."""
        keep = [i for i, name in enumerate(self.axis_names)
                if name not in axes]
        return Mesh(tuple(self.axis_names[i] for i in keep),
                    tuple(self.shape[i] for i in keep),
                    tuple(self.coords[i] for i in keep),
                    None if self.groups is None
                    else tuple(self.groups[i] for i in keep))


# One plain process and no [mesh]: every axis 1, no group.
NO_MESH = Mesh((), (), ())


def build_mesh(spec: MeshSpec) -> Mesh:
    """The mesh of ``spec`` over the joined world (module doc)."""
    import torch.distributed as dist

    names = spec.axis_names()
    shape = spec.resolved_shape(world_size())
    if not dist.is_initialized():
        return Mesh(names, shape, tuple(0 for _ in names))
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return Mesh(names, shape,
                tuple(dm.get_local_rank(name) for name in names),
                tuple(dm.get_group(name) for name in names))


def local_mesh(data: int = 0, model: int = 1) -> Mesh:
    """Convenience: a data x model mesh over the world."""
    return build_mesh(MeshSpec(axes=(("data", data), ("model", model))))
