"""The mesh, the partition rules and the sequence-parallel attention, on
``torch.distributed``: the counterpart of the JAX package's
``parallel/``.

Each process drives one card. ``launch`` starts one local rank a card
that a pod sees, ``distributed`` joins them and the other pods' into
one world at boot, ``mesh`` lays its ranks out over the ``data``,
``model``, ``seq``, ``stage`` and ``expert`` axes, ``sharding`` cuts the
param tree and writes the collectives XLA inserts in the reference,
``ringattention`` and ``ulysses`` attend across the ``seq`` group, and
``pipeline`` (GPipe, :func:`pipeline_layers`) and ``pipeline1f1b`` run
the layer stack over the ``stage`` group.
"""

from kvedge_torch.parallel.mesh import build_mesh, local_mesh
from kvedge_torch.parallel.pipeline import pipeline_layers
from kvedge_torch.parallel.ringattention import (
    ring_attention,
    sequence_sharding,
)
from kvedge_torch.parallel.sharding import (
    abstract_shard_tree,
    batch_spec,
    gather_params,
    param_specs,
    shard_batch,
    shard_params,
    shard_tree,
)
from kvedge_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "abstract_shard_tree",
    "batch_spec",
    "build_mesh",
    "gather_params",
    "local_mesh",
    "param_specs",
    "pipeline_layers",
    "ring_attention",
    "sequence_sharding",
    "shard_batch",
    "shard_params",
    "shard_tree",
    "ulysses_attention",
]
