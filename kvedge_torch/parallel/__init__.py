"""The mesh, the partition rules and the sequence-parallel attention, on
``torch.distributed``: the counterpart of the JAX package's
``parallel/``.

The port runs one card a process. ``distributed`` joins the world at
boot, ``mesh`` lays its ranks out over the ``data``, ``model``, ``seq``,
``stage`` and ``expert`` axes, ``sharding`` cuts the param tree and
writes the collectives XLA inserts in the reference, ``ringattention``
and ``ulysses`` attend across the ``seq`` group, and ``pipeline``
(GPipe, :func:`pipeline_layers`) and ``pipeline1f1b`` run the layer
stack over the ``stage`` group. Several cards in one process are not
ported yet (ROADMAP Queue A item 7c).
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
