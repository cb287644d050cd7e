"""The mesh, the partition rules and the sequence-parallel attention, on
``torch.distributed``: the counterpart of the JAX package's
``parallel/``.

The port runs one card a process. ``distributed`` joins the world at
boot, ``mesh`` lays its ranks out over the ``data``, ``model`` and
``seq`` axes, ``sharding`` cuts the param tree and writes the
collectives XLA inserts in the reference, and ``ringattention`` and
``ulysses`` attend across the ``seq`` group. The reference's pipelines
(``pipeline_layers``) are not ported yet (ROADMAP Queue A item 7b).
"""

from kvedge_torch.parallel.mesh import build_mesh, local_mesh
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
    "ring_attention",
    "sequence_sharding",
    "shard_batch",
    "shard_params",
    "shard_tree",
    "ulysses_attention",
]
