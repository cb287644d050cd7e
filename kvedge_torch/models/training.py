"""Training: the AdamW train step and the resumable training loop.

The counterparts of the JAX package's ``make_train_step``
(``models/transformer.py``) and ``run_training`` (``models/training.py``).
Params are fp32 master tensors (``requires_grad``), cast to the compute
dtype at every use by the layer body; the optimizer state is fp32.

The optimizer is ``optax.adamw(3e-4, weight_decay=0.01)`` written out in
the same order of operations (torch's ``AdamW`` decays the params before
its Adam step; optax adds ``wd * p`` to the update — both from the old
params, so they agree only to rounding, and this keeps optax's order):

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps)
    p  = p + (-lr) (u + wd p)

with b1 0.9, b2 0.999, eps 1e-8, eps_root 0, and decay on every leaf (no
mask). The update is applied in place under ``no_grad``.

Every function runs on a mesh (``parallel/mesh.py``; :data:`NO_MESH`,
one plain process, by default): each rank holds its slices of the
params and moments; the train step takes its share of the loss
(``transformer.loss_fn``), sums the gradients over the ``data`` and
``seq`` groups (``parallel/sharding.reduce_grads``) and runs the same
elementwise AdamW on its slices. The reported loss is the global one.
Under a ``stage`` axis (``pipeline_stages > 1``) the step trains
through the config's pipeline schedule: GPipe inside ``loss_fn``, or
1F1B, which builds its own backward (``make_train_step`` routes it, as
the reference's does).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.transformer import global_loss, init_params, loss_fn
from kvedge_torch.models.weights import expected_shapes, params_from_numpy
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.parallel.sharding import reduce_grads, shard_params
from kvedge_torch.runtime.checkpoint import StateCheckpointer
from kvedge_torch.runtime.devicecheck import resolve_device

LEARNING_RATE = 3e-4
WEIGHT_DECAY = 0.01
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


def init_opt_state(params: dict) -> dict:
    """optax's ``ScaleByAdamState``: an int32 count and fp32 moments."""
    device = next(iter(params.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
    }


def opt_state_template(cfg: TransformerConfig) -> dict:
    """Shapes of :func:`init_opt_state`'s tree, for a restore check."""
    shapes = expected_shapes(cfg)
    return {"count": (), "mu": dict(shapes), "nu": dict(shapes)}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict) -> None:
    """One optax-ordered AdamW step, in place (module doc)."""
    count = opt_state["count"] + 1
    opt_state["count"] = count
    countf = count.to(torch.float32)
    bc1 = 1 - torch.tensor(B1, dtype=torch.float32,
                           device=countf.device) ** countf
    bc2 = 1 - torch.tensor(B2, dtype=torch.float32,
                           device=countf.device) ** countf
    for key, p in params.items():
        g = grads[key]
        mu = opt_state["mu"][key]
        nu = opt_state["nu"][key]
        mu.copy_((1 - B1) * g + B1 * mu)
        nu.copy_((1 - B2) * (g * g) + B2 * nu)
        update = (mu / bc1) / (torch.sqrt(nu / bc2 + EPS_ROOT) + EPS)
        p.add_((update + WEIGHT_DECAY * p) * -LEARNING_RATE)


def loss_and_grads(params: dict, batch: torch.Tensor,
                   cfg: TransformerConfig, mesh=NO_MESH):
    """``(loss, grads)``: the global loss and this rank's slices of its
    gradient, summed over the ``data`` and ``seq`` ranks (module doc);
    ``batch`` is this rank's data rows. ``pipeline_stages > 1`` with
    ``pipeline_schedule = "1f1b"`` runs the 1F1B schedule
    (``parallel/pipeline1f1b.py``); GPipe is ``loss_fn``'s own
    pipeline (``parallel/pipeline.py``)."""
    if cfg.pipeline_stages > 1 and cfg.pipeline_schedule == "1f1b":
        # The fused schedule builds the backward itself: autodiff cannot
        # produce a 1F1B schedule from a forward (parallel/pipeline1f1b).
        from kvedge_torch.parallel.pipeline1f1b import (
            pipeline_1f1b_loss_and_grads,
        )

        return pipeline_1f1b_loss_and_grads(params, batch, cfg, mesh)
    keys = list(params)
    share = loss_fn(params, batch, cfg, mesh)
    grads = reduce_grads(
        torch.autograd.grad(share, [params[k] for k in keys]), mesh)
    return global_loss(share.detach(), mesh), dict(zip(keys, grads))


def make_train_step(cfg: TransformerConfig, device=None, mesh=NO_MESH):
    """``(init_opt_state, train_step)``: ``train_step(params, opt_state,
    batch) -> (params, opt_state, loss)`` takes fp32 master params
    (``requires_grad``) and a ``[B, T+1]`` int batch, and updates params
    and optimizer state in place (the reference donates both). Params
    and moments are this rank's slices of the mesh and the batch its
    data rows (module doc); ring and Ulysses attention need a ``seq``
    axis."""
    cfg.validate()
    dev = resolve_device(device)

    def train_step(params: dict, opt_state: dict, batch):
        loss, grads = loss_and_grads(
            params, torch.as_tensor(batch).to(dev, torch.long), cfg, mesh)
        adamw_update(params, grads, opt_state)
        return params, opt_state, loss

    return init_opt_state, train_step


def master_params(tree: dict, cfg: TransformerConfig, device,
                  mesh=NO_MESH) -> dict:
    """A numpy param tree -> this rank's slices of it as fp32 leaf
    tensors on ``device`` that require grad."""
    params = shard_params(
        mesh, params_from_numpy(tree, cfg, device, dtype=torch.float32), cfg)
    return {k: p.requires_grad_(True) for k, p in params.items()}


@dataclasses.dataclass
class TrainResult:
    step: int
    params: dict
    losses: list[float]
    resumed_from: int | None


def run_training(
    cfg: TransformerConfig,
    state_dir: str,
    num_steps: int,
    batches: Iterable,
    checkpoint_every: int = 10,
    seed: int = 0,
    on_step: Callable | None = None,
    checkpoint_dir: str = "",
    device=None,
    mesh=NO_MESH,
) -> TrainResult:
    """Train to ``num_steps`` total, resuming from the latest checkpoint.

    The reference's contract: ``num_steps`` counts from step 0 across all
    runs against this checkpoint directory, so a rerun picks up where
    the last checkpoint left off and returns at once when the target was
    reached. ``on_step(step, loss)`` runs after every step; a checkpoint
    is saved every ``checkpoint_every`` steps and at the last one. Fresh
    params come from the port's numpy ``init_params(seed)``. Each rank
    of the mesh trains its slices (``make_train_step``) and checkpoints
    are the global tree: gathered onto and written by rank 0, read whole
    and cut at a restore (``runtime/checkpoint.py``). The reference's
    ``optimizer`` and ``prepare`` arguments have no counterpart.
    """
    dev = resolve_device(device)
    init_opt, train_step = make_train_step(cfg, dev, mesh)
    step, resumed_from = 0, None
    template = {"params": expected_shapes(cfg),
                "opt_state": opt_state_template(cfg)}
    ckpt = StateCheckpointer(state_dir, checkpoint_dir=checkpoint_dir)
    restored = ckpt.restore_global(template, mesh, cfg, device=dev)
    if restored is not None:
        step, tree = restored
        resumed_from = step
        params = {k: p.requires_grad_(True)
                  for k, p in tree["params"].items()}
        opt_state = tree["opt_state"]
    else:
        params = master_params(init_params(seed, cfg), cfg, dev, mesh)
        opt_state = init_opt(params)

    losses: list[float] = []
    batch_iter = iter(batches)
    while step < num_steps:
        params, opt_state, loss = train_step(params, opt_state,
                                             next(batch_iter))
        step += 1
        losses.append(float(loss))
        if on_step is not None:
            on_step(step, losses[-1])
        if step % checkpoint_every == 0 or step == num_steps:
            ckpt.save_global(step, {"params": params, "opt_state": opt_state},
                             mesh, cfg)
    return TrainResult(step=step, params=params, losses=losses,
                       resumed_from=resumed_from)
