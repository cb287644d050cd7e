"""The 1F1B pipeline schedule: forward and backward fused into one
schedule with a stash of at most ``2S`` stage inputs. The counterpart of
the JAX package's ``parallel/pipeline1f1b.py``.

GPipe (``parallel/pipeline.py``) runs every forward before any backward,
so it keeps state for all M microbatches. 1F1B's bound, at most O(S)
microbatches in flight, is a property of the schedule, so this module
builds the training step's forward and backward as one schedule and
returns ``(loss, grads)``. It is the reference's, tick for tick:
``T = M + 2S - 1`` ticks, and at tick ``t`` stage ``s`` runs

* the forward of microbatch ``i_f = t - s`` (while ``0 <= i_f < M``):
  stage 0's embedded input or the activation stage ``s - 1`` sent at
  the tick before, stashed for the backward, then sent on to ``s + 1``;
  on the last stage the loss head runs on the output and its input
  cotangent seeds the backward one tick later;
* the backward of microbatch ``i_b = t - (2S - 1 - s)``: the stage body
  re-run under grad on the stashed input (so flash attention's forward
  kernel runs again, then its backward kernels), driven by the cotangent
  stage ``s + 1`` sent at the tick before (or the head's seed), with the
  parameter gradients accumulated and the input's cotangent sent to
  ``s - 1``.

Microbatches in flight at stage ``s`` number ``2(S - s) - 1``, so the
stash is a ring of ``2S`` slots indexed ``i mod 2S``: collision-free,
since ``i_f - i_b = 2S - 1 - 2s < 2S``. Its depth is a function of S,
never of M (:class:`_Stash` refuses a collision). The O(M) tensors that
remain are the embedded inputs and stage 0's input cotangents, data
every schedule carries.

Where the reference differs because it is one SPMD program: a stage
runs only its real ticks (no masked garbage), and the loss head runs on
the last stage only. So the head's gradients (``ln_final``, the tied
embedding's readout part) exist on the last stage and the embedding's
lookup part on stage 0; both are summed over ``stage``
(``sharding.reduce_grads``'s ``stage_summed``), which makes them the
reference's, whose replicated-input cotangents are summed over its
manual axes. Stage hand-offs are ``dist.batch_isend_irecv`` on the
``stage`` group; a tick's receives wait only on messages its neighbours
sent at the tick before, so the schedule cannot deadlock.

``data`` splits each microbatch's rows (gradients and the loss summed
over it); ``model`` splits each stage body and the head as in the
unpipelined layer. MoE layers, sequence-parallel attention and the
fused cross-entropy head are refused, with the reference's messages:
the GPipe path keeps those.
"""

from __future__ import annotations

import torch

from kvedge_torch.models.transformer import (
    _layer,
    _rmsnorm,
    readout,
    stacked_layer_params,
    take_target_logit,
    torch_dtype,
)
from kvedge_torch.parallel.pipeline import drain, recv, send
from kvedge_torch.parallel.sharding import (
    all_reduce_tokens,
    gather_from_model,
    reduce_grads,
)


def _check_supported(cfg, mesh) -> None:
    if "stage" not in mesh.axis_names:
        raise ValueError(
            "pipeline_schedule='1f1b' needs a mesh with a 'stage' axis"
        )
    if cfg.n_experts:
        raise ValueError(
            "pipeline_schedule='1f1b' does not support MoE layers yet "
            "(the router aux-loss plumbing lives in the GPipe path; "
            "use pipeline_schedule='gpipe')"
        )
    if cfg.attention in ("ring", "ulysses"):
        raise ValueError(
            "pipeline_schedule='1f1b' does not compose with sequence-"
            "parallel attention yet (pp x sp runs on the GPipe path)"
        )
    if cfg.fused_xent:
        raise ValueError(
            "pipeline_schedule='1f1b' computes its loss head inside the "
            "pipeline's manual region, where the Pallas fused-xent "
            "kernel cannot run; disable fused_xent or use "
            "pipeline_schedule='gpipe'"
        )


class _Stash:
    """The ring of ``depth`` stage inputs, indexed by microbatch mod
    depth; a put into a held slot is refused."""

    def __init__(self, depth: int):
        self.slots: list = [None] * depth

    def put(self, i: int, x: torch.Tensor) -> None:
        slot = i % len(self.slots)
        if self.slots[slot] is not None:
            raise RuntimeError(
                f"1F1B stash collision at slot {slot} (microbatch {i})")
        self.slots[slot] = x

    def take(self, i: int) -> torch.Tensor:
        slot = i % len(self.slots)
        x, self.slots[slot] = self.slots[slot], None
        return x


def ticks(stages: int, micro: int, stage: int) -> list:
    """``[(i_f | None, i_b | None)]`` for every tick of ``stage``: the
    microbatch whose forward and whose backward it runs (module doc)."""
    out = []
    for t in range(micro + 2 * stages - 1):
        i_f, i_b = t - stage, t - (2 * stages - 1 - stage)
        out.append((i_f if 0 <= i_f < micro else None,
                    i_b if 0 <= i_b < micro else None))
    return out


def pipeline_1f1b_loss_and_grads(params: dict, batch, cfg, mesh):
    """``(loss, grads)`` of one training batch by the 1F1B schedule.

    ``params`` are this rank's slices (fp32 masters), ``batch`` its data
    rows ``[B/dp, T+1]`` (targets are the shifted inputs, as
    ``transformer.loss_fn``'s); ``loss`` is the global mean token loss on
    every rank and ``grads`` this rank's slices of its gradient, summed
    over the ranks that share them (module doc), as ``jax.grad`` of the
    reference's loss gives them."""
    _check_supported(cfg, mesh)
    stages = mesh.size("stage")
    if cfg.n_layers % stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} must divide by the stage axis "
            f"size {stages}"
        )
    inputs, targets = batch[:, :-1], batch[:, 1:]
    dp = mesh.size("data")
    b, t = inputs.shape[0] * dp, inputs.shape[1]
    micro = cfg.pipeline_microbatches or stages
    if b % micro:
        raise ValueError(f"batch {b} must divide into {micro} microbatches")
    mb = b // micro
    if dp > 1 and mb % dp:
        raise ValueError(
            f"microbatch size {mb} must divide by the 'data' axis size "
            f"{dp}"
        )
    mbl = mb // dp
    dtype = torch_dtype(cfg.dtype)
    stage, group = mesh.index("stage"), mesh.group("stage")
    prev, nxt = mesh.neighbours("stage")
    first, last = stage == 0, stage == stages - 1
    names = ("w_qkv", "w_out", "w_up", "w_down", "ln_attn", "ln_mlp")
    leaves = [p.detach().requires_grad_(True)
              for p in stacked_layer_params(params, cfg)]
    lnf = params["ln_final"].detach().requires_grad_(True)
    emb = params["embedding"].detach().requires_grad_(True)

    def f_stage(ps, x):
        for layer in range(ps[0].shape[0]):
            x, _ = _layer(cfg, x, tuple(p[layer] for p in ps), mesh)
        return x

    x_all = None
    if first:
        x_all = gather_from_model(params["embedding"][inputs], mesh).to(dtype)
        x_mb = x_all.detach().reshape(micro, mbl, t, -1)
    shape = (mbl, t, cfg.d_model)
    like = torch.empty(shape, dtype=dtype, device=batch.device)
    tgt_mb = targets.reshape(micro, mbl, t)

    depth = 2 * stages
    stash = _Stash(depth)
    seeds: list = [None, None]
    d_stacked = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    d_lnf = torch.zeros_like(lnf, dtype=torch.float32)
    d_emb = torch.zeros_like(emb, dtype=torch.float32)
    dx0 = torch.zeros((micro, *shape), dtype=dtype,
                      device=batch.device) if first else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=batch.device)
    pending: list = []
    for i_f, i_b in ticks(stages, micro, stage):
        if i_f is not None:
            x_in = x_mb[i_f] if first else recv(like, prev, group)
            stash.put(i_f, x_in)
            with torch.no_grad():
                h = f_stage(leaves, x_in)
            if last:
                h = h.requires_grad_(True)
                with torch.enable_grad():
                    logits = readout(_rmsnorm(h, lnf), emb, mesh)
                    ce = torch.sum(torch.logsumexp(logits, dim=-1)
                                   - take_target_logit(logits, tgt_mb[i_f]))
                    dh, g_lnf, g_emb = torch.autograd.grad(ce, [h, lnf, emb])
                loss_sum += ce.detach()
                d_lnf += g_lnf
                d_emb += g_emb
                seeds[i_f % 2] = dh
            else:
                send(h, nxt, group, pending)
        if i_b is not None:
            x_leaf = stash.take(i_b).detach().requires_grad_(True)
            cot = seeds[i_b % 2] if last else recv(like, nxt, group)
            with torch.enable_grad():
                h = f_stage(leaves, x_leaf)
                dx, *dps = torch.autograd.grad(h, [x_leaf, *leaves],
                                               cot.to(h.dtype))
            for acc, g in zip(d_stacked, dps):
                acc += g
            if first:
                dx0[i_b] = dx
            else:
                send(dx, prev, group, pending)
    drain(pending)

    if first:
        (d_lookup,) = torch.autograd.grad(
            x_all, params["embedding"], dx0.reshape(x_all.shape))
        d_emb += d_lookup
    scale = 1.0 / (b * t)
    grads = {name: g * scale for name, g in zip(names, d_stacked)}
    grads["ln_final"] = d_lnf * scale
    grads["embedding"] = d_emb * scale
    keys = list(params)
    reduced = reduce_grads([grads[k] for k in keys], mesh,
                           [k in ("ln_final", "embedding") for k in keys])
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(loss_sum, group=group)
    loss = all_reduce_tokens(loss_sum, mesh) * scale
    return loss, dict(zip(keys, reduced))
