"""Pipeline parallelism: the layer stack sharded over a ``stage`` mesh axis,
run by the GPipe schedule. The counterpart of the JAX package's
``parallel/pipeline.py``.

The layer-stacked params' leading ``L`` is cut over ``stage``
(``parallel/sharding.py``): each rank holds ``L/S`` whole layers of its
stage. The batch splits into ``M`` microbatches, and stage ``s`` runs
microbatch ``i`` after stage ``s - 1`` has handed it over, by
point-to-point (``dist.batch_isend_irecv`` on the ``stage`` group: NCCL
on the card, gloo on the CPU).

Where the reference differs because it is one SPMD program:

* **Bubbles are skipped.** The reference runs ``M + S - 1`` steps on
  every stage and computes on garbage outside its own ``M``; here a
  stage runs only its ``M`` real microbatches, in order, each waiting
  for its input. The MoE load-balancing loss is the reference's masked
  mean: over the real microbatch x layer evaluations of every stage,
  summed over ``stage`` and divided by ``M * S`` (the layers' mean a
  stage), the mean over ``data`` and ``seq`` coming from
  ``models/transformer.loss_fn``'s per-rank share.
* **The backward is an explicit schedule.** P2P has no autograd, so
  :class:`_GPipe` is one ``torch.autograd.Function``. Its forward keeps,
  for every microbatch, the stage input as a leaf that requires grad and
  the graph of the stage body on it (each layer under
  ``torch.utils.checkpoint`` when ``remat``, as the reference's
  ``jax.checkpoint``: the graph then holds only layer inputs, flat in
  depth and linear in M as GPipe's). Its backward runs the microbatches
  in reverse order on every stage: the last stage seeds each from the
  head's cotangent, the others receive it from stage ``s + 1``; each
  calls ``torch.autograd.grad`` on that microbatch's graph and sends the
  input's cotangent to stage ``s - 1``. Sends and receives along the
  stage axis thus come in one fixed order on every rank (forward:
  microbatches ascending, each received before it is sent on; backward:
  descending), and every other collective of a stage body runs in that
  same order on the ranks of its group, which all sit at one stage.
* **The last stage's outputs reach every stage** by a broadcast over
  ``stage`` (the reference's ``psum`` of outputs that are zero off the
  last stage), so every stage computes the same loss head. The head's
  cotangent is the same on every stage and is used once, by the last
  stage (the transpose of that ``psum``). Stage 0's input cotangents are
  broadcast back over ``stage``, so the embedding's lookup gradient is
  the same on every stage as well and no gradient is summed over
  ``stage`` (``sharding.reduce_grads``).
* **The reference's microbatches under a data axis.** The reference
  splits the global batch ``[B]`` into ``[M, B/M]`` and shards each
  microbatch's rows over ``data``; a port rank holds ``B/dp`` contiguous
  rows. With ``data`` and ``M`` above 1 the pipeline exchanges rows over
  ``data`` (an all-gather each way, :class:`_Exchange`) so that a rank's
  microbatch ``i`` holds the reference's rows: MoE capacity and the
  balance statistics bind on the same tokens as there.

A layer body under the pipeline sees this rank's microbatch block; a
``seq`` axis (pp x sp) keeps its group, and the layer calls the ring's
or Ulysses' per-rank body with rotary positions offset by the seq index
(``models/transformer._layer``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _p2p(op, tensor: torch.Tensor, peer: int, group):
    import torch.distributed as dist

    return dist.batch_isend_irecv([dist.P2POp(op, tensor, peer, group)])


def send(tensor: torch.Tensor, peer: int, group, pending: list) -> None:
    """Start sending ``tensor`` to global rank ``peer``; the tensor and
    its works are kept in ``pending`` until :func:`drain`."""
    import torch.distributed as dist

    tensor = tensor.detach().contiguous()
    pending.append((tensor, _p2p(dist.isend, tensor, peer, group)))


def recv(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    """A tensor shaped as ``like`` received from global rank ``peer``."""
    import torch.distributed as dist

    buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    for work in _p2p(dist.irecv, buf, peer, group):
        work.wait()
    return buf


def drain(pending: list) -> None:
    for _, works in pending:
        for work in works:
            work.wait()
    pending.clear()


def _broadcast(x: torch.Tensor, src_index: int, group) -> torch.Tensor:
    import torch.distributed as dist

    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, src_index),
                       group=group)
    return x


class _Exchange(torch.autograd.Function):
    """Rows ``[Bl, ...]`` moved between data ranks: the data group's
    blocks are all-gathered and this rank keeps the rows ``take`` names;
    the backward is the inverse exchange (``back``)."""

    @staticmethod
    def forward(ctx, x, group, n, take, back):
        ctx.args = (group, n, back)
        return _gather_rows(x, group, n, take)

    @staticmethod
    def backward(ctx, grad):
        group, n, back = ctx.args
        return _gather_rows(grad, group, n, back), None, None, None, None


def _gather_rows(x, group, n, rows):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)[rows.to(x.device)]


def _microbatch_rows(dp: int, d: int, micro: int, mbl: int):
    """(rows of the all-gathered contiguous layout that data rank ``d``
    holds in the reference's microbatch layout, and the inverse)."""
    i = torch.arange(micro)[:, None]
    j = torch.arange(mbl)[None, :]
    to_ref = (i * dp * mbl + d * mbl + j).reshape(-1)
    g = d * micro * mbl + torch.arange(micro * mbl)   # this rank's rows
    mb = dp * mbl
    to_port = (g % mb) // mbl * (micro * mbl) + g // mb * mbl + g % mbl
    return to_ref, to_port


class _GPipe(torch.autograd.Function):
    """The GPipe schedule with its explicit backward (module doc)."""

    @staticmethod
    def forward(ctx, sched, x_mb, *stacked):
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in stacked]
        out, aux, records = sched.forward(x_mb, params, keep=True)
        ctx.sched, ctx.records, ctx.params = sched, records, params
        return out, aux

    @staticmethod
    def backward(ctx, grad_out, grad_aux):
        dx, dparams = ctx.sched.backward(ctx.records, ctx.params, grad_out,
                                         grad_aux)
        ctx.records = ctx.params = None
        return (None, dx, *dparams)


class _Schedule:
    """One GPipe step's plan on this rank: the stage body, the stage
    group and its neighbours, the microbatch count."""

    def __init__(self, layer_fn, mesh, stage_axis, micro, remat,
                 remat_policy):
        self.layer_fn, self.micro = layer_fn, micro
        self.remat, self.remat_policy = remat, remat_policy
        self.stages = mesh.size(stage_axis)
        self.stage = mesh.index(stage_axis)
        self.group = mesh.group(stage_axis)
        self.prev, self.next = mesh.neighbours(stage_axis)

    def body(self, h, params):
        """This stage's layers on one microbatch: (out, mean aux)."""
        extra = ({"context_fn": self.remat_policy}
                 if self.remat_policy is not None else {})
        auxes = []
        for layer in range(params[0].shape[0]):
            lp = tuple(p[layer] for p in params)
            if self.remat and torch.is_grad_enabled():
                h, aux = checkpoint(self.layer_fn, h, lp, use_reentrant=False,
                                    **extra)
            else:
                h, aux = self.layer_fn(h, lp)
            auxes.append(aux)
        return h, torch.stack(auxes).mean()

    def forward(self, x_mb, params, keep: bool):
        """(outputs ``[M * mb, T, D]`` on every stage, aux, records):
        records keep each microbatch's input leaf, output and aux with
        their graphs when ``keep``."""
        first, last = self.stage == 0, self.stage == self.stages - 1
        pending, outputs, records = [], [], []
        aux_sum = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        for i in range(self.micro):
            h = x_mb[i].detach() if first else recv(x_mb[0], self.prev,
                                                    self.group)
            with torch.set_grad_enabled(keep):
                h = h.requires_grad_(keep)
                out, aux = self.body(h, params)
            if last:
                outputs.append(out.detach())
            else:
                send(out, self.next, self.group, pending)
            if keep:
                records.append((h, out, aux))
            aux_sum = aux_sum + aux.detach().float()
        drain(pending)
        full = (torch.cat(outputs) if last else torch.empty(
            (self.micro * x_mb.shape[1], *x_mb.shape[2:]), dtype=x_mb.dtype,
            device=x_mb.device))
        _broadcast(full, self.stages - 1, self.group)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(aux_sum, group=self.group)
        return full, aux_sum / (self.micro * self.stages), records

    def backward(self, records, params, grad_out, grad_aux):
        """(the input's cotangent on every stage, the stage params'
        gradients): microbatches in reverse order (module doc)."""
        first, last = self.stage == 0, self.stage == self.stages - 1
        pending = []
        g_mb = grad_out.reshape(self.micro, -1, *grad_out.shape[1:])
        dx = torch.zeros_like(g_mb)
        wanted = [p for p in params if p.requires_grad]
        dparams = [torch.zeros_like(p, dtype=torch.float32) for p in wanted]
        aux_scale = (None if grad_aux is None
                     else grad_aux / (self.micro * self.stages))
        for i in reversed(range(self.micro)):
            h, out, aux = records[i]
            g = g_mb[i] if last else recv(out, self.next, self.group)
            outs, cots = [out], [g.to(out.dtype)]
            if aux_scale is not None and aux.requires_grad:
                outs.append(aux)
                cots.append(aux_scale.to(aux.dtype))
            grads = torch.autograd.grad(outs, [h, *wanted], cots,
                                        allow_unused=True)
            for acc, grad in zip(dparams, grads[1:]):
                if grad is not None:
                    acc.add_(grad)
            if first:
                dx[i] = grads[0]
            else:
                send(grads[0], self.prev, self.group, pending)
            records[i] = None
        drain(pending)
        _broadcast(dx, 0, self.group)
        it = iter(dparams)
        return (dx, [next(it).to(p.dtype) if p.requires_grad else None
                     for p in params])


def pipeline_layers(x, stacked, layer_fn, mesh, *, n_layers: int,
                    stage_axis: str = "stage", data_axis: str = "data",
                    seq_axis: str | None = None,
                    n_microbatches: int = 0, remat: bool = True,
                    remat_policy=None):
    """Run ``n_layers`` stacked layers over ``x``, pipelined over stages.

    x: this rank's ``[B/dp, T/sp, D]`` block (compute dtype);
    ``stacked``: this rank's slices of the layer-stacked params, each
    ``[L/S, ...]``; ``layer_fn(carry, layer_params) -> (carry, aux)`` the
    one-layer body, ``aux`` its fp32 load-balancing loss (0.0 for a
    dense layer). ``remat_policy`` is a ``context_fn`` for
    ``torch.utils.checkpoint`` (None saves nothing of a layer). Returns
    ``(out [B/dp, T/sp, D], aux fp32)`` on every stage, differentiable
    (module doc); the reference's checks and messages, on the global
    batch.
    """
    if stage_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {stage_axis!r} axis (axes: "
            f"{sorted(mesh.axis_names)}) — pipeline parallelism needs a "
            "stage axis"
        )
    stages = mesh.size(stage_axis)
    if n_layers % stages:
        raise ValueError(
            f"n_layers {n_layers} must divide by the {stage_axis!r} axis "
            f"size {stages} (whole layers per stage)"
        )
    dp = mesh.size(data_axis)
    batch = x.shape[0] * dp
    micro = n_microbatches or stages
    if batch % micro:
        raise ValueError(
            f"batch {batch} must divide into {micro} microbatches"
        )
    if data_axis in mesh.axis_names and (batch // micro) % dp:
        raise ValueError(
            f"microbatch size {batch // micro} (batch {batch} / {micro} "
            f"microbatches) must divide by the {data_axis!r} axis size "
            f"{dp}"
        )
    if seq_axis is not None and seq_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {seq_axis!r} axis (axes: "
            f"{sorted(mesh.axis_names)}) — pp x sp needs one"
        )
    mbl = batch // micro // dp
    group = mesh.group(data_axis)
    exchange = dp > 1 and micro > 1 and group is not None
    if exchange:
        take, back = _microbatch_rows(dp, mesh.index(data_axis), micro, mbl)
        x = _Exchange.apply(x, group, dp, take, back)
    sched = _Schedule(layer_fn, mesh, stage_axis, micro, remat, remat_policy)
    x_mb = x.reshape(micro, mbl, *x.shape[1:])
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in stacked)):
        out, aux = _GPipe.apply(sched, x_mb, *stacked)
    else:
        out, aux, _ = sched.forward(x_mb, list(stacked), keep=False)
    if exchange:
        out = _Exchange.apply(out, group, dp, back, take)
    return out, aux
