"""Partition rules for the flagship transformer over a data x model x seq
x stage x expert mesh, and the collectives that complete them.

The counterpart of the JAX package's ``parallel/sharding.py``. The rules
(:data:`PARAM_RULES`, :func:`param_specs`, :func:`batch_spec`) are the
reference's, with a spec written as a tuple of axis names (``None`` =
replicated on that dim): Megatron tensor parallelism shards the
column-parallel kernels (``w_qkv``, ``w_up``) on their output features
and the row-parallel ones (``w_out``, ``w_down``) on their input
features over ``model``; the embedding is feature-sharded; norms and the
router are replicated; a ``stage`` axis cuts every layer-stacked param's
leading ``L`` into whole layers, and an ``expert`` axis cuts the expert
weights' ``E`` into whole experts. The batch shards on ``data`` only:
every rank of a ``stage`` or ``expert`` group holds the same rows.

The reference leaves the collectives to XLA's partitioner. The port
writes them, as ``torch.autograd.Function``s on the ``model`` group:

* :func:`copy_to_model` (Megatron's *f*): identity forward, all-reduce
  backward; before each column-parallel product, whose input gradient is
  partial on every model rank.
* :func:`reduce_from_model` (*g*): all-reduce forward, identity
  backward; after each row-parallel product. (The backward of
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the
  gradient too, which would scale every gradient behind it by tp.) The
  sum runs in fp32 and rounds to the compute dtype once.
* :func:`gather_from_model`: the feature-sharded embedding's lookup is
  gathered over ``model``; its backward keeps this rank's slice of the
  (replicated) gradient.

The tied readout is *f*, this rank's feature slice times its embedding
shard, then *g* over the partial logits. The MoE layer's collectives on
the ``expert`` group are ``models/moe.py``'s. Every parameter's
gradient is summed over the ``data`` and ``seq`` groups, never over
``expert``, and over ``stage`` only where some stages lack it
(:func:`reduce_grads`); the loss is the mean over the global tokens
(``models/transformer.loss_fn``).

Serving runs forward only, under ``torch.no_grad``, and adds three
collectives with no autograd (``models/moe.py``, ``models/kvcache.py``,
``models/decode.py``), each the identity where the mesh has no group
for its axis, so :data:`~kvedge_torch.parallel.mesh.NO_MESH` decode
runs none:

* :func:`sum_over_experts`: one choice's contributions summed over the
  ``expert`` group, in place and in the compute dtype. Each row is
  nonzero on exactly one rank, so the sum adds only zeros to it and
  keeps one process's bits.
* :func:`hand_off`: the hidden state broadcast over the ``stage`` group
  from the stage that just ran its layers; the next stage reads it.
* :func:`from_last_stage`: the last stage's logits broadcast over the
  ``stage`` group, so every rank's sampler, window bookkeeping and key
  schedule see the same values.

The two broadcasts are one NCCL (or gloo) ``broadcast`` each, which a
CUDA graph captures as it captures the ``model`` axis's all-reduces.

:func:`shard_params` cuts a rank's slices out of a full numpy or torch
tree and :func:`gather_params` rebuilds the full tree over the
``model``, ``expert`` and ``stage`` groups. The fused
``w_qkv`` columns are ``[q heads | k heads | v heads]``, which a
contiguous cut would not split at head boundaries (XLA reshards when it
slices them); the port cuts each of the three segments by whole heads,
so a rank's slice holds its own q, k and v heads.
"""

from __future__ import annotations

import numpy as np
import torch

# Rules keyed by parameter name (the flagship model's param tree keys).
PARAM_RULES: dict[str, tuple] = {
    "embedding": (None, "model"),        # [V, D] — feature-sharded
    "w_qkv": (None, None, "model"),      # [L, D, (H+2K)*Dh] — column-parallel
    "w_out": (None, "model", None),      # [L, H*Dh, D] — row-parallel
    "w_up": (None, None, "model"),       # [L, D, F] — column-parallel
    "w_down": (None, "model", None),     # [L, F, D] — row-parallel
    "ln_attn": (),                       # [L, D] — replicated
    "ln_mlp": (),                        # [L, D]
    "ln_final": (),                      # [D]
    # Mixture of experts: the expert dim shards over ``expert``; within
    # an expert the FFN is column/row-parallel on ``model``.
    "router": (),                        # [L, D, E] — replicated
    "w_up_experts": (None, "expert", None, "model"),    # [L, E, D, F]
    "w_down_experts": (None, "expert", "model", None),  # [L, E, F, D]
}

# Params whose leading dim is the layer-stack axis (shardable on `stage`).
_LAYER_STACKED = frozenset({
    "w_qkv", "w_out", "w_up", "w_down", "ln_attn", "ln_mlp",
    "router", "w_up_experts", "w_down_experts",
})


def _prune(spec: tuple, mesh) -> tuple:
    """Drop axis names the mesh doesn't have: those dims replicate."""
    if mesh is None:
        return spec
    return tuple(axis if axis in mesh.axis_names else None for axis in spec)


def param_specs(params: dict, mesh=None) -> dict:
    """The spec tree of a flagship param tree (the reference's rules; a
    ``stage`` axis shards the layer-stacked params' leading dim)."""
    missing = set(params) - set(PARAM_RULES)
    if missing:
        raise ValueError(f"no partition rule for params: {sorted(missing)}")
    stage = mesh is not None and "stage" in mesh.axis_names
    specs = {}
    for name in params:
        spec = _prune(PARAM_RULES[name], mesh)
        if stage and name in _LAYER_STACKED:
            spec = ("stage", *spec[1:])
        specs[name] = spec
    return specs


def batch_spec(mesh=None) -> tuple:
    """Tokens [B, T+1]: batch on the data axis, sequence replicated (a
    ``seq`` rank takes its chunk of the inputs inside the loss)."""
    return _prune(("data", None), mesh)


def check_shardable(cfg, tp: int) -> None:
    """Refuse a model the ``model`` axis cannot cut into whole heads,
    K/V heads and feature blocks."""
    for what, n in (("n_heads", cfg.n_heads), ("kv heads", cfg.kv_heads),
                    ("d_model", cfg.d_model), ("d_ff", cfg.d_ff)):
        if n % tp:
            raise ValueError(
                f"{what} {n} must divide by the 'model' axis size {tp}: "
                "the port shards whole heads, K/V heads and features")


def check_stages(cfg, stages: int) -> None:
    """Refuse a layer stack the ``stage`` axis cannot cut into whole
    layers."""
    if cfg.n_layers % stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} must divide by the 'stage' axis "
            f"size {stages}: each stage holds L/S whole layers")


# The axes a param is cut on, in the order a gather rebuilds them.
_CUT_AXES = ("model", "expert", "stage")


def _cut_dims(params: dict, mesh) -> dict:
    """Each param's ``{axis: dim}`` of the cut axes its spec names."""
    return {name: {axis: spec.index(axis) for axis in _CUT_AXES
                   if axis in spec}
            for name, spec in param_specs(params, mesh).items()}


def _segments(name: str, cfg, width: int) -> list[int]:
    """Column segments cut separately: w_qkv's q, k and v heads."""
    if name == "w_qkv":
        dh = cfg.d_head
        return [cfg.n_heads * dh, cfg.kv_heads * dh, cfg.kv_heads * dh]
    return [width]


def _split(x, sizes, dim):
    if isinstance(x, torch.Tensor):
        return list(torch.split(x, sizes, dim))
    return np.split(x, np.cumsum(sizes)[:-1], axis=dim)


def _cat(parts, dim):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim)
    return np.concatenate(parts, axis=dim)


def _cut(name, x, dim, n, r, cfg, axis):
    """Slice ``r`` of ``n`` of ``x`` along ``dim``: by whole heads of
    each w_qkv segment on ``model``, contiguous otherwise (whole layers
    on ``stage``, whole experts on ``expert``)."""
    segs = _segments(name, cfg, x.shape[dim]) if axis == "model" else [
        x.shape[dim]]
    return _cat([_split(seg, [seg.shape[dim] // n] * n, dim)[r]
                 for seg in _split(x, segs, dim)], dim)


def _join(name, parts, dim, n, cfg, axis):
    """Inverse of :func:`_cut` over the ranks' slices in axis order."""
    width = parts[0].shape[dim] * n
    segs = [s // n for s in (_segments(name, cfg, width)
                             if axis == "model" else [width])]
    pieces = [_split(p, segs, dim) for p in parts]
    return _cat([_cat([pieces[r][j] for r in range(n)], dim)
                 for j in range(len(segs))], dim)


def shard_params(mesh, params: dict, cfg) -> dict:
    """This rank's slices of a full param tree (numpy or torch leaves):
    cut on ``model`` (whole heads and feature blocks), ``expert`` (whole
    experts) and ``stage`` (whole layers) where the mesh has them."""
    dims = _cut_dims(params, mesh)
    out = {}
    for name, x in params.items():
        for axis, dim in dims[name].items():
            if mesh.size(axis) > 1:
                x = _cut(name, x, dim, mesh.size(axis), mesh.index(axis),
                         cfg, axis)
        out[name] = x
    return out


def shard_tree(mesh, tree: dict, cfg) -> dict:
    """A params dict, or an AdamW state whose ``mu`` and ``nu`` are
    param trees, cut to this rank (the count is replicated)."""
    if "mu" in tree:
        return {**tree, "mu": shard_params(mesh, tree["mu"], cfg),
                "nu": shard_params(mesh, tree["nu"], cfg)}
    return shard_params(mesh, tree, cfg)


def gather_params(mesh, params: dict, cfg, *, dst: int | None = None
                  ) -> dict:
    """The full tree from every rank's slices over the ``model``,
    ``expert`` and ``stage`` groups, in that order (a collective: every
    rank of the groups calls it). Leaves are detached; replicated ones
    are returned as they are. By default all-gathers give every rank the
    tree. With ``dst`` (the global rank at coordinate 0 of every cut
    axis of this rank's block) each leaf is gathered, one axis after
    another, onto the group's first member, joined on the host and (for
    the next axis) sent back to the device, so no rank holds the full
    tree on its device: a rank whose coordinate on an axis is not 0
    sends its slice and takes no part in the later axes' gathers, and
    every rank but ``dst`` gets None for the cut leaves."""
    import torch.distributed as dist

    dims = _cut_dims(params, mesh)
    out = {}
    for name, x in params.items():
        x = x.detach()
        device = x.device
        for axis, dim in dims[name].items():
            n, group = mesh.size(axis), mesh.group(axis)
            if n == 1 or group is None:
                continue
            if x is None:
                break
            if dst is None:
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = _join(name, parts, dim, n, cfg, axis)
                continue
            x = x.to(device)  # a leaf joined on the host, for the next axis
            first = dist.get_global_rank(group, 0)
            mine = dist.get_rank() == first
            parts = [torch.empty_like(x) for _ in range(n)] if mine else None
            dist.gather(x.contiguous(), parts, dst=first, group=group)
            x = (_join(name, [p.cpu() for p in parts], dim, n, cfg, axis)
                 if mine else None)
        out[name] = x
    return out


def gather_tree(mesh, tree: dict, cfg, *, dst: int | None = None) -> dict:
    """:func:`gather_params` over a params dict or an AdamW state."""
    if "mu" in tree:
        return {**tree, "mu": gather_params(mesh, tree["mu"], cfg, dst=dst),
                "nu": gather_params(mesh, tree["nu"], cfg, dst=dst)}
    return gather_params(mesh, tree, cfg, dst=dst)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (_all_reduce(grad.to(torch.float32, copy=True), ctx.group)
                .to(grad.dtype), None)


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward (fp32 sum, one rounding), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.to(torch.float32, copy=True), group).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, n, r, dim):
        import torch.distributed as dist

        ctx.r, ctx.width, ctx.dim = r, x.shape[dim], dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.r * ctx.width,
                            ctx.width).contiguous(), None, None, None, None)


class _AllReduceSum(torch.autograd.Function):
    """A sum every rank of the groups holds, with the sum's true adjoint
    when each rank's objective holds a share of it: the backward sums the
    ranks' gradients too."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.clone()
        for group in groups:
            _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        for group in ctx.groups:
            _all_reduce(grad, group)
        return grad, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    group = mesh.group("model")
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    group = mesh.group("model")
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    group = mesh.group("model")
    if group is None:
        return x
    return _GatherFromModel.apply(x, group, mesh.size("model"),
                                  mesh.index("model"), -1)


def copy_to_experts(x: torch.Tensor, mesh) -> torch.Tensor:
    """*f* over the ``expert`` group: identity forward, all-reduce
    backward (each expert rank's input gradient holds only its own
    experts' share)."""
    group = mesh.group("expert")
    return x if group is None else _CopyToModel.apply(x, group)


def gather_from_experts(x: torch.Tensor, mesh) -> torch.Tensor:
    """The expert ranks' ``[E/ep, ...]`` outputs all-gathered into
    ``[E, ...]``; backward keeps this rank's experts' slice."""
    group = mesh.group("expert")
    if group is None:
        return x
    return _GatherFromModel.apply(x, group, mesh.size("expert"),
                                  mesh.index("expert"), 0)


def sum_over_experts(x: torch.Tensor, mesh) -> torch.Tensor:
    """The serving block's sum of one choice's contributions over the
    ``expert`` group (module doc); x itself without a group."""
    return _all_reduce(x, mesh.group("expert"))


def hand_off(x: torch.Tensor, mesh, stage: int) -> torch.Tensor:
    """``x`` as stage ``stage`` holds it, on every rank of this rank's
    ``stage`` group (a broadcast from that stage, in place: a receiving
    rank passes a buffer of the same shape and dtype); x itself without
    a group."""
    import torch.distributed as dist

    group = mesh.group("stage")
    if group is None:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, stage), group=group)
    return x


def from_last_stage(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`hand_off` from the last stage: its logits on every rank."""
    return hand_off(x, mesh, mesh.size("stage") - 1)


def token_groups(mesh) -> tuple:
    """The groups a token statistic sums over: ``data`` and ``seq``."""
    return tuple(g for g in (mesh.group("data"), mesh.group("seq"))
                 if g is not None)


def all_reduce_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable sum over the data and seq ranks (module doc)."""
    groups = token_groups(mesh)
    return _AllReduceSum.apply(x, groups) if groups else x


def token_ranks(mesh) -> int:
    """How many ranks split the tokens: data x seq."""
    return mesh.size("data") * mesh.size("seq")


def reduce_grads(grads: list, mesh, stage_summed=()) -> list:
    """Sum every gradient over the ``data`` and ``seq`` groups, as one
    fp32 buffer a group; the gradients flagged in ``stage_summed`` (one
    bool a gradient) are summed over the ``stage`` group as well.

    Three kinds of gradient meet here (module doc): a rank's slice of a
    layer-stacked param is its stage's alone, and an expert's weights
    its expert rank's alone, so neither is summed over ``stage`` or
    ``expert``; the router, norms and attention see the same tokens and
    the same combined outputs on every expert rank, so their gradients
    are equal there and are not summed over ``expert`` either; a
    gradient that only some stages compute (1F1B's loss head on the last
    stage, the embedding's lookup on the first) is summed over
    ``stage``, which GPipe never needs: its head runs on every stage
    alike and its input cotangent reaches every stage
    (``parallel/pipeline.py``)."""
    groups = token_groups(mesh)
    stage = mesh.group("stage") if any(stage_summed) else None
    if not groups and stage is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for group in groups:
        _all_reduce(flat, group)
    if stage is not None:
        mask = torch.cat([torch.full((g.numel(),), bool(f), device=g.device)
                          for g, f in zip(grads, stage_summed)])
        part = torch.where(mask, flat, 0)
        _all_reduce(part, stage)
        flat = torch.where(mask, part, flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    return out


def all_gather_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ``[B_local, T_local, ...]`` blocks of every data and seq rank
    assembled into ``[B, T, ...]`` (not differentiable)."""
    import torch.distributed as dist

    for axis, dim in (("seq", 1), ("data", 0)):
        group = mesh.group(axis)
        if group is None:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim)
    return x


def shard_batch(mesh, batch):
    """This rank's rows of a global ``[B, T+1]`` batch (:func:`batch_spec`:
    rows on the data axis)."""
    if batch_spec(mesh)[0] is None:
        return batch
    rows = batch.shape[0] // mesh.size("data")
    return batch[mesh.index("data") * rows:(mesh.index("data") + 1) * rows]


def abstract_shard_tree(mesh, shapes: dict, cfg) -> dict:
    """The shapes of this rank's slices of a ``{name: shape}`` tree (a
    restore template of what :func:`shard_params` cuts)."""
    dims = _cut_dims(shapes, mesh)
    out = {}
    for name, shape in shapes.items():
        shape = list(shape)
        for axis, dim in dims[name].items():
            shape[dim] //= mesh.size(axis)
        out[name] = tuple(shape)
    return out
