"""The flagship decoder in PyTorch: the counterpart of the JAX package's
``models/transformer.py``, for inference and for training.

Params are a flat dict of layer-stacked tensors with the reference's
keys and shapes (``[L, ...]`` for per-layer weights). Serving holds
them in the compute dtype (the bridge, ``models/weights.py``, casts each
fp32 master weight once at load); training holds fp32 masters. The
layer body casts every weight to the compute dtype at its use, as the
reference does: a no-op for pre-cast weights, the autograd cast for
masters. Every function keeps the reference's rounding points, because
the tests hold the port to the JAX package token for token at fp32:

* ``_rmsnorm``: mean of squares in fp32, ``rsqrt(+1e-6)``, the SCALE
  cast to the dtype, then ``x * scale`` and ``* gain`` in the dtype.
* ``_rotary``: frequencies, angles, ``cos`` and ``sin`` in fp32, cast
  to the dtype, products in the dtype.
* naive attention scores: a dtype matmul (fp32 accumulation, one
  rounding), then the divide by ``sqrt(d_head)`` in the dtype, the
  causal mask at ``finfo(dtype).min``, the softmax on the fp32 upcast
  and the weights rounded back to the dtype. Flash attention
  (``ops/attention.py``) has its own chain: fp32 scores multiplied by
  ``Dh^-0.5``, never rounded to the dtype.
* GELU is the tanh approximation (``jax.nn.gelu``'s default).
* ``tied_readout``: the embedding rounded to x's dtype, both operands
  upcast to fp32 and one fp32 matmul — products of bf16 values are
  exact in fp32, so this is the reference's bf16-operand,
  fp32-accumulate dot.

``forward`` is the no-grad naive oracle the serving paths are held to;
``forward_hidden`` and ``loss_fn`` are the training path, with per-layer
remat (``torch.utils.checkpoint``) when ``cfg.remat``: under
``remat_policy="dots"`` a selective-checkpoint policy saves the outputs
of the layer's non-batched products (``aten.mm`` / ``aten.addmm``, what
``x @ w`` lowers to) and recomputes the rest (batched products, the
flash autograd function, elementwise ops), the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. With
``cfg.n_experts`` each layer's FFN is the capacity-routed MoE of
``models/moe.py``; the layers' mean load-balancing loss is added to the
training loss at ``cfg.moe_aux_weight``, and the serving blocks
(:func:`block_mlp`) route droplessly. With
``cfg.fused_xent`` the loss head is the fused cross-entropy kernels
(``ops/xent.py``) over the hidden rows, outside the checkpointed layers;
otherwise it is ``tied_readout`` and a logsumexp over the fp32 logits.
Both heads take the target logit with ``jnp.take_along_axis``'s index
semantics: ids in ``[-V, 0)`` wrap, ids outside ``[-V, V)`` give NaN.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.ops.attention import flash_attention, pick_block
from kvedge_torch.ops.xent import fused_xent, wrap_targets
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.parallel.sharding import (
    all_reduce_tokens,
    copy_to_model,
    from_last_stage,
    gather_from_model,
    hand_off,
    reduce_from_model,
    token_ranks,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype must be one of {sorted(_DTYPES)}, got {name!r}"
        ) from None


def init_params(seed: int, cfg: TransformerConfig) -> dict[str, np.ndarray]:
    """The fp32 param tree, made with numpy from ``seed``.

    Same keys, shapes and scales as the reference's ``init_params``
    (normal(0, 1) times 0.02 for the embedding, ``fan_in ** -0.5`` for
    the projections, ones for the norm gains); the draws come from
    ``np.random.default_rng(seed)``, so the values are the port's own.
    """
    cfg.validate()
    d, h, kv, dh, f, layers = (
        cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_head, cfg.d_ff,
        cfg.n_layers,
    )
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    params = {
        "embedding": normal((cfg.vocab, d), 0.02),
        "w_qkv": normal((layers, d, (h + 2 * kv) * dh), d ** -0.5),
        "w_out": normal((layers, h * dh, d), (h * dh) ** -0.5),
        "ln_attn": np.ones((layers, d), np.float32),
        "ln_mlp": np.ones((layers, d), np.float32),
        "ln_final": np.ones((d,), np.float32),
    }
    if cfg.n_experts:
        e = cfg.n_experts
        params["router"] = normal((layers, d, e), d ** -0.5)
        params["w_up_experts"] = normal((layers, e, d, f), d ** -0.5)
        params["w_down_experts"] = normal((layers, e, f, d), f ** -0.5)
    else:
        params["w_up"] = normal((layers, d, f), d ** -0.5)
        params["w_down"] = normal((layers, f, d), f ** -0.5)
    return params


def tied_readout(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Weight-tied logits, fp32: ``x [..., D] @ embedding [V, D].T`` with
    the embedding rounded to x's dtype first (the reference's
    ``embedding.T.astype(x.dtype)``)."""
    return torch.matmul(x.float(), embedding.to(x.dtype).float().t())


def stacked_layer_params(params: dict, cfg: TransformerConfig) -> tuple:
    """The per-layer tensors in the order the layer bodies unpack them,
    switched on ``cfg.n_experts``: ``(w_qkv, w_out, w_up, w_down,
    ln_attn, ln_mlp)``, or ``(w_qkv, w_out, router, w_up_experts,
    w_down_experts, ln_attn, ln_mlp)``. Every body reads the attention
    weights from the front and the norm gains from the back."""
    if cfg.n_experts:
        return (
            params["w_qkv"], params["w_out"], params["router"],
            params["w_up_experts"], params["w_down_experts"],
            params["ln_attn"], params["ln_mlp"],
        )
    return (
        params["w_qkv"], params["w_out"], params["w_up"], params["w_down"],
        params["ln_attn"], params["ln_mlp"],
    )


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    scale = torch.rsqrt(
        torch.mean(torch.square(x.float()), dim=-1, keepdim=True) + 1e-6
    )
    return (x * scale.to(x.dtype)) * gain.to(x.dtype)


@functools.cache
def _rotary_step(half: int) -> float:
    """``log(10000) / half`` in fp32, as a Python float holding that fp32
    value exactly: computed once on the host, so a rotary step inside a
    captured CUDA graph copies nothing from the host."""
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    return float(log_base / half)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the head dim of x ``[B, T, H, Dh]``.

    ``positions`` is ``[T]`` (shared by every row) or ``[B, T]`` (each
    decode row at its own position)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * _rotary_step(half)
    )
    angles = positions.to(torch.float32)[..., None] * freqs  # [.., T, half]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]  # broadcast over heads
    sin = sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def split_qkv(cfg: TransformerConfig, qkv: torch.Tensor, tp: int = 1):
    """Split a fused ``[..., (H+2K)*Dh]`` projection into q/k/v heads;
    under a ``model`` axis of ``tp`` the projection holds this rank's
    ``H/tp`` and ``K/tp`` heads (``parallel/sharding.py``)."""
    *lead, _ = qkv.shape
    h, kv, dh = cfg.n_heads // tp, cfg.kv_heads // tp, cfg.d_head
    q = qkv[..., : h * dh].reshape(*lead, h, dh)
    k = qkv[..., h * dh:(h + kv) * dh].reshape(*lead, kv, dh)
    v = qkv[..., (h + kv) * dh:].reshape(*lead, kv, dh)
    return q, k, v


def score_divisor(d_head: int, dtype: torch.dtype) -> float:
    """``sqrt(d_head)`` rounded to the compute dtype, as the reference's
    ``scores / (dh ** 0.5)`` converts its Python scalar to the array's
    dtype before dividing."""
    return torch.tensor(math.sqrt(d_head), dtype=dtype).item()


def scale_scores(scores: torch.Tensor, d_head: int) -> torch.Tensor:
    """The divide by ``sqrt(d_head)`` in the scores' dtype: an fp32
    division of the upcast scores by the dtype-rounded divisor, rounded
    back once."""
    div = score_divisor(d_head, scores.dtype)
    return (scores.float() / div).to(scores.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, w_up, w_down, ln_mlp,
        mesh=NO_MESH) -> torch.Tensor:
    """The dense MLP half of a block, residual included; under a
    ``model`` axis column- then row-parallel (f and g)."""
    normed = copy_to_model(_rmsnorm(x, ln_mlp), mesh)
    return x + reduce_from_model(
        gelu(normed @ w_up.to(x.dtype)) @ w_down.to(x.dtype), mesh)


def block_mlp(cfg: TransformerConfig, x: torch.Tensor,
              layer_params, mesh=NO_MESH) -> torch.Tensor:
    """The MLP half of a serving block (contiguous or paged decode),
    residual included: the dense :func:`mlp`, or with ``cfg.n_experts``
    the dropless routed experts (``moe.routed_ffn_block``). Under a
    ``model`` axis the layer holds this rank's F slice of every expert:
    f before the block, g over its gated outputs (the gates are linear
    in them). Under an ``expert`` axis it holds ``E/ep`` whole experts
    and the block sums each choice over the ``expert`` group, inside
    the model axis's f and g."""
    if not cfg.n_experts:
        _, _, w_up, w_down, _, ln_mlp = layer_params
        return mlp(x, w_up, w_down, ln_mlp, mesh)
    from kvedge_torch.models.moe import routed_ffn_block

    _, _, router, w_up, w_down, _, ln_mlp = layer_params
    normed = copy_to_model(_rmsnorm(x, ln_mlp), mesh)
    return x + reduce_from_model(
        routed_ffn_block(normed, router, w_up, w_down,
                         top_k=cfg.expert_top_k, mesh=mesh), mesh)


def _layer(cfg: TransformerConfig, x: torch.Tensor, layer_params,
           mesh=NO_MESH, pipelined: bool = False):
    """One pre-norm block; x ``[B, T, D]``. Returns ``(x, aux)``: ``aux``
    is the MoE router's load-balancing loss for this layer (fp32 0.0 for
    a dense FFN).

    x is this rank's ``[B/dp, T/sp, D]`` block of the mesh
    (``parallel/mesh.py``; the whole batch under :data:`NO_MESH`): rotary
    positions are offset by the seq rank times the local T, the layer
    holds ``H/tp`` heads under a ``model`` axis (the Megatron f before
    each column-parallel product, g after each row-parallel one), and
    ``"ring"`` and ``"ulysses"`` attend across the ``seq`` group; they
    need a mesh with that axis, as the reference's need a mesh.
    ``pipelined`` (a stage body of ``parallel/pipeline.py``): x is one
    microbatch's block, and an MoE layer binds capacity, positions and
    its balance statistics on it alone (``moe.py`` module doc)."""
    w_qkv, w_out, ln_attn, ln_mlp = (layer_params[0], layer_params[1],
                                     layer_params[-2], layer_params[-1])
    batch, seq, d = x.shape
    tp = mesh.size("model")
    h, kv, dh = cfg.n_heads // tp, cfg.kv_heads // tp, cfg.d_head
    dtype = x.dtype

    normed = copy_to_model(_rmsnorm(x, ln_attn), mesh)
    q, k, v = split_qkv(cfg, normed @ w_qkv.to(dtype), tp)
    # seq is the LOCAL chunk length; chunks are contiguous in sequence
    # order, so global positions offset by the seq index.
    positions = mesh.index("seq") * seq + torch.arange(seq, device=x.device)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    if kv != h:
        # Head h reads kv head h // group (split_qkv's kv-major layout).
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    if cfg.attention in ("ring", "ulysses"):
        if "seq" not in mesh.axis_names:
            raise ValueError(
                f"attention={cfg.attention!r} needs a mesh with a 'seq' "
                "axis passed to forward()/make_train_step()"
            )
        if cfg.attention == "ring":
            from kvedge_torch.parallel.ringattention import (
                ring_attention_local as attend,
            )
        else:
            from kvedge_torch.parallel.ulysses import (
                ulysses_attention_local as attend,
            )
        attended = attend(q, k, v, mesh)
    elif mesh.size("seq") > 1:
        raise ValueError(
            f"attention={cfg.attention!r} would attend within each 'seq' "
            "rank's chunk only; a 'seq' axis needs attention = \"ring\" "
            "or \"ulysses\"")
    elif cfg.attention == "flash":
        # [B, T, H, Dh] -> [B*H, T, Dh], the reference's heads_to_programs.
        def heads_to_programs(t):
            return t.transpose(1, 2).reshape(batch * h, seq, dh)

        attended = flash_attention(
            heads_to_programs(q), heads_to_programs(k), heads_to_programs(v),
            pick_block(seq))
        attended = attended.reshape(batch, h, seq, dh).transpose(1, 2)
    else:
        scores = scale_scores(torch.einsum("bqhd,bkhd->bhqk", q, k), dh)
        causal = torch.ones(seq, seq, dtype=torch.bool,
                            device=x.device).tril()
        scores = scores.masked_fill(~causal, torch.finfo(dtype).min)
        weights = torch.softmax(scores.float(), dim=-1).to(dtype)
        attended = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    x = x + reduce_from_model(
        attended.reshape(batch, seq, h * dh) @ w_out.to(dtype), mesh)

    if not cfg.n_experts:
        _, _, w_up, w_down, _, _ = layer_params
        return mlp(x, w_up, w_down, ln_mlp, mesh), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    from kvedge_torch.models.moe import moe_ffn

    _, _, router, w_up, w_down, _, _ = layer_params
    out, aux = moe_ffn(
        _rmsnorm(x, ln_mlp).reshape(batch * seq, d), router, w_up, w_down,
        capacity_factor=cfg.expert_capacity_factor, top_k=cfg.expert_top_k,
        mesh=mesh.without("data", "seq") if pipelined else mesh,
        block=(batch, seq))
    return x + out.reshape(batch, seq, d), aux


def forward(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, T]`` int -> logits ``[B, T, V]`` fp32.

    The naive-attention forward pass, whatever ``cfg.attention`` says:
    the in-port oracle that paged decode is held to (paged greedy tokens
    == this pass's argmax). An MoE model routes with capacity here, as
    the reference's ``forward`` does."""
    cfg = dataclasses.replace(cfg, attention="naive")
    x = params["embedding"][tokens]
    stacked = stacked_layer_params(params, cfg)
    with torch.no_grad():
        for layer in range(cfg.n_layers):
            x, _ = _layer(cfg, x, tuple(p[layer] for p in stacked))
        x = _rmsnorm(x, params["ln_final"])
        return tied_readout(x, params["embedding"])


# The non-batched products "dots" remat saves: what ``x @ w`` lowers to.
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def forward_hidden(params: dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, mesh=NO_MESH):
    """tokens ``[B, T]`` int -> ``(hidden [B, T, D], aux)``: the stack up
    to and including the final RMSNorm in the compute dtype,
    differentiable, and the mean of the layers' MoE load-balancing
    losses (fp32; 0.0 for a dense FFN).

    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): ``remat_policy="full"``
    recomputes all of it in backward, so the flash forward kernel runs
    twice per layer and step; ``"dots"`` keeps the non-batched
    products' outputs (module doc). Tokens are this rank's block of the
    mesh, and the feature-sharded embedding's lookup is gathered over
    the ``model`` group.

    With ``cfg.pipeline_stages > 1`` the stack is this rank's ``L/S``
    layers, run by the GPipe schedule over the mesh's ``stage`` axis
    (``parallel/pipeline.py``): hidden and aux come out the same on
    every stage, and the loss heads run on them unchanged."""
    dtype = torch_dtype(cfg.dtype)
    x = gather_from_model(params["embedding"][tokens], mesh).to(dtype)
    stacked = stacked_layer_params(params, cfg)
    policy = _dots_context if cfg.remat_policy == "dots" else None
    if cfg.pipeline_stages > 1:
        if not mesh.axis_names:
            raise ValueError(
                "pipeline_stages > 1 needs a mesh with a 'stage' axis "
                "passed to forward()/make_train_step()"
            )
        from kvedge_torch.parallel.pipeline import pipeline_layers

        seq_axis = ("seq" if cfg.attention in ("ring", "ulysses")
                    and "seq" in mesh.axis_names else None)
        x, aux = pipeline_layers(
            x, stacked,
            lambda carry, lp: _layer(cfg, carry, lp, mesh, pipelined=True),
            mesh, n_layers=cfg.n_layers, seq_axis=seq_axis,
            n_microbatches=cfg.pipeline_microbatches, remat=cfg.remat,
            remat_policy=policy)
        return _rmsnorm(x, params["ln_final"]), aux
    remat = cfg.remat and torch.is_grad_enabled()
    extra = {"context_fn": policy} if policy is not None else {}
    aux = []
    for layer in range(cfg.n_layers):
        layer_params = tuple(p[layer] for p in stacked)
        if remat:
            x, layer_aux = checkpoint(_layer, cfg, x, layer_params, mesh,
                                      use_reentrant=False, **extra)
        else:
            x, layer_aux = _layer(cfg, x, layer_params, mesh)
        aux.append(layer_aux)
    return _rmsnorm(x, params["ln_final"]), torch.stack(aux).mean()


def readout(x: torch.Tensor, embedding: torch.Tensor, mesh=NO_MESH):
    """:func:`tied_readout`; under a ``model`` axis the embedding is this
    rank's feature slice: f, the slice of x times it, then g over the
    partial logits (``parallel/sharding.py``)."""
    width = embedding.shape[-1]
    part = copy_to_model(x, mesh).narrow(-1, mesh.index("model") * width,
                                         width)
    return reduce_from_model(tied_readout(part, embedding), mesh)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 mesh=NO_MESH) -> torch.Tensor:
    """Serving's embedding rows of ``tokens``, ``[..., D]``, gathered over
    ``model`` from the feature-sharded table. Only the first stage of a
    ``stage`` axis embeds: a later stage's rows arrive by
    :func:`run_stages`'s hand-off, so it gets a buffer of their shape
    (no lookup, no collective)."""
    if mesh.index("stage") > 0:
        return torch.empty(
            (*tokens.shape, embedding.shape[-1] * mesh.size("model")),
            dtype=embedding.dtype, device=tokens.device)
    return gather_from_model(embedding[tokens], mesh)


def run_stages(x: torch.Tensor, mesh, run_local) -> torch.Tensor:
    """The serving layer stack over a ``stage`` axis of S: stage s runs
    its ``L/S`` layers (``run_local``, on the hidden state ``[B, Q, D]``)
    once stage s - 1 handed that state on, and hands its output to the
    next (``parallel/sharding.hand_off``); every rank takes part in
    every hand-off, so the collectives run in one order on all of them.
    Returns the last stage's output on the last stage (a stale buffer
    elsewhere, which :func:`staged_logits` does not read). Without a
    ``stage`` axis, ``run_local(x)``."""
    me, n = mesh.index("stage"), mesh.size("stage")
    for stage in range(n):
        if stage == me:
            x = run_local(x)
        if stage < n - 1:
            x = hand_off(x, mesh, stage)
    return x


def staged_logits(x: torch.Tensor, ln_final: torch.Tensor,
                  embedding: torch.Tensor, mesh=NO_MESH,
                  all_positions: bool = False) -> torch.Tensor:
    """The serving head after :func:`run_stages`: ``ln_final`` and the
    tied :func:`readout` on the last stage, at every query position
    ``[B, Q, V]`` or the last ``[B, V]``, then broadcast from it over
    the ``stage`` group (``parallel/sharding.from_last_stage``), so
    every rank holds the same fp32 logits."""
    if mesh.index("stage") == mesh.size("stage") - 1:
        x = _rmsnorm(x, ln_final)
        logits = readout(x if all_positions else x[:, -1], embedding, mesh)
    else:
        shape = x.shape[:-1] if all_positions else x.shape[:1]
        logits = torch.empty((*shape, embedding.shape[0]),
                             dtype=torch.float32, device=x.device)
    return from_last_stage(logits, mesh)


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh=NO_MESH):
    """tokens ``[B, T]`` int -> ``(logits [B, T, V] fp32, aux fp32)``:
    :func:`forward_hidden` with the weight-tied readout on top, in
    ``cfg.attention`` and with grad as the caller has it."""
    hidden, aux = forward_hidden(params, tokens, cfg, mesh)
    return readout(hidden, params["embedding"], mesh), aux


def take_target_logit(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., target]`` with ``jnp.take_along_axis``'s semantics:
    negative ids in ``[-V, 0)`` wrap, ids outside ``[-V, V)`` give NaN
    (a corrupt corpus NaNs the loss loudly instead of raising or
    training on a wrong logit)."""
    ids, valid = wrap_targets(targets, logits.shape[-1])
    picked = torch.gather(logits, -1, ids[..., None].long())[..., 0]
    return picked.masked_fill(~valid, float("nan"))


def _fused_xent_loss(params: dict, inputs: torch.Tensor,
                     targets: torch.Tensor,
                     cfg: TransformerConfig, mesh=NO_MESH):
    """The training cross-entropy through the fused kernels: the hidden
    rows ``[B*T, D]`` go straight into :func:`fused_xent`, so the
    ``[B, T, V]`` logits never exist in either pass. Returns
    ``(per_row, aux)``. A ``model`` axis above 1 is refused with the
    reference's message; under ``data`` and ``seq`` axes each rank's
    rows are its own block."""
    if mesh.size("model") > 1:
        raise ValueError(
            "fused_xent does not compose with tensor parallelism "
            "('model' axis > 1): the D contraction would need a psum "
            "before the online softmax; disable fused_xent"
        )
    hidden, aux = forward_hidden(params, inputs, cfg, mesh)
    b, t, d = hidden.shape
    per_row = fused_xent(hidden.reshape(b * t, d), params["embedding"],
                         targets.reshape(b * t))
    return per_row, aux


def _seq_chunk(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous chunk of ``[B, T]`` along the seq axis."""
    sp = mesh.size("seq")
    if x.shape[1] % sp:
        raise ValueError(
            f"sequence length {x.shape[1]} must divide by the 'seq' axis "
            f"size {sp}"
        )
    width = x.shape[1] // sp
    return x.narrow(1, mesh.index("seq") * width, width)


def loss_fn(params: dict, batch: torch.Tensor,
            cfg: TransformerConfig, mesh=NO_MESH) -> torch.Tensor:
    """Next-token cross-entropy, fp32: batch ``[B, T+1]`` int, targets
    shifted by one; ``mean(logsumexp(logits) - logits[target])``, plus
    ``moe_aux_weight`` times the layers' mean load-balancing loss for an
    MoE model.

    ``batch`` is this rank's data rows, and the rank takes its seq chunk
    of inputs and targets. It returns its share of the loss: its tokens'
    summed cross-entropy over the GLOBAL token count, plus the (globally
    computed) aux term over the data x seq ranks, so that the shares
    summed over those ranks are the loss and their gradients, summed
    likewise, the loss's gradient (``make_train_step``). Under
    :data:`NO_MESH` the share is the loss."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    inputs, targets = _seq_chunk(inputs, mesh), _seq_chunk(targets, mesh)
    if cfg.fused_xent:
        per_row, aux = _fused_xent_loss(params, inputs, targets, cfg, mesh)
    else:
        logits, aux = forward_with_aux(params, inputs, cfg, mesh)
        per_row = (torch.logsumexp(logits, dim=-1)
                   - take_target_logit(logits, targets))
    share = token_ranks(mesh)
    ce = per_row.sum() / (per_row.numel() * share)
    if cfg.n_experts:
        ce = ce + cfg.moe_aux_weight * aux / share
    return ce


def global_loss(share: torch.Tensor, mesh=NO_MESH) -> torch.Tensor:
    """The loss from :func:`loss_fn`'s per-rank share: the sum over the
    data x seq ranks (the share itself without a group)."""
    return all_reduce_tokens(share, mesh)
