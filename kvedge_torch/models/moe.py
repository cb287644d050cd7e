"""Mixture-of-experts FFN: the port's copy of the JAX package's
``models/moe.py``, with its ``expert`` mesh axis.

* **Top-k routing (k = 1 Switch, k = 2 GShard) with a static capacity
  in training.** Each expert has ``C = ceil(k * tokens / E * factor)``
  slots; a dispatch routed past its expert's capacity is dropped (its
  FFN output is zero and the residual carries the token). First choices
  claim slots before any second choice. Top-1 gates with the raw router
  probability, top-2 normalises the pair.
* **Dispatch by index, not by one-hots.** The reference builds a
  ``[k*N, E, C]`` one-hot dispatch tensor and contracts it with einsums;
  at the drop-free capacity ``C`` grows with ``N``, so that tensor grows
  as ``N**2``. The port computes the same function from the cumsum
  positions: a slot's token is gathered, the experts run as two batched
  products over ``[E, C, D]``, and each dispatch gathers its slot's
  output back. Every gather is an ``aten::index``, whose backward
  accumulates with a sort on the card (deterministic), and the rows a
  mask zeroes carry zero gradients.
* **The router in fp32**: ``x.float() @ router.float()`` and a softmax
  in fp32 (the weight bridge leaves ``router`` fp32); the experts' two
  products run in the compute dtype.
* **Ties go to the lower expert index**, as ``lax.top_k`` breaks them:
  top-1 is ``argmax`` (the first maximum), top-2 takes ``argmax`` again
  with the first choice masked out.
* **Serving routes droplessly**: :func:`moe_ffn_dropless` gathers each
  token's expert weights (``[N, D, F]`` a choice). Its shapes are fixed
  and no host value steers it, so decode windows, spec windows and
  prefill chunks capture it in their CUDA graphs; past
  ``_GATHER_MAX_TOKENS`` tokens :func:`routed_ffn_block` runs the same
  gather over fixed chunks of 64 with a padded tail.

The router's load-balancing loss (Switch eq. 4 over *first* choices
before capacity: ``E * sum_e f_e * P_e``, 1.0 when routing is uniform)
is returned beside the output and added to the training loss.

Under a mesh (``parallel/mesh.py``) a rank holds a ``[B/dp, T/sp]``
block of the tokens, and the training path keeps the reference's global
semantics, where XLA partitions one global computation: the capacity
comes from the global token count, a dispatch's position in its expert
is its place in the global order (the ranks' expert choices are
gathered over the ``data`` and ``seq`` groups), and the load-balancing
statistics are sums over those groups. A rank's experts run only its own
kept rows, in slots of ``min(capacity, local tokens)`` an expert. A
``model`` axis splits each expert's FFN as the dense one (f before the
up product, g after the down product).

An ``expert`` axis of ``ep`` gives a rank ``E/ep`` whole experts
(``parallel/sharding.py``). The batch is not sharded on it, so every
rank of an expert group routes the same tokens to the same slots; the
reference's all-to-alls are XLA's, and the port writes its own for the
same function: *f* over ``expert`` on the tokens (identity forward,
all-reduce backward, since a rank's input gradient holds only its
experts' share), this rank's experts run their ``[E/ep, C, D]`` slots,
and their outputs are all-gathered over ``expert`` (backward: this
rank's slice). Routing, gates and combine are computed alike on every
expert rank, so the router's, the norms' and attention's gradients are
equal there and are not summed over ``expert``.

Serving over an ``expert`` axis of ``ep`` (:func:`moe_ffn_dropless`)
never forms per-expert slots, so it gathers nothing over ``expert``: a
rank computes, for each choice, the contribution of the tokens whose
chosen expert is one of its own (its weights gathered by the local
index, the other rows zeroed by a select), and one all-reduce over the
``expert`` group a choice completes it
(``parallel/sharding.sum_over_experts``). Every row of a choice's sum
is nonzero on exactly one rank, so the sum adds only zeros to it, and
one process's rounding points stand: the gate product in the compute
dtype, then choice 0 plus choice 1. The result equals one process's
bit for bit.

Under the pipelines (``parallel/pipeline.py``) a layer is given the mesh
without ``data`` and ``seq`` (``Mesh.without``): capacity, positions and
the load-balancing statistics bind on this rank's microbatch block, as
in the reference, whose pipeline makes those axes manual.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from kvedge_torch.models.transformer import gelu
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.parallel.sharding import (
    all_gather_tokens,
    all_reduce_tokens,
    copy_to_experts,
    copy_to_model,
    gather_from_experts,
    reduce_from_model,
    sum_over_experts,
)


def warn_if_train_serve_divergence(cfg) -> None:
    """Warn when cached serving can silently disagree with training.

    Serving routes droplessly; training drops dispatches past capacity.
    A token's top-k choices are distinct experts, so an expert's demand
    is at most ``n_tokens`` and ``expert_capacity_factor * expert_top_k
    >= n_experts`` guarantees zero training drops; below that a model
    trained with drops and served dropless can diverge, so the serving
    boundary (cache construction) warns."""
    if (cfg.n_experts
            and cfg.expert_capacity_factor * cfg.expert_top_k
            < cfg.n_experts):
        warnings.warn(
            f"MoE serving with expert_capacity_factor="
            f"{cfg.expert_capacity_factor} * expert_top_k="
            f"{cfg.expert_top_k} < n_experts={cfg.n_experts}: training "
            "may have dropped dispatches that dropless serving will "
            "route, so cached decode can disagree with the "
            "teacher-forced forward pass. Train with "
            "expert_capacity_factor >= n_experts / expert_top_k for "
            "exact train/serve agreement (models/moe.py).",
            RuntimeWarning, stacklevel=3,
        )


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert slot count: ceil(tokens/E * factor), at least 1."""
    return max(1, math.ceil(n_tokens * capacity_factor / n_experts))


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The routing decision shared by training and serving: (probs
    ``[N, E]`` fp32, idx ``[N, k]`` int64, gates ``[N, k]`` fp32)."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    first = torch.argmax(probs, dim=-1)
    if top_k == 1:
        idx = first[:, None]
    else:
        experts = torch.arange(probs.shape[-1], device=probs.device)
        rest = probs.masked_fill(experts == first[:, None], -math.inf)
        idx = torch.stack([first, torch.argmax(rest, dim=-1)], dim=-1)
    picked = torch.gather(probs, -1, idx)
    gates = picked if top_k == 1 else picked / picked.sum(-1, keepdim=True)
    return probs, idx, gates


def _global_positions(expert: torch.Tensor, top_k: int, n_experts: int,
                      mesh, block):
    """(position of each local dispatch row in its expert in the GLOBAL
    order, the global token count): the ranks' ``[B/dp, T/sp, k]``
    choices are gathered into ``[B, T, k]`` and numbered in the
    reference's order (choice-major, then row, then position)."""
    bl, tl = block
    local = expert.reshape(top_k, bl, tl).permute(1, 2, 0)
    full = all_gather_tokens(local, mesh)                      # [B, T, k]
    order = full.permute(2, 0, 1).reshape(-1)
    position = torch.cumsum(F.one_hot(order, n_experts), dim=0).gather(
        1, order[:, None])[:, 0] - 1
    mine = position.reshape(top_k, *full.shape[:2]).narrow(
        1, mesh.index("data") * bl, bl).narrow(2, mesh.index("seq") * tl, tl)
    return mine.reshape(-1), full.shape[0] * full.shape[1]


def moe_ffn(x: torch.Tensor, router_w, w_up, w_down, *,
            capacity_factor: float, top_k: int = 1, mesh=NO_MESH,
            block=None):
    """Top-k (k = 1 or 2) MoE feed-forward with capacity, the training
    path. x ``[N, D]``; router_w ``[D, E]``; w_up ``[E, D, F]``; w_down
    ``[E, F, D]``. Returns ``(out [N, D], aux_loss fp32 scalar)``.

    Dispatch row r of the ``k * N`` rows is choice ``r // N`` of token
    ``r % N`` (all first choices before any second), and its position
    in its expert is the count of earlier rows routed there: rows at
    position ``>= C`` are dropped, as the reference's cumsum drops
    them. x is the rank's ``block = (B/dp, T/sp)`` of tokens of the
    mesh, row-major (one row of N tokens when ``block`` is None), and
    positions and statistics are global (module doc)."""
    n_tokens, d = x.shape
    n_experts = router_w.shape[-1]
    dtype = x.dtype

    probs, idx, gates = _route(x, router_w, top_k)
    expert = idx.t().reshape(-1)                               # [kN]
    position = torch.cumsum(F.one_hot(expert, n_experts), dim=0).gather(
        1, expert[:, None])[:, 0] - 1
    # Kept rows are a prefix of each expert's local rows (the local order
    # is the global order's), so their local positions fit in
    # min(capacity, N) slots.
    global_position, n_global = _global_positions(
        expert, top_k, n_experts, mesh, block or (1, n_tokens))
    capacity = expert_capacity(top_k * n_global, n_experts, capacity_factor)
    kept = global_position < capacity
    capacity = min(capacity, n_tokens)
    n_slots = n_experts * capacity
    slot = expert * capacity + position

    # The dispatch row that fills each slot (k*N for an empty slot); a
    # dropped row writes the spare entry n_slots, which is cut off.
    rows = torch.arange(top_k * n_tokens, device=x.device)
    src = torch.full((n_slots + 1,), top_k * n_tokens, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, torch.where(kept, slot, n_slots), rows)
    # This rank runs its E/ep experts' slots (all of them without an
    # expert axis); their outputs are gathered over the expert group.
    local = n_experts // mesh.size("expert")
    src = src[:n_slots].reshape(n_experts, capacity).narrow(
        0, mesh.index("expert") * local, local).reshape(-1)
    filled = (src < top_k * n_tokens)[:, None]
    tokens = copy_to_experts(copy_to_model(x, mesh), mesh)
    expert_in = torch.where(filled, tokens[src % n_tokens], 0)
    hidden = gelu(torch.bmm(expert_in.reshape(local, capacity, d),
                            w_up.to(dtype)))
    expert_out = reduce_from_model(torch.bmm(hidden, w_down.to(dtype)),
                                   mesh)
    expert_out = gather_from_experts(expert_out, mesh).reshape(n_slots, d)

    # Each dispatch reads its slot's output back, times its gate in the
    # compute dtype; the k products sum in fp32 and round once (the
    # reference's combine einsum).
    back = torch.where(kept[:, None], expert_out[torch.where(kept, slot, 0)],
                       0).reshape(top_k, n_tokens, d).float()
    gate = gates.t().to(dtype).float()[:, :, None]             # [k, N, 1]
    out = (gate * back).sum(0).to(dtype)

    # Load balancing over the pre-capacity FIRST choices.
    stats = all_reduce_tokens(torch.cat([
        F.one_hot(idx[:, 0], n_experts).float().sum(0),
        probs.sum(0)]), mesh) / n_global
    fraction, mean_probs = stats[:n_experts], stats[n_experts:]
    aux_loss = n_experts * torch.sum(fraction * mean_probs)
    return out, aux_loss


def moe_ffn_dropless(x: torch.Tensor, router_w, w_up, w_down, *,
                     top_k: int = 1, mesh=NO_MESH) -> torch.Tensor:
    """Per-token routed FFN without capacity, the serving path: x
    ``[N, D]`` -> ``[N, D]``. Each token runs through its top-k experts
    by a gather of their weights (``[N, D, F]`` a choice), combined with
    :func:`_route`'s gates: each choice's output times its gate in the
    compute dtype, choice 0 plus choice 1. Agrees with the training
    path when training capacity never bound
    (:func:`warn_if_train_serve_divergence`).

    ``w_up`` and ``w_down`` are this rank's ``E/ep`` experts under an
    ``expert`` axis (all E without one): a choice's rows routed to
    another rank's expert are zeroed, and the choice is summed over the
    ``expert`` group before the choices are added (module doc)."""
    _, idx, gates = _route(x, router_w, top_k)
    dtype = x.dtype
    local = w_up.shape[0]
    first = mesh.index("expert") * local
    out = None
    for choice in range(top_k):
        e = idx[:, choice]
        if local < router_w.shape[-1]:
            mine = (e >= first) & (e < first + local)
            e = torch.where(mine, e - first, 0)
        up = torch.bmm(x[:, None, :], w_up[e].to(dtype))[:, 0]
        contrib = torch.bmm(gelu(up)[:, None, :], w_down[e].to(dtype))[:, 0]
        contrib = contrib * gates[:, choice, None].to(dtype)
        if local < router_w.shape[-1]:
            contrib = torch.where(mine[:, None], contrib, 0)
        contrib = sum_over_experts(contrib, mesh)
        out = contrib if out is None else out + contrib
    return out


# The per-token weight gather holds [chunk, D, F] copies of the weights:
# right at decode (a few rows) but about N/E times the layer's weights
# for a long prefill. Past this many tokens the serving block runs the
# same gather over fixed chunks, so memory stays at one chunk's copies
# and routing stays per token (matmul rounding may differ between chunk
# shapes, as between the gather and the training dispatch).
_GATHER_MAX_TOKENS = 64


def routed_ffn_block(normed: torch.Tensor, router_w, w_up, w_down, *,
                     top_k: int = 1, mesh=NO_MESH) -> torch.Tensor:
    """The serving layers' MoE block, ``[B, Q, D]`` in and out; shared by
    contiguous decode and the paged cache so the two cannot drift. Past
    ``_GATHER_MAX_TOKENS`` tokens, a Python loop over fixed chunks of
    that many rows, the last padded with zero rows. ``mesh``: the
    rank's experts (:func:`moe_ffn_dropless`)."""
    batch, q_len, d = normed.shape
    n_tokens = batch * q_len
    flat = normed.reshape(n_tokens, d)
    if n_tokens <= _GATHER_MAX_TOKENS:
        out = moe_ffn_dropless(flat, router_w, w_up, w_down, top_k=top_k,
                               mesh=mesh)
    else:
        padded = F.pad(flat, (0, 0, 0, -n_tokens % _GATHER_MAX_TOKENS))
        out = torch.cat([
            moe_ffn_dropless(chunk, router_w, w_up, w_down, top_k=top_k,
                             mesh=mesh)
            for chunk in padded.split(_GATHER_MAX_TOKENS)])[:n_tokens]
    return out.reshape(batch, q_len, d)
