"""Contiguous decode: prefill and decode over one ``[L, B, S, K, Dh]`` cache.

The counterpart of the JAX package's ``models/decode.py``: the serve
payload's contiguous backend (``[payload] serving = ""`` or
``"contiguous"``) and the oracle the paged cache is held to. Every row
of a batch sits at the same position, so ragged batches are the paged
cache's job. The math is the paged path's: the same ``_rmsnorm``,
``_rotary``, grouped attention with its rounding chain
(``ops/paged_attention.gather_attention``), ``block_mlp`` (the dense
FFN, or the dropless routed experts of an MoE model) and
``tied_readout``, so paged == contiguous holds token for token.

Differences that are the port's, not the reference's: the cache is
written in place (the reference donates it to a jitted step), its
``length`` is a Python int (the host knows it), and :func:`generate` is
a Python loop of eager steps (the reference's ``lax.scan``). It has no
kernel of its own: the reference's contiguous path has no Pallas kernel.

Every function takes the rank's ``mesh`` (:data:`NO_MESH` by default):
under a ``model`` axis of tp the params are the rank's slices, the cache
holds its ``K/tp`` K/V heads, and each block runs its local heads with
the Megatron f and g around the sharded products, as the paged cache's
blocks do; under a ``stage`` axis of S the cache holds the rank's
``L/S`` layers and the stages run them in turn, handing the hidden
state on (``transformer.run_stages``); under an ``expert`` axis each
MoE block runs the rank's experts and sums each choice over the group.
The logits come out replicated. The multi-process ``serve`` payload's
contiguous backend runs :func:`generate` so on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.moe import warn_if_train_serve_divergence
from kvedge_torch.models.sampling import (
    as_key_tensor,
    row_sample_keys,
    sample_token,
)
from kvedge_torch.models.transformer import (
    _rmsnorm,
    _rotary,
    block_mlp,
    embed_tokens,
    run_stages,
    split_qkv,
    stacked_layer_params,
    staged_logits,
    torch_dtype,
)
from kvedge_torch.ops.paged_attention import gather_attention
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.parallel.sharding import (
    check_shardable,
    check_stages,
    copy_to_model,
    reduce_from_model,
)
from kvedge_torch.runtime.devicecheck import resolve_device


@dataclasses.dataclass
class KVCache:
    """Contiguous KV cache: one ``[L, B, S, K, Dh]`` slab per projection;
    ``length`` valid positions, the same for every row."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: TransformerConfig, batch: int,
               max_seq: int | None = None,
               device: torch.device | str | None = None,
               mesh=NO_MESH) -> KVCache:
    """A zeroed cache on ``device`` (the card unless "cpu" is asked for),
    with this rank's K/V heads under a ``model`` axis and its layers
    under a ``stage`` axis. Warns when an MoE model's training capacity
    can bind (``moe.warn_if_train_serve_divergence``)."""
    cfg.validate()
    warn_if_train_serve_divergence(cfg)
    tp, stages = mesh.size("model"), mesh.size("stage")
    if tp > 1:
        check_shardable(cfg, tp)
    check_stages(cfg, stages)
    shape = (cfg.n_layers // stages, batch, max_seq or cfg.max_seq,
             cfg.kv_heads // tp, cfg.d_head)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def _attend_layer(cfg: TransformerConfig, x, layer_params, k_slab, v_slab,
                  pos: int, mesh=NO_MESH):
    """One decoder block against the cache. x ``[B, Q, D]`` new positions
    starting at ``pos``; k_slab/v_slab ``[B, S, K, Dh]`` this layer's
    cache, written in place. Prefill (Q = prompt, pos = 0) and decode
    (Q = 1) alike; every query sees the slab's positions up to its own."""
    w_qkv, w_out, ln_attn = layer_params[0], layer_params[1], layer_params[-2]
    batch, q_len, _ = x.shape
    tp = mesh.size("model")
    h, dh = cfg.n_heads // tp, cfg.d_head
    dtype = x.dtype
    q, k, v = split_qkv(
        cfg, copy_to_model(_rmsnorm(x, ln_attn), mesh) @ w_qkv.to(dtype), tp)
    positions = pos + torch.arange(q_len, device=x.device)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    k_slab[:, pos:pos + q_len] = k
    v_slab[:, pos:pos + q_len] = v
    attended = gather_attention(q, k_slab, v_slab,
                                positions[None].expand(batch, q_len))
    x = x + reduce_from_model(
        attended.reshape(batch, q_len, h * dh) @ w_out.to(dtype), mesh)
    return block_mlp(cfg, x, layer_params, mesh)


def _run_layers(cfg: TransformerConfig, params: dict, x, cache: KVCache,
                pos: int, all_positions: bool = False, mesh=NO_MESH):
    """The layer stack over the cache; returns (logits, cache advanced to
    ``pos + Q``). ``all_positions`` reads logits at every query position
    (``[B, Q, V]``), otherwise only the last (``[B, V]``). Under a
    ``stage`` axis the rank's ``L/S`` layers, in the stages' turn."""
    stacked = stacked_layer_params(params, cfg)

    def local_layers(x):
        for layer in range(stacked[0].shape[0]):
            x = _attend_layer(cfg, x, tuple(p[layer] for p in stacked),
                              cache.k[layer], cache.v[layer], pos, mesh)
        return x

    logits = staged_logits(run_stages(x, mesh, local_layers),
                           params["ln_final"], params["embedding"], mesh,
                           all_positions)
    return logits, dataclasses.replace(cache, length=pos + x.shape[1])


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, cache: KVCache,
            cfg: TransformerConfig, mesh=NO_MESH):
    """Feed a ``[B, T]`` prompt into an empty cache; returns
    (last-position logits ``[B, V]`` fp32, the filled cache)."""
    x = embed_tokens(params["embedding"], tokens, mesh).to(
        torch_dtype(cfg.dtype))
    return _run_layers(cfg, params, x, cache, 0, mesh=mesh)


@torch.no_grad()
def decode_step(params: dict, cache: KVCache, tokens: torch.Tensor,
                cfg: TransformerConfig, mesh=NO_MESH):
    """One decode step: ``[B]`` tokens at position ``cache.length``;
    returns (logits ``[B, V]`` fp32, the cache advanced by one)."""
    x = embed_tokens(params["embedding"], tokens, mesh)[:, None].to(
        torch_dtype(cfg.dtype))
    return _run_layers(cfg, params, x, cache, cache.length, mesh=mesh)


@torch.no_grad()
def generate(params: dict, prompt, cfg: TransformerConfig, n_new: int,
             sampling=None, sampled: bool = False,
             device: torch.device | str | None = None,
             mesh=NO_MESH) -> torch.Tensor:
    """Decode ``n_new`` tokens after a ``[B, T]`` prompt; returns
    ``[B, T + n_new]`` int64 on ``device`` (the card unless "cpu" is asked
    for; ``params`` live there).

    Greedy by default. With ``sampled=True``, ``sampling`` is
    ``(seed_keys [B, 2] raw uint32 key data, temperature, top_p)``: token
    ``t`` of row ``r`` samples from the nucleus-filtered logits with key
    ``fold_in(seed_keys[r], t)``. Prefill, then ``n_new - 1`` cached
    steps; the last token comes from the last step's logits."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    batch, prompt_len = prompt.shape
    cache = init_cache(cfg, batch, max_seq=prompt_len + n_new, device=dev,
                       mesh=mesh)
    logits, cache = prefill(params, prompt, cache, cfg, mesh)
    if sampled:
        seed_keys, temperature, top_p = sampling
        seed_keys = as_key_tensor(seed_keys, dev)

    def pick(logits, step: int) -> torch.Tensor:
        if not sampled:
            return torch.argmax(logits, dim=-1)
        return sample_token(logits, row_sample_keys(seed_keys, step),
                            temperature, top_p)

    out = [prompt]
    for step in range(n_new - 1):
        token = pick(logits, step)
        out.append(token[:, None])
        logits, cache = decode_step(params, cache, token, cfg, mesh)
    out.append(pick(logits, n_new - 1)[:, None])
    return torch.cat(out, dim=1)
