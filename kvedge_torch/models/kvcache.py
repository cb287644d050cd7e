"""Paged KV cache: fixed-size pages and block tables for ragged serving.

The counterpart of the JAX package's ``models/kvcache.py`` for the
serving slice. K/V live in pages of a pool ``[L, P, page, K, Dh]``; each
sequence holds an ordered block table of page ids, and a page may be
held by several tables and by the server's prefix registry at once
(reference counts). The host class :class:`PagedKVCache` keeps the
reference's method names and semantics (``admit`` with shared pages,
``grow``/``grow_to`` under ``pressure_relief``, ``release``,
``retain_pages``/``release_pages``, the page copies ``cow_page``,
``swapout_pages``/``swapin_pages``, ``snapshot_pages``/``read_pages``/
``write_pages``, ``prefill_chunk``, ``step``,
``step_tokens``, ``step_window``, ``step_window_sampled``, the
pipelined ``dispatch_window``/``dispatch_window_sampled``/
``harvest_window``/``drop_carry``, and speculative decoding:
``step_spec``, ``spec_window_caps``, ``dispatch_spec_window``/
``harvest_spec_window``); the device functions below it keep its math.

Differences that are the port's, not the reference's:

* The reference's programs donate the pools and return new ones; the
  port writes K/V, tables and lengths IN PLACE, so the tensors keep
  their addresses for the CUDA graphs that read them.
* The reference routes a non-live row's scatter out of bounds and drops
  it (``mode="drop"``). Torch has no drop mode, so the pools hold one
  page more than the pool size: page P, the SINK, which no table ever
  names. A row that is not live this step writes its K/V (and int8
  scales) there, with shapes that do not depend on which rows are live.
  ``state.pool_k``/``pool_v`` (and the scale slabs) are the ``[:, :P]``
  views, so the sink is invisible outside this module.
* The device batch dim is a bucket (``min_bucket``, ``bucket_for``,
  ``set_bucket``, the reference's ladder). The reference rebuilds its
  bucket-sized tables and lengths at each resize; the port allocates
  them, and every window input, once at ``[slots, ...]`` and runs a
  bucket over their ``[:bucket]`` views, which share the storage: a
  resize moves nothing on the device and only chooses which graphs
  replay.
* A decode window of W steps is :func:`run_window`: W steps with the
  greedy (or sampled) pick fed back on the device, per-row step caps,
  and the ``[fin, stop_at]`` bookkeeping rows, as the reference's capped
  scans (``_paged_decode_window_capped_impl`` and its sampled twin). On
  CUDA it runs as a captured CUDA graph, one per (bucket, greedy |
  sampled, W), replayed on every dispatch; on the CPU, which the caller
  must ask for, it runs eagerly.
* A spec window of P passes is :func:`run_spec_window` (the reference's
  ``_paged_spec_window_impl`` and its sampled twin): on CUDA a captured
  graph per (bucket, greedy | sampled, P, K). Its pending tokens and
  drafting contexts stay in the window's input tensors between windows
  (the spec carry); the context carries one sink column for the appends
  the reference drops.
* A prefill chunk of C tokens is :func:`run_prefill`, with its tokens,
  slot and offset in the device tensors of :class:`PrefillInputs` (the
  reference traces slot and offset, so it compiles one program per
  chunk length): on CUDA a captured graph per (bucket, C), the prefill
  graphs sharing one memory pool; on the CPU it runs eagerly.
* An MoE model's MLP half is ``moe.routed_ffn_block`` in every pass
  (prefill chunks, decode steps, verify passes): dropless routing with
  fixed shapes and no host value, so the same graphs capture it under
  the same keys.
* Across ranks (``runtime/sliceserve.py``) a device function runs the
  rank's shard: under a ``stage`` axis its ``L/S`` layers over a pool of
  those layers only (the reference replicates the pool over ``stage``),
  the first stage embedding, each stage handing the hidden state to the
  next by a broadcast inside the same pass, and the last stage's logits
  broadcast to all (``transformer.run_stages`` and ``staged_logits``);
  under an ``expert`` axis its ``E/ep`` experts, each choice summed over
  the ``expert`` group (``moe.moe_ffn_dropless``), over the whole pool.
  The collectives run inside the captured graphs, as the ``model``
  axis's all-reduces do.
* The page copies (COW, swap, snapshots) are ``index_select`` /
  ``index_copy_`` over the ``[L, P + 1, ...]`` slabs on the current
  stream, so they run in stream order with the window graphs replayed
  there; a swap-out lands in pinned host tensors. The reference's are
  plain ``jnp`` indexing outside any kernel too.
* Single-query decode attention goes through ``ops/paged_attention.py``
  when ``cfg.paged_attention`` picks the kernel ("auto" on CUDA, or
  "kernel"); prefill and the speculative verify pass (1 + K queries a
  row) keep the plain gather math on every device, as the reference
  keeps its einsum path there.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.moe import warn_if_train_serve_divergence
from kvedge_torch.models.sampling import fold_in, sample_token
from kvedge_torch.models.speculative import _propose_ngram
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
from kvedge_torch.ops.paged_attention import (
    gather_attention,
    gather_pages,
    paged_decode_attention,
)
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.parallel.sharding import (
    check_shardable,
    check_stages,
    copy_to_model,
    reduce_from_model,
)
from kvedge_torch.runtime.devicecheck import resolve_device


@dataclasses.dataclass
class PagedState:
    """Device-side paged cache state (host policy lives in
    :class:`PagedKVCache`). The pools hold P + 1 pages: page P is the
    sink that non-live rows write to. ``scale_k_full``/``scale_v_full``
    (``[L, P + 1, page, K]`` fp32) exist only for an int8 pool: one scale
    per token row and kv head, with the pools holding ``round(x /
    scale)`` int8."""

    pool_k_full: torch.Tensor   # [L, P + 1, page, K, Dh]
    pool_v_full: torch.Tensor   # [L, P + 1, page, K, Dh]
    tables: torch.Tensor        # [B, max_pages] int32 page ids
    lengths: torch.Tensor       # [B] int32 valid positions per sequence
    scale_k_full: torch.Tensor | None = None
    scale_v_full: torch.Tensor | None = None

    @property
    def sink(self) -> int:
        return self.pool_k_full.shape[1] - 1

    @property
    def pool_k(self) -> torch.Tensor:
        """The P pages a table may name, ``[L, P, page, K, Dh]``."""
        return self.pool_k_full[:, :self.sink]

    @property
    def pool_v(self) -> torch.Tensor:
        return self.pool_v_full[:, :self.sink]

    @property
    def scale_k(self) -> torch.Tensor | None:
        return (None if self.scale_k_full is None
                else self.scale_k_full[:, :self.sink])

    @property
    def scale_v(self) -> torch.Tensor | None:
        return (None if self.scale_v_full is None
                else self.scale_v_full[:, :self.sink])


_KV_QMAX = 127.0


def _kv_quantize(x: torch.Tensor):
    """Per-row symmetric int8: x ``[..., Dh]`` -> (int8 ``[..., Dh]``,
    fp32 scale ``[...]``); the floor keeps an all-zero row finite."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / _KV_QMAX, 1e-8)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


class PagedCacheError(RuntimeError):
    pass


def _use_paged_kernel(cfg: TransformerConfig, device: torch.device) -> bool:
    """Resolve ``cfg.paged_attention`` for a single-query decode step."""
    if cfg.paged_attention == "gather":
        return False
    if cfg.paged_attention == "kernel":
        return True
    return device.type == "cuda"


def _write_rows(pool, scales, page_idx, offset, rows_kv):
    """Write token rows ``rows_kv [N, K, Dh]`` at ``(page_idx, offset)``
    of ``pool [P + 1, page, K, Dh]`` in place, quantizing for an int8
    pool."""
    if scales is not None:
        rows_kv, row_scale = _kv_quantize(rows_kv)
        scales[page_idx, offset] = row_scale
    pool[page_idx, offset] = rows_kv


def _scatter_token(pool, scales, tables, lengths, kv_new, live):
    """Write one ``[B, K, Dh]`` token row per sequence at position
    ``lengths[b]`` of its pages (page ``tables[b, lengths[b] // page]``,
    offset ``lengths[b] % page``) for the rows ``live`` marks; the other
    rows write to the sink page. Fixed shapes whatever ``live`` holds."""
    page = pool.shape[1]
    sink = pool.shape[0] - 1
    pos = lengths.long()
    col = torch.clamp_max(pos // page, tables.shape[1] - 1)
    page_idx = torch.gather(tables, 1, col[:, None])[:, 0].long()
    page_idx = torch.where(live, page_idx, sink)
    _write_rows(pool, scales, page_idx, pos % page, kv_new)


def _paged_attend_layer(cfg: TransformerConfig, state: PagedState, x,
                        layer_params, layer: int, q_positions, slot=None,
                        live=None, write_mask=None, mesh=NO_MESH):
    """One block over the paged cache. x ``[B, Q, D]``; q_positions
    ``[B, Q]`` absolute positions of the new tokens. ``slot`` set = the
    prefill of one sequence (B == 1, Q tokens); otherwise a batched pass
    (a decode step, Q == 1, or a speculative verify pass, Q == 1 + K)
    whose token i of row b is written at position ``lengths[b] + i`` when
    ``live[b] & write_mask[b, i]`` (``write_mask`` None = every offset),
    and to the sink page otherwise.

    Under a ``model`` axis of tp the layer holds this rank's ``H/tp`` q
    heads and ``K/tp`` K/V heads (``parallel/sharding.py``), and so do
    the pools: f before the column-parallel products, g after the
    row-parallel ones, and single-query attention on the local heads
    (B1 on the card, the GQA group unchanged). :data:`NO_MESH` skips
    every collective."""
    w_qkv, w_out, ln_attn = layer_params[0], layer_params[1], layer_params[-2]
    batch, q_len, _ = x.shape
    tp = mesh.size("model")
    h, dh = cfg.n_heads // tp, cfg.d_head
    pool_k, pool_v = state.pool_k_full[layer], state.pool_v_full[layer]
    scale_k = (state.scale_k_full[layer]
               if state.scale_k_full is not None else None)
    scale_v = (state.scale_v_full[layer]
               if state.scale_v_full is not None else None)

    q, k, v = split_qkv(
        cfg, copy_to_model(_rmsnorm(x, ln_attn), mesh) @ w_qkv, tp)
    # Decode rows each carry their own position; a prefill shares one.
    positions = q_positions if slot is None else q_positions[0]
    q = _rotary(q, positions)
    k = _rotary(k, positions)

    if slot is None:
        # One scatter per query offset, each landing before the gather
        # below reads the pages (the mask is on absolute positions).
        tables = state.tables
        for i in range(q_len):
            w_live = live if write_mask is None else live & write_mask[:, i]
            _scatter_token(pool_k, scale_k, tables, state.lengths + i,
                           k[:, i], w_live)
            _scatter_token(pool_v, scale_v, tables, state.lengths + i,
                           v[:, i], w_live)
    else:
        # slot is a 0-d device tensor: no host value steers the gather.
        tables = state.tables.index_select(0, slot.reshape(1))
        pos = q_positions[0].long()
        page_idx = tables[0, pos // pool_k.shape[1]].long()
        offset = pos % pool_k.shape[1]
        _write_rows(pool_k, scale_k, page_idx, offset, k[0])
        _write_rows(pool_v, scale_v, page_idx, offset, v[0])

    if slot is None and q_len == 1 and _use_paged_kernel(cfg, x.device):
        att = paged_decode_attention(
            q[:, 0].contiguous(), pool_k, pool_v, tables,
            q_positions[:, 0].contiguous(), scale_k=scale_k, scale_v=scale_v,
        )[:, None]
    else:
        gk = gather_pages(pool_k, scale_k, tables, x.dtype)
        gv = gather_pages(pool_v, scale_v, tables, x.dtype)
        att = gather_attention(q, gk, gv, q_positions)
    x = x + reduce_from_model(att.reshape(batch, q_len, h * dh) @ w_out,
                              mesh)
    return block_mlp(cfg, x, layer_params, mesh)


def _run_paged(cfg, params, state, x, q_positions, slot=None, live=None,
               all_positions: bool = False, write_mask=None, mesh=NO_MESH):
    """The layer stack over the paged cache; logits at the last query
    position ``[B, V]``, or at every one ``[B, Q, V]`` with
    ``all_positions``; replicated on every rank (the readout's partial
    logits are summed over ``model``, and the last stage's broadcast
    over ``stage``). Under a ``stage`` axis the params and the pools
    hold this rank's ``L/S`` layers, indexed from 0, and the stages run
    them in turn (``transformer.run_stages``)."""
    stacked = stacked_layer_params(params, cfg)

    def local_layers(x):
        for layer in range(stacked[0].shape[0]):
            x = _paged_attend_layer(cfg, state, x,
                                    tuple(p[layer] for p in stacked), layer,
                                    q_positions, slot, live, write_mask,
                                    mesh)
        return x

    return staged_logits(run_stages(x, mesh, local_layers),
                         params["ln_final"], params["embedding"], mesh,
                         all_positions)


@dataclasses.dataclass
class PrefillInputs:
    """The inputs of one prefill chunk of C tokens, tensors on the
    cache's device that a CUDA graph reads at their addresses (written
    in place before each replay). The table row comes from the state's
    bucket view, indexed on the device by ``slot``."""

    tokens: torch.Tensor    # int64 [C]
    slot: torch.Tensor      # int64, 0-d
    offset: torch.Tensor    # int64, 0-d: the chunk's first position

    @classmethod
    def zeros(cls, length: int, device: torch.device) -> "PrefillInputs":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)

        return cls(tokens=z(length), slot=z(), offset=z())


@torch.no_grad()
def run_prefill(params: dict, state: PagedState, cfg: TransformerConfig,
                inp: PrefillInputs, mesh=NO_MESH) -> torch.Tensor:
    """Prefill ``inp.tokens`` into row ``inp.slot`` at positions
    ``inp.offset``..; returns the last position's logits ``[V]``. No host
    value enters the body, so one captured graph serves every slot and
    offset of a chunk length (the reference's ``_paged_prefill_impl``)."""
    x = embed_tokens(params["embedding"], inp.tokens, mesh)[None]
    q_positions = (inp.offset + torch.arange(inp.tokens.shape[0],
                                             device=inp.tokens.device))[None]
    return _run_paged(cfg, params, state, x, q_positions, slot=inp.slot,
                      mesh=mesh)[0]


def _paged_prefill(params: dict, state: PagedState, tokens, slot,
                   cfg: TransformerConfig, offset=0,
                   mesh=NO_MESH) -> torch.Tensor:
    """Prefill ``tokens [T]`` into ``slot`` at positions offset.. (ints
    or 0-d tensors), eagerly through :func:`run_prefill`; returns the
    last position's logits ``[V]``."""
    dev = tokens.device
    return run_prefill(params, state, cfg, PrefillInputs(
        tokens=tokens,
        slot=torch.as_tensor(slot, dtype=torch.int64, device=dev),
        offset=torch.as_tensor(offset, dtype=torch.int64, device=dev)),
        mesh)


@torch.no_grad()
def _decode_step_core(params: dict, state: PagedState, tokens,
                      cfg: TransformerConfig, live,
                      mesh=NO_MESH) -> torch.Tensor:
    """One batched decode step: ``tokens [B]`` in, logits ``[B, V]`` out.
    ``live`` ``[B]`` bool marks the rows whose K/V are written and whose
    lengths advance (in place). Shared by the single step and the
    windows, so the two agree token for token."""
    x = embed_tokens(params["embedding"], tokens, mesh)[:, None]
    logits = _run_paged(cfg, params, state, x, state.lengths[:, None],
                        live=live, mesh=mesh)
    state.lengths += live.to(state.lengths.dtype)
    return logits


@dataclasses.dataclass
class WindowInputs:
    """The per-row inputs of one decode window, ``[B]`` tensors on the
    cache's device (``key_data`` ``[B, 2]``: raw uint32 key data held in
    int64). A CUDA graph reads them at their addresses, so they are
    written in place."""

    tokens: torch.Tensor        # int64, the pending token of each row
    active: torch.Tensor        # bool, rows the window decodes
    steps_left: torch.Tensor    # int64, each row's step cap
    stop_tokens: torch.Tensor   # int64, -1 = no stop
    key_data: torch.Tensor      # int64 [B, 2]
    base_steps: torch.Tensor    # int64, a sampled row's token index
    temps: torch.Tensor         # float32
    top_ps: torch.Tensor        # float32
    sampled_mask: torch.Tensor  # bool

    @classmethod
    def zeros(cls, slots: int, device: torch.device) -> "WindowInputs":
        def z(dtype, *shape):
            return torch.zeros((slots, *shape), dtype=dtype, device=device)

        return cls(tokens=z(torch.int64), active=z(torch.bool),
                   steps_left=z(torch.int64), stop_tokens=z(torch.int64),
                   key_data=z(torch.int64, 2), base_steps=z(torch.int64),
                   temps=z(torch.float32), top_ps=z(torch.float32),
                   sampled_mask=z(torch.bool))


@torch.no_grad()
def run_window(params: dict, state: PagedState, cfg: TransformerConfig,
               inp: WindowInputs, n_steps: int,
               sampled: bool, mesh=NO_MESH) -> torch.Tensor:
    """``n_steps`` decode steps with per-row caps and stop bookkeeping;
    returns ``[n_steps + 2, B]`` int32: the produced tokens, then ``fin``
    (0 = window-capped, 1 = froze on its cap, 2 = stop token hit) and
    ``stop_at`` (the first 1-based live step whose token is the row's
    stop, 0 = none).

    Row b is live at step i when ``active[b] & (i < steps_left[b])``. A
    row that is not live re-emits its token, keeps its length and writes
    to the sink page, so a window dispatched ahead of the host's
    bookkeeping never writes past a row's budget. A stop hit does not
    freeze the row: its remaining steps stay inside the granted cap and
    the host truncates at ``stop_at``. With ``sampled``, EVERY row draws
    ``fold_in(key_data[b], base_steps[b] + i)`` through the nucleus
    filter and ``sampled_mask`` selects between the draw and the argmax,
    so the shapes do not depend on the mix."""
    toks = inp.tokens
    stop_at = torch.zeros_like(inp.tokens)
    temps, top_ps = inp.temps[:, None], inp.top_ps[:, None]
    rows = []
    for i in range(n_steps):
        live = inp.active & (inp.steps_left > i)
        logits = _decode_step_core(params, state, toks, cfg, live, mesh)
        nxt = torch.argmax(logits, dim=-1)
        if sampled:
            drawn = sample_token(logits,
                                 fold_in(inp.key_data, inp.base_steps + i),
                                 temps, top_ps)
            nxt = torch.where(inp.sampled_mask, drawn, nxt)
        nxt = torch.where(live, nxt, toks)
        hit = live & (stop_at == 0) & (nxt == inp.stop_tokens)
        stop_at = torch.where(hit, i + 1, stop_at)
        rows.append(nxt)
        toks = nxt
    capped = (inp.active & (inp.steps_left <= n_steps)).long()
    fin = torch.where(stop_at > 0, 2, capped)
    return torch.stack(rows + [fin, stop_at]).to(torch.int32)


@torch.no_grad()
def _spec_verify_core(params: dict, state: PagedState, tokens,
                      cfg: TransformerConfig, active, spec_mask,
                      mesh=NO_MESH):
    """One batched speculative verify pass over the paged cache.

    ``tokens [B, 1+K]``: each row's pending token, then K drafts. One
    forward over the 1+K query positions scores every draft (``y[b, i]``
    is the greedy token after row b's prefix extended by ``tokens[b,
    :i+1]``) and writes the K/V of all 1+K tokens; acceptance is the
    leading agreement, the contiguous decoder's rule, so the emitted
    tokens are plain greedy decode's. A row outside ``spec_mask`` (a
    sampled row) rides with acceptance 0 and its draft offsets write to
    the sink page, so it needs no slack pages.

    Returns ``(emitted [B, K+1], accepted [B], logits0 [B, V])``: row
    b's first ``accepted[b]`` emitted entries are its accepted drafts and
    entry ``accepted[b]`` the bonus token (the model's argmax after
    them); ``logits0`` are the pending position's logits. ``lengths``
    advance in place by ``1 + accepted`` on the ``active`` rows: the
    pending token's K/V and the accepted drafts'. The bonus token's K/V
    is the next pass's first write, as in plain decode. No host read:
    it runs inside a captured graph."""
    k_len = tokens.shape[1] - 1
    x = embed_tokens(params["embedding"], tokens, mesh)  # [B, 1+K, D]
    offsets = torch.arange(1 + k_len, device=tokens.device)
    q_positions = state.lengths[:, None] + offsets[None]
    # Offset 0 (the pending token) always writes; draft offsets only for
    # the rows that can accept them.
    write_mask = spec_mask[:, None] | (offsets == 0)[None]
    logits = _run_paged(cfg, params, state, x, q_positions, live=active,
                        all_positions=True, write_mask=write_mask, mesh=mesh)
    y = torch.argmax(logits, dim=-1)  # [B, 1+K]
    draft = tokens[:, 1:]
    agree = torch.cumprod((draft == y[:, :k_len]).long(), dim=1)
    accepted = agree.sum(dim=1) * spec_mask.long()
    emitted = torch.where(offsets[None] < accepted[:, None],
                          torch.cat([draft, y[:, -1:]], dim=1),
                          torch.gather(y, 1, accepted[:, None]))
    state.lengths += (active.long() * (1 + accepted)).to(state.lengths.dtype)
    return emitted, accepted, logits[:, 0]


@dataclasses.dataclass
class SpecWindowInputs:
    """The inputs of one spec window, tensors on the cache's device that
    a CUDA graph reads at their addresses, so they are written in place.
    ``pending``, ``ctx`` and ``ctx_len`` are also the window's carry: it
    writes its final pending tokens and drafting contexts back, and the
    next window on the carry reads them there. ``ctx`` carries one sink
    column past the context, ``[B, S_ctx + 1]``: an append that must not
    land goes there, and nothing reads it."""

    pending: torch.Tensor       # int64 [B]
    active: torch.Tensor        # bool [B]
    budgets: torch.Tensor       # int64 [B], each row's emission budget
    ctx: torch.Tensor           # int64 [B, S_ctx + 1]
    ctx_len: torch.Tensor       # int64 [B]
    key_data: torch.Tensor      # int64 [B, 2]
    base_steps: torch.Tensor    # int64 [B]
    temps: torch.Tensor         # float32 [B]
    top_ps: torch.Tensor        # float32 [B]
    sampled_mask: torch.Tensor  # bool [B]

    @classmethod
    def zeros(cls, slots: int, s_ctx: int,
              device: torch.device) -> "SpecWindowInputs":
        def z(dtype, *shape):
            return torch.zeros((slots, *shape), dtype=dtype, device=device)

        return cls(pending=z(torch.int64), active=z(torch.bool),
                   budgets=z(torch.int64), ctx=z(torch.int64, s_ctx + 1),
                   ctx_len=z(torch.int64), key_data=z(torch.int64, 2),
                   base_steps=z(torch.int64), temps=z(torch.float32),
                   top_ps=z(torch.float32), sampled_mask=z(torch.bool))


@torch.no_grad()
def run_spec_window(params: dict, state: PagedState, cfg: TransformerConfig,
                    inp: SpecWindowInputs, n_passes: int, k_len: int,
                    sampled: bool, mesh=NO_MESH):
    """``n_passes`` speculative draft + verify passes on the device; the
    counterpart of the reference's ``_paged_spec_window_impl`` and, with
    ``sampled``, of ``_paged_spec_window_sampled_impl``.

    Each pass drafts K tokens per row with :func:`_propose_ngram` over
    the row's context, verifies them through :func:`_spec_verify_core`,
    feeds the bonus token on as the next pending token and appends the
    pass's accepted drafts and bonus to the context. Row b is live while
    ``active[b]`` and its remaining budget (``budgets[b]`` less what it
    emitted) is positive; a frozen row keeps its length, pending token
    and context and writes only to the sink page and the sink column.
    The last live pass may overshoot the budget by up to K; the host
    truncates. With ``sampled``, EVERY row draws ``fold_in(key_data[b],
    base_steps[b] + i)`` from the pending position's logits and
    ``sampled_mask`` selects: a sampled row verifies with acceptance 0
    and advances one token a pass.

    Returns ``(emitted [n_passes, B, K+1], counts [n_passes, B], pending
    [B])`` where ``counts[p, b] = 1 + accepted`` on a live pass (0
    frozen): row b's pass-p tokens are its pending token, then
    ``emitted[p, b, :counts[p, b] - 1]``; ``emitted[p, b, counts[p, b]
    - 1]`` is the next pending. ``inp.pending``, ``inp.ctx`` and
    ``inp.ctx_len`` hold the carry afterwards."""
    s_ctx = inp.ctx.shape[1] - 1
    ctx = inp.ctx
    pending, ctx_len, rem = inp.pending, inp.ctx_len, inp.budgets
    idx = torch.arange(k_len + 1, device=ctx.device)[None]
    if sampled:
        temps, top_ps = inp.temps[:, None], inp.top_ps[:, None]
    emitted_rows, count_rows = [], []
    for i in range(n_passes):
        live = inp.active & (rem > 0)
        spec_live = live & ~inp.sampled_mask if sampled else live
        draft = _propose_ngram(ctx[:, :s_ctx], ctx_len, k_len)
        toks = torch.cat([pending[:, None], draft], dim=1)
        emitted, accepted, logits0 = _spec_verify_core(
            params, state, toks, cfg, live, spec_live, mesh)
        count = live.long() * (1 + accepted)
        bonus = torch.gather(emitted, 1, accepted[:, None])[:, 0]
        if sampled:
            drawn = sample_token(logits0,
                                 fold_in(inp.key_data, inp.base_steps + i),
                                 temps, top_ps)
            bonus = torch.where(inp.sampled_mask, drawn, bonus)
            emitted = torch.where(inp.sampled_mask[:, None], bonus[:, None],
                                  emitted)
        pending = torch.where(live, bonus, pending)
        # Append the pass's accepted drafts and bonus (emitted entries
        # past ``accepted`` repeat the bonus); what must not land goes to
        # the sink column, as the reference's mode="drop".
        pos = ctx_len[:, None] + idx
        ok = live[:, None] & (idx <= accepted[:, None]) & (pos < s_ctx)
        ctx.scatter_(1, torch.where(ok, pos, s_ctx), emitted)
        ctx_len = ctx_len + count
        rem = rem - count
        emitted_rows.append(emitted)
        count_rows.append(count)
    inp.pending.copy_(pending)
    inp.ctx_len.copy_(ctx_len)
    return torch.stack(emitted_rows), torch.stack(count_rows), pending


def _host_ids(tokens) -> np.ndarray:
    """Token ids (a list, an array or a tensor anywhere) as int64 numpy."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu()
    return np.asarray(tokens, np.int64)


def _rows(inputs, n: int):
    """The first ``n`` rows of a ``[slots, ...]`` inputs record: views
    over the same storage, so a graph captured over them reads (and a
    spec window's carry writes) the full record's first rows."""
    return dataclasses.replace(inputs, **{
        f.name: getattr(inputs, f.name)[:n]
        for f in dataclasses.fields(inputs)})


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    # The static output: [W + 2, B] for a window, (emitted, counts,
    # pending) for a spec window, [V] logits for a prefill chunk.
    out: "torch.Tensor | tuple"
    b1_launches: int    # B1 launches one replay makes
    capture_s: float    # the capture's seconds, its warm-up run included


@dataclasses.dataclass
class _WindowHandle:
    """A dispatched window: its block on the host once ``event`` fired
    (``event`` is None on the CPU, where the block is already there).
    ``timing`` is the (start, end) CUDA event pair around its graph
    replay; ``host_ms`` the host time of an eager CPU run
    (:meth:`PagedKVCache.window_device_ms` reads one of them).
    ``captured`` is true when its dispatch captured the graph first."""

    n_steps: int
    block: torch.Tensor
    event: "torch.cuda.Event | None"
    timing: tuple | None = None
    host_ms: float | None = None
    captured: bool = False


@dataclasses.dataclass
class _SpecHandle:
    """A dispatched spec window: its outputs on the host once ``event``
    fired (``event`` is None on the CPU), and the worst-case advance
    per slot its dispatch reserved (:meth:`PagedKVCache.spec_window_caps`);
    ``captured`` as for :class:`_WindowHandle`."""

    caps: np.ndarray
    emitted: torch.Tensor
    counts: torch.Tensor
    pending: torch.Tensor
    event: "torch.cuda.Event | None"
    timing: tuple | None = None
    host_ms: float | None = None
    captured: bool = False


class PagedKVCache:
    """Host-side pool manager wrapping a :class:`PagedState`.

    ``slots`` is the batch dim of every step. Unused slots keep length 0
    and write only to the sink page. A page is on the free list (count
    0) or referenced by slot tables and registry pins (its count); the
    free list is the reference's (``list(range(P))[::-1]``, ``pop()``,
    an append when a count reaches 0), so one sequence of operations
    hands out the same page ids in both packages. The sink is never on
    the free list, counted, shared, swapped or copied. ``device`` is the
    card unless "cpu" is asked for.

    The device batch dim is ``bucket``: a power of two from
    ``min_bucket`` up, capped at ``slots`` (``min_bucket = 0`` pins it
    to ``slots``). Host bookkeeping and the arrays the caller passes are
    ``slots``-sized; a step, window or prefill runs over the bucket's
    first rows, and its outputs carry ``bucket`` rows.

    ``mesh`` (:data:`~kvedge_torch.parallel.mesh.NO_MESH` by default) is
    the rank's mesh when the cache serves a sharded model: under a
    ``model`` axis the pools hold this rank's ``K/tp`` K/V heads (and
    int8 scales) and every device function runs the rank's shard with
    the model-axis collectives (:func:`_paged_attend_layer`); under a
    ``stage`` axis of S they hold its ``L/S`` layers only, ``[L/S, P +
    1, page, K/tp, Dh]`` (the page count stays the whole model's
    derivation, so each rank's bytes shrink to 1/S); under an
    ``expert`` axis every rank holds the whole pool, as a data replica
    does. Params are then the rank's slices
    (``parallel/sharding.shard_params``).
    """

    def __init__(self, cfg: TransformerConfig, *, slots: int, pages: int,
                 page_size: int = 16, max_pages_per_seq: int | None = None,
                 kv_dtype: str = "", min_bucket: int = 0,
                 device: torch.device | str | None = None, mesh=NO_MESH):
        cfg.validate()
        warn_if_train_serve_divergence(cfg)
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_dtype must be '' (the compute dtype) or 'int8', "
                f"got {kv_dtype!r}"
            )
        if slots < 1 or pages < 1 or page_size < 1:
            raise ValueError("slots, pages and page_size must be >= 1")
        if min_bucket < 0:
            raise ValueError(f"min_bucket must be >= 0, got {min_bucket}")
        tp, stages = mesh.size("model"), mesh.size("stage")
        if tp > 1:
            check_shardable(cfg, tp)
        check_stages(cfg, stages)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.slots = slots
        self.min_bucket = min(min_bucket, slots) if min_bucket else 0
        self.bucket = self.bucket_for(0)
        self.bucket_steps = {"up": 0, "down": 0}
        self.num_pages = pages
        self.page_size = page_size
        self.max_pages_per_seq = (
            max_pages_per_seq or -(-cfg.max_seq // page_size)
        )
        self.kv_quantized = kv_dtype == "int8"
        dtype = torch.int8 if self.kv_quantized else torch_dtype(cfg.dtype)
        # One page past the pool: the sink (see the module docstring);
        # this rank's K/V heads under a model axis, its layers under a
        # stage axis.
        shape = (cfg.n_layers // stages, pages + 1, page_size,
                 cfg.kv_heads // tp, cfg.d_head)

        def scale():
            return (torch.zeros(shape[:-1], dtype=torch.float32,
                                device=self.device)
                    if self.kv_quantized else None)

        # Tables and lengths at [slots, ...]; the state holds their
        # bucket's [:bucket] views.
        self._tables_full = torch.zeros((slots, self.max_pages_per_seq),
                                        dtype=torch.int32, device=self.device)
        self._lengths_full = torch.zeros((slots,), dtype=torch.int32,
                                         device=self.device)
        self.state = PagedState(
            pool_k_full=torch.zeros(shape, dtype=dtype, device=self.device),
            pool_v_full=torch.zeros(shape, dtype=dtype, device=self.device),
            tables=self._tables_full[:self.bucket],
            lengths=self._lengths_full[:self.bucket],
            scale_k_full=scale(),
            scale_v_full=scale(),
        )
        self._free: list[int] = list(range(pages))[::-1]  # pop() -> lowest
        self._pages_of: dict[int, list[int]] = {}
        self._host_tables = [[0] * self.max_pages_per_seq
                             for _ in range(slots)]
        self._host_lengths = [0] * slots
        # Page reference counts: slot tables and registry pins
        # (retain_pages); a page returns to the free list at 0.
        self._refs = [0] * pages
        # The server's callback for an allocation that finds the free
        # list short: registry pins sit outside every reservation, so
        # pressure_relief(needed) -> bool reclaims them first.
        self.pressure_relief = None
        # The windows' inputs, written in place before each dispatch;
        # _idle_in (every row inactive) drives a graph's warm-up run,
        # which then writes only to the sink page.
        self._in = WindowInputs.zeros(slots, self.device)
        self._idle_in = WindowInputs.zeros(slots, self.device)
        # Host bytes of the last upload into each input buffer: rows that
        # repeat from window to window are not uploaded again.
        self._memo: dict[str, bytes] = {}
        # (static [W + 2, B] output, W) of the latest dispatch: the
        # device-resident carry that tokens=None reads.
        self._carry: tuple[torch.Tensor, int] | None = None
        # Captured graphs, each keyed by its bucket first: windows by
        # (bucket, sampled, W), spec windows by (bucket, sampled, P, K),
        # prefill chunks by (bucket, C).
        self._graphs: dict[tuple[int, bool, int], _Graph] = {}
        self._graph_params: dict | None = None
        self._capture_stream = None
        # Prefill chunks: static inputs per chunk length, and one memory
        # pool for all their graphs (they never run concurrently, and
        # each replay's logits are copied out before the next replay).
        self._prefill_in: dict[int, PrefillInputs] = {}
        self._prefill_graphs: dict[tuple[int, int], _Graph] = {}
        self._prefill_pool = None
        # Device seconds of graph replays, from CUDA events around each
        # ("decode": windows and spec windows; "prefill": chunks), and
        # the event pairs not yet read.
        self._device_s = {"decode": 0.0, "prefill": 0.0}
        self._timing: list = []
        # The event pair of the latest replay: the window or spec window
        # being dispatched takes it into its handle.
        self._last_timing: tuple | None = None
        # Whether that dispatch captured its graph first (the server
        # keeps such a window's round trip from the window controller).
        self._last_captured = False
        # The device ms of the window or spec window harvested last
        # (window_device_ms), for the server's histogram and controller.
        self.last_window_ms: float | None = None
        # Spec windows: their inputs (allocated at the first dispatch,
        # whose context width they take), the device carry (pending,
        # ctx, ctx_len: views of those inputs) of the latest dispatch,
        # their graphs by (sampled, n_passes, K), and the worst-case
        # tokens per slot that dispatched, unharvested spec windows
        # advance. While any are in flight the DEVICE lengths of their
        # slots run ahead of the host's by acceptance counts the host
        # learns at harvest, so _sync keeps them.
        self._spec_in: SpecWindowInputs | None = None
        self._spec_idle_in: SpecWindowInputs | None = None
        self._spec_carry: tuple | None = None
        self._spec_unharvested = [0] * slots
        self._spec_graphs: dict[tuple[int, bool, int, int], _Graph] = {}

    # ---- bucketed device batch dim ---------------------------------------

    def bucket_for(self, n: int) -> int:
        """The smallest bucket that holds ``n`` rows: powers of two from
        ``min_bucket`` up, capped at ``slots`` (the top bucket is
        ``slots`` itself even when that is not a power of two). With
        bucketing disabled the only bucket is ``slots``."""
        if not self.min_bucket:
            return self.slots
        b = self.min_bucket
        while b < n and b < self.slots:
            b *= 2
        return min(b, self.slots)

    def set_bucket(self, n: int) -> None:
        """Resize the device batch dim to bucket ``n``, at a quiescent
        point (the serving loop collapses its pipeline to a boundary
        first). Nothing moves on the device: the state takes the
        ``[:n]`` views of the tables and lengths, and the next dispatch
        replays bucket ``n``'s graphs. Any device carry is dropped (the
        pipeline restarts from host tokens)."""
        if n == self.bucket:
            return
        if not self.min_bucket:
            raise PagedCacheError(
                "bucketing is disabled on this cache (min_bucket=0); "
                "the device batch dim is pinned to slots"
            )
        if n != self.bucket_for(n) or n < self.min_bucket or n > self.slots:
            raise PagedCacheError(
                f"bucket {n} is not on this cache's ladder "
                f"(powers of two from {self.min_bucket} capped at "
                f"{self.slots})"
            )
        if any(self._spec_unharvested):
            raise PagedCacheError(
                "cannot resize the device batch dim with spec windows "
                "in flight — harvest them first (device lengths are "
                "data-dependent until then)"
            )
        top = max(self._pages_of, default=-1)
        if top >= n:
            raise PagedCacheError(
                f"slot {top} is admitted but bucket {n} holds rows "
                f"0..{n - 1} — release or migrate it first"
            )
        # The upload memo too: a smaller bucket's uploads rewrote rows
        # a larger bucket's memo would vouch for.
        self.drop_carry()
        self.bucket_steps["up" if n > self.bucket else "down"] += 1
        self.bucket = n
        self.state = dataclasses.replace(
            self.state, tables=self._tables_full[:n],
            lengths=self._lengths_full[:n])
        self._sync()

    # ---- control plane (host) -------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def quiescent(self) -> bool:
        """No device carry (plain or spec) and no unharvested spec
        reservation: nothing in flight reads the host state."""
        return (self._carry is None and self._spec_carry is None
                and not any(self._spec_unharvested))

    def rows_in_use(self) -> int:
        """1 + the highest admitted slot (0 when empty)."""
        return max(self._pages_of, default=-1) + 1

    def page_accounting(self) -> dict:
        """Full-pool page census: every page is on the free list (count
        0) or referenced (``live``). Conservation holds iff ``free + live
        == pages_total`` with no duplicate free entries, no negative
        count and no page both free and referenced."""
        free_set = set(self._free)
        return {
            "free": len(self._free),
            "live": sum(1 for r in self._refs if r > 0),
            "pages_total": self.num_pages,
            "spec_unharvested": sum(self._spec_unharvested),
            "free_dup": len(self._free) - len(free_set),
            "neg_refs": sum(1 for r in self._refs if r < 0),
            "free_live": sum(1 for p in free_set if self._refs[p] > 0),
        }

    def occupancy(self) -> dict:
        """Pool occupancy gauges; ``hbm_bytes_used`` prices live pages
        at the pool's per-page K+V bytes (scale slabs included for an
        int8 pool), the P pages only."""
        live = self.num_pages - len(self._free)
        st = self.state
        page_bytes = sum(
            t.nbytes // self.num_pages
            for t in (st.pool_k, st.pool_v, st.scale_k, st.scale_v)
            if t is not None)
        return {
            "pages_total": self.num_pages,
            "pages_live": live,
            "pages_free": len(self._free),
            "slots_admitted": len(self._pages_of),
            "bucket": self.bucket,
            "hbm_bytes_used": live * page_bytes,
        }

    def is_admitted(self, slot: int) -> bool:
        return slot in self._pages_of

    def slot_pages(self, slot: int) -> list[int]:
        """A copy of the slot's page list (registry pins must not alias
        the live allocation list)."""
        return list(self._pages_of[slot])

    def slot_length(self, slot: int) -> int:
        """The slot's committed host length: positions ``[0, length)``
        hold the K/V of prompt + generated (spec drafts write only at or
        past it), which makes finish-time registration exact."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        return self._host_lengths[slot]

    def page_refcount(self, page: int) -> int:
        return self._refs[page]

    def retain_pages(self, pages: list[int]) -> None:
        """Take an extra reference on ``pages`` (the prefix registry's
        pins)."""
        for page in pages:
            if self._refs[page] < 1:
                raise PagedCacheError(
                    f"page {page} is free — cannot retain K/V that no "
                    "longer exists"
                )
            self._refs[page] += 1

    def release_pages(self, pages: list[int]) -> None:
        """Drop a reference taken with :meth:`retain_pages`."""
        for page in pages:
            self._unref(page)

    def _unref(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] < 0:
            raise PagedCacheError(f"page {page} over-released")
        if self._refs[page] == 0:
            self._free.append(page)

    def _relieved(self, needed: int) -> bool:
        """At least ``needed`` free pages, after asking the server's
        ``pressure_relief`` when the free list is short."""
        return needed <= len(self._free) or bool(
            self.pressure_relief and self.pressure_relief(needed))

    def _take_page(self) -> int:
        page = self._free.pop()
        self._refs[page] += 1
        return page

    def admit(self, slot: int, prompt_len: int,
              shared_pages: tuple[int, ...] = ()) -> None:
        """Reserve the pages of a ``prompt_len``-token prompt in
        ``slot``. ``shared_pages`` (prefix sharing) start the table on
        already-written, read-only pages holding the prompt's cached
        prefix (counts bumped; prefill starts past them); only the rest
        comes from the free list."""
        if slot in self._pages_of:
            raise PagedCacheError(f"slot {slot} already admitted")
        if not 0 <= slot < self.slots:
            raise PagedCacheError(f"slot {slot} outside 0..{self.slots - 1}")
        if slot >= self.bucket:
            raise PagedCacheError(
                f"slot {slot} is outside the current device bucket "
                f"({self.bucket} rows) — step the bucket up first"
            )
        total = -(-prompt_len // self.page_size) or 1
        needed = total - len(shared_pages)
        if needed < 0:
            raise PagedCacheError(
                f"{len(shared_pages)} shared pages exceed the prompt's "
                f"{total}-page footprint"
            )
        if total > self.max_pages_per_seq:
            raise PagedCacheError(
                f"prompt of {prompt_len} needs {total} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        if not self._relieved(needed):
            raise PagedCacheError(
                f"pool exhausted: need {needed} pages, {len(self._free)} free"
            )
        self.retain_pages(list(shared_pages))
        pages = list(shared_pages) + [self._take_page()
                                      for _ in range(needed)]
        self._pages_of[slot] = pages
        row = self._host_tables[slot]
        for i, page in enumerate(pages):
            row[i] = page
        self._host_lengths[slot] = prompt_len
        self._sync()

    def grow(self, slot: int) -> bool:
        """Ensure the slot can hold one more token; True iff a page was
        allocated (the caller must :meth:`_sync` before the next step)."""
        return self.grow_to(slot, 1)

    def grow_to(self, slot: int, n: int) -> bool:
        """Ensure the slot can hold ``n`` more tokens, allocating pages as
        needed (inside the request's admission-time reservation, reclaiming
        registry pins through ``pressure_relief`` when the free list is
        short). True iff any page was allocated (caller must
        :meth:`_sync`)."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        length = self._host_lengths[slot]
        pages = self._pages_of[slot]
        grew = False
        while length + n > len(pages) * self.page_size:
            if len(pages) == self.max_pages_per_seq:
                raise PagedCacheError(f"slot {slot} hit max_pages_per_seq")
            if not self._relieved(1):
                raise PagedCacheError("pool exhausted mid-decode")
            page = self._take_page()
            pages.append(page)
            self._host_tables[slot][len(pages) - 1] = page
            grew = True
        return grew

    def release(self, slot: int) -> None:
        """Finish a sequence: drop its references (a page frees at 0)."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        for page in self._pages_of.pop(slot):
            self._unref(page)
        self._host_tables[slot] = [0] * self.max_pages_per_seq
        self._host_lengths[slot] = 0
        # Its device length drops to 0 even while other slots' spec
        # windows are in flight (_sync keeps only unharvested slots').
        self._spec_unharvested[slot] = 0
        self._sync()

    def allocate_pinned_page(self) -> int:
        """One page off the free list at count 1, owned by the caller
        (a registry pin no slot's reservation covers). Never invokes
        pressure relief."""
        if not self._free:
            raise PagedCacheError("pool exhausted: no page to pin")
        return self._take_page()

    def spec_pending(self) -> bool:
        """Any dispatched, unharvested spec window's reservation?"""
        return any(self._spec_unharvested)

    def _put(self, dst: torch.Tensor, host) -> None:
        """Copy host data into ``dst`` in place without waiting for the
        device: on CUDA through pinned memory, which the host allocator
        keeps until the copy has run, so the copy queues behind whatever
        window is in flight instead of waiting for it."""
        src = torch.as_tensor(host)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _sync(self) -> None:
        """Upload the host tables and lengths (after admit/grow/release)
        into the device tensors, in place (:meth:`_apply_sync`)."""
        self._apply_sync(np.asarray(self._host_tables, np.int32),
                         np.asarray(self._host_lengths, np.int32),
                         np.asarray(self._spec_unharvested) > 0)

    def _apply_sync(self, tables: np.ndarray, lengths: np.ndarray,
                    keep: np.ndarray) -> None:
        """Device seam of :meth:`_sync`. A slot ``keep`` marks (a spec
        window in flight) keeps its device length: the window advances
        it by counts the host learns only at harvest (the merge runs in
        stream order, after the windows already queued)."""
        self._put(self._tables_full, tables)
        full = self._lengths_full
        if not keep.any():
            self._put(full, lengths)
            return
        host = torch.empty_like(full)
        keep_dev = torch.empty(full.shape, dtype=torch.bool,
                               device=self.device)
        self._put(host, lengths)
        self._put(keep_dev, keep)
        full.copy_(torch.where(keep_dev, full, host))

    # ---- page copies (prefix sharing, swap, snapshots) -----------------

    def _slabs(self) -> list[torch.Tensor]:
        """The ``[L, P + 1, ...]`` slabs a page lives in: K and V, and the
        scale slabs of an int8 pool."""
        st = self.state
        out = [st.pool_k_full, st.pool_v_full]
        if st.scale_k_full is not None:
            out += [st.scale_k_full, st.scale_v_full]
        return out

    def _page_index(self, ids) -> torch.Tensor:
        ids = [int(p) for p in ids]
        if any(not 0 <= p < self.num_pages for p in ids):
            raise PagedCacheError(
                f"page ids {ids} outside 0..{self.num_pages - 1}")
        out = torch.empty((len(ids),), dtype=torch.int64, device=self.device)
        self._put(out, np.asarray(ids, np.int64))
        return out

    def snapshot_pages(self, ids: list[int]) -> tuple:
        """Device copies of pages ``ids`` AS STORED: ``(k, v)`` of
        ``[L, n, page, K, Dh]``, plus the fp32 scale slabs ``[L, n,
        page, K]`` for an int8 pool (a 4-tuple)."""
        idx = self._page_index(ids)
        return tuple(t.index_select(1, idx) for t in self._slabs())

    @staticmethod
    def snapshot_to_host(snapshot) -> tuple:
        """Host fp32 ``(k, v)`` from a :meth:`snapshot_pages` tuple,
        dequantized on the host for an int8 one."""
        if len(snapshot) == 2:
            return tuple(t.cpu().float() for t in snapshot)
        k, v, sk, sv = (t.cpu() for t in snapshot)
        return (k.float() * sk[..., None].float(),
                v.float() * sv[..., None].float())

    def read_pages(self, ids: list[int]) -> tuple:
        """Host fp32 ``(k, v)`` of pages ``ids`` (dequantized for an int8
        pool)."""
        return self.snapshot_to_host(self.snapshot_pages(ids))

    def write_pages(self, ids: list[int], k_vals, v_vals) -> None:
        """Write unquantized K/V ``[L, n, page, K, Dh]`` into pages
        ``ids`` (an int8 pool quantizes them per row); the caller owns
        the pages' counts."""
        idx = self._page_index(ids)
        vals = [torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                for v in (k_vals, v_vals)]
        st = self.state
        if self.kv_quantized:
            (k_q, k_s), (v_q, v_s) = (_kv_quantize(v) for v in vals)
            for dst, src in ((st.pool_k_full, k_q), (st.pool_v_full, v_q),
                             (st.scale_k_full, k_s), (st.scale_v_full, v_s)):
                dst.index_copy_(1, idx, src)
            return
        for dst, src in ((st.pool_k_full, vals[0]), (st.pool_v_full, vals[1])):
            dst.index_copy_(1, idx, src.to(dst.dtype))

    def swapout_pages(self, ids: list[int]) -> tuple:
        """Host copies of pages ``ids`` EXACTLY as the pool stores them
        (``(k, v)``, or a 4-tuple with the int8 pool's scale slabs): the
        preemption snapshot, and the prefix host tier's record. On CUDA
        the gather queues behind the work already on the stream (the
        only writers of these pages) and lands in pinned host tensors;
        the call returns once they are there."""
        return self._host_copy(self.snapshot_pages(ids))

    def _host_copy(self, snap: tuple) -> tuple:
        """Host copies of device snapshot tensors, waited for (pinned on
        CUDA)."""
        if self.device.type != "cuda":
            return snap  # index_select made fresh tensors
        out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in snap)
        for dst, src in zip(out, snap):
            dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return out

    def swapin_pages(self, ids: list[int], arrays: tuple) -> None:
        """Write a :meth:`swapout_pages` snapshot back into pages ``ids``
        (the caller owns their counts), verbatim: no dtype conversion in
        either direction."""
        want = 4 if self.kv_quantized else 2
        if len(arrays) != want:
            raise PagedCacheError(
                f"swap snapshot carries {len(arrays)} arrays; this "
                f"pool needs {want} "
                "(kv_dtype mismatch between swap-out and swap-in?)"
            )
        idx = self._page_index(ids)
        for dst, src in zip(self._slabs(), arrays):
            src = torch.as_tensor(src)
            if src.dtype != dst.dtype:
                raise PagedCacheError(
                    f"swap snapshot holds {src.dtype}, the pool "
                    f"{dst.dtype}")
            dst.index_copy_(1, idx, src.to(self.device, non_blocking=True))

    def cow_page(self, slot: int, index: int) -> int | None:
        """Copy-on-write for table position ``index`` of ``slot``: when
        the page there is shared (count > 1), copy it into a fresh page
        on the device and point only this slot's table at the copy, so
        the slot's writes cannot reach the other holders. Returns the
        new page id, or None when the slot holds the page alone. The
        copy is one ``index_copy_`` a slab on the current stream, before
        any later graph replay; no byte crosses the host."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        pages = self._pages_of[slot]
        if not 0 <= index < len(pages):
            raise PagedCacheError(
                f"slot {slot} holds {len(pages)} pages — no index {index}"
            )
        src = pages[index]
        if self._refs[src] <= 1:
            return None
        if not self._relieved(1):
            raise PagedCacheError("pool exhausted: no page for COW copy")
        dst = self._take_page()
        self._device_cow(src, dst)
        pages[index] = dst
        self._host_tables[slot][index] = dst
        self._unref(src)
        self._sync()
        return dst

    def _device_cow(self, src: int, dst: int) -> None:
        """Device seam of :meth:`cow_page`: page ``src`` copied into
        ``dst`` in every slab."""
        idx = self._page_index([src, dst])
        for slab in self._slabs():
            slab.index_copy_(1, idx[1:], slab.index_select(1, idx[:1]))

    # ---- device work -----------------------------------------------------

    def prefill(self, params: dict, slot: int, prompt) -> torch.Tensor:
        """Feed a whole 1D prompt into ``slot`` (after :meth:`admit`);
        returns the last position's logits ``[V]``."""
        prompt = self._tokens(prompt)
        if prompt.shape[0] != self._host_lengths[slot]:
            raise PagedCacheError(
                f"admit({slot}) reserved {self._host_lengths[slot]} "
                f"positions, prefill got {prompt.shape[0]}"
            )
        return self.prefill_chunk(params, slot, prompt, 0)

    def prefill_chunk(self, params: dict, slot: int, tokens,
                      offset: int) -> torch.Tensor:
        """Feed ``tokens`` into ``slot`` at absolute position ``offset``;
        returns the chunk's last-position logits ``[V]``, a tensor of the
        caller's own (a later chunk does not overwrite it).

        On CUDA it ALWAYS replays the graph of (bucket, chunk length),
        capturing it at first use (a failed capture raises); the tokens,
        slot and offset are uploaded into that length's
        :class:`PrefillInputs` first. On the CPU it runs eagerly."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.to(self.device, torch.int64)
        else:
            tokens = _host_ids(tokens)
        n = tokens.shape[0]
        if offset + n > self._host_lengths[slot]:
            raise PagedCacheError(
                f"chunk [{offset}, {offset + n}) exceeds slot {slot}'s "
                f"admitted length {self._host_lengths[slot]}"
            )
        return self._device_prefill_chunk(params, slot, tokens, offset)

    def _device_prefill_chunk(self, params: dict, slot: int, tokens,
                              offset: int) -> torch.Tensor:
        """Device seam of :meth:`prefill_chunk` (``tokens`` already a
        device tensor or host ids, the chunk's bounds checked)."""
        n = tokens.shape[0]
        if self.device.type != "cuda":
            return _paged_prefill(params, self.state, self._tokens(tokens),
                                  slot, self.cfg, offset, self.mesh)
        inp = self._prefill_in.get(n)
        if inp is None:
            inp = self._prefill_in[n] = PrefillInputs.zeros(n, self.device)
        # Every upload, never memoized: it is three small copies.
        if isinstance(tokens, torch.Tensor):
            inp.tokens.copy_(tokens)
        else:
            self._put(inp.tokens, tokens)
        self._put(inp.slot, np.asarray(slot, np.int64))
        self._put(inp.offset, np.asarray(offset, np.int64))
        # The warm-up run before a capture is this chunk itself: it
        # writes the very K/V the replay writes again, so running the
        # chunk twice changes nothing.
        out = self._replay(
            self._prefill_graphs, (self.bucket, n), params,
            lambda i: run_prefill(params, self.state, self.cfg, i, self.mesh),
            inp, inp, "prefill")
        # Every chunk of this length (another request's too) replays
        # into the same static logits: copy them out, in stream order.
        return out.clone()

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids as an int64 tensor on the cache's device, uploaded
        without waiting for the device."""
        if isinstance(tokens, torch.Tensor) and tokens.device == self.device:
            return tokens.to(torch.int64)
        host = _host_ids(tokens)
        out = torch.empty(host.shape, dtype=torch.int64, device=self.device)
        self._put(out, host)
        return out

    def _step_slots(self, active) -> list[int]:
        """Admitted slots this step advances: every admitted slot, or
        those the caller's ``active`` ([slots] bool) marks — a slot whose
        chunked prefill is still landing is admitted but not active."""
        if active is None:
            return sorted(self._pages_of)
        return [s for s in sorted(self._pages_of) if active[s]]

    def _row_mask(self, slots) -> np.ndarray:
        mask = np.zeros((self.slots,), bool)
        mask[slots] = True
        return mask

    def step(self, params: dict, tokens, active=None) -> torch.Tensor:
        """One batched decode step; ``tokens [slots]``; returns logits
        ``[bucket, V]`` (inactive rows' logits are garbage)."""
        slots = self._step_slots(active)
        grew = False
        for slot in slots:
            grew |= self.grow(slot)
        if grew:
            self._sync()
        logits = self._device_step(params, tokens, self._row_mask(slots))
        for slot in slots:
            self._host_lengths[slot] += 1
        return logits

    def _device_step(self, params: dict, tokens, mask: np.ndarray
                     ) -> torch.Tensor:
        """Device seam of :meth:`step`: one eager decode step of the
        bucket's rows, ``mask [slots]`` the live ones."""
        b = self.bucket
        live = torch.empty((b,), dtype=torch.bool, device=self.device)
        self._put(live, mask[:b])
        return _decode_step_core(params, self.state, self._tokens(tokens)[:b],
                                 self.cfg, live, self.mesh)

    def step_tokens(self, params: dict, tokens, active=None) -> torch.Tensor:
        """One batched GREEDY step returning next tokens ``[slots]``."""
        return torch.argmax(self.step(params, tokens, active), dim=-1)

    def step_window(self, params: dict, tokens, n_steps: int,
                    active=None) -> torch.Tensor:
        """``n_steps`` greedy steps with the argmax fed back on the
        device; returns tokens ``[n_steps, bucket]`` int64 on the host (row
        i was produced by feeding row i - 1; row 0 fed ``tokens``). The
        capped window with every row's cap at ``n_steps``."""
        block = self.harvest_window(
            self.dispatch_window(params, tokens, n_steps, active))
        return torch.from_numpy(block[:n_steps].astype(np.int64))

    def step_window_sampled(self, params: dict, tokens, n_steps: int, active,
                            key_data, base_steps, temps, top_ps,
                            sampled_mask) -> torch.Tensor:
        """``n_steps`` mixed greedy/sampled steps. Sampled row b's token
        at step i draws with ``fold_in(key_data[b], base_steps[b] + i)``
        through the nucleus filter; greedy rows take the argmax. All
        per-row inputs are host arrays of length ``slots``."""
        block = self.harvest_window(self.dispatch_window_sampled(
            params, tokens, n_steps, active, key_data, base_steps, temps,
            top_ps, sampled_mask))
        return torch.from_numpy(block[:n_steps].astype(np.int64))

    def step_spec(self, params: dict, tokens, active, spec_mask):
        """One speculative verify pass (:func:`_spec_verify_core`), run
        eagerly: the per-pass path.

        ``tokens [slots, 1+K]``; ``spec_mask [slots]`` marks the rows
        whose drafts may accept (greedy rows; sampled rows ride with
        acceptance 0 and their draft offsets written to the sink). A
        greedy row grows pages for the worst case, all K drafts accepted
        (the server reserves a speculative request's slack at
        admission); a sampled row grows one position, as a plain step.
        Returns ``(emitted [bucket, K+1] np.int64, accepted [bucket]
        np.int64, logits0 [bucket, V] on the device)``."""
        slots = self._step_slots(active)
        spec_np = np.asarray(spec_mask, bool)
        host_tokens = _host_ids(tokens)
        k_len = host_tokens.shape[1] - 1
        grew = False
        for slot in slots:
            grew |= self.grow_to(slot, (k_len + 1) if spec_np[slot] else 1)
        if grew:
            self._sync()
        emitted_np, accepted_np, logits0 = self._device_spec(
            params, host_tokens, self._row_mask(slots), spec_np)
        for slot in slots:
            self._host_lengths[slot] += 1 + int(accepted_np[slot])
        return emitted_np, accepted_np, logits0

    def _device_spec(self, params: dict, tokens: np.ndarray,
                     mask: np.ndarray, spec_mask: np.ndarray):
        """Device seam of :meth:`step_spec`: the verify pass over the
        bucket's rows, its emitted tokens and acceptances read back."""
        b = self.bucket
        live = torch.empty((b,), dtype=torch.bool, device=self.device)
        self._put(live, mask[:b])
        spec = torch.empty((b,), dtype=torch.bool, device=self.device)
        self._put(spec, spec_mask[:b])
        emitted, accepted, logits0 = _spec_verify_core(
            params, self.state, self._tokens(tokens[:b]), self.cfg,
            live, spec, self.mesh)
        host = torch.cat([emitted, accepted[:, None]], dim=1).cpu().numpy()
        return host[:, :-1], host[:, -1], logits0

    # ---- overlapped (double-buffered) windows ---------------------------

    def _window_caps(self, n_steps: int, steps_left) -> np.ndarray:
        if steps_left is None:
            return np.full((self.slots,), n_steps, np.int64)
        caps = np.minimum(np.asarray(steps_left, np.int64), n_steps)
        return np.maximum(caps, 0)

    def dispatch_window(self, params, tokens, n_steps: int, active=None,
                        steps_left=None, stop_tokens=None) -> _WindowHandle:
        """Enqueue a greedy decode window WITHOUT waiting for its result;
        :meth:`harvest_window` reads it. The device runs windows in
        order, so a second dispatch may be enqueued before the first is
        harvested; ``tokens=None`` feeds the previous dispatch's final
        token row (the device-resident carry).

        ``steps_left`` [slots] is each row's remaining decode budget
        (None = no cap): row b advances ``min(n_steps, steps_left[b])``
        steps and then freezes on the device (:func:`run_window`). Pages
        and host lengths advance by each row's TRUE advance, never the
        full window. ``stop_tokens`` [slots] (None = no stops) rides the
        window as per-row stop detection; the harvested block carries the
        ``[fin, stop_at]`` rows."""
        return self._dispatch(params, tokens, n_steps, active, steps_left,
                              stop_tokens, None)

    def dispatch_window_sampled(self, params, tokens, n_steps: int,
                                active, key_data, base_steps, temps,
                                top_ps, sampled_mask, steps_left=None,
                                stop_tokens=None) -> _WindowHandle:
        """Mixed greedy/sampled :meth:`dispatch_window` (same carry,
        cap, growth and stop discipline; sampling inputs as in
        :meth:`step_window_sampled`)."""
        sampling = {
            "key_data": np.asarray(key_data, np.uint32).astype(np.int64),
            "base_steps": np.asarray(base_steps, np.int64),
            "temps": np.asarray(temps, np.float32),
            "top_ps": np.asarray(top_ps, np.float32),
            "sampled_mask": np.asarray(sampled_mask, bool),
        }
        return self._dispatch(params, tokens, n_steps, active, steps_left,
                              stop_tokens, sampling)

    def _dispatch(self, params, tokens, n_steps, active, steps_left,
                  stop_tokens, sampling) -> _WindowHandle:
        if n_steps < 1:
            raise ValueError("a window runs n_steps >= 1 steps")
        if tokens is None and self._carry is None:
            raise PagedCacheError(
                "no window in flight to carry tokens from — the first "
                "window of a pipeline must pass explicit tokens"
            )
        slots = self._step_slots(active)
        caps = self._window_caps(n_steps, steps_left)
        grew = False
        for slot in slots:
            if caps[slot] > 0:
                grew |= self.grow_to(slot, int(caps[slot]))
        if grew:
            self._sync()
        if stop_tokens is None:
            stop_tokens = np.full((self.slots,), -1, np.int64)
        handle = self._device_window_dispatch(
            params, tokens, n_steps, self._row_mask(slots), caps,
            np.asarray(stop_tokens, np.int64), sampling)
        for slot in slots:
            self._host_lengths[slot] += int(caps[slot])
        return handle

    def harvest_window(self, handle: _WindowHandle) -> np.ndarray:
        """The dispatched window's ``[n_steps + 2, bucket]`` int32 block:
        the produced tokens plus the ``[fin, stop_at]`` rows. Waits for
        that window only — ideally while a later one already runs."""
        if handle.event is not None:
            handle.event.synchronize()
        self.last_window_ms = self.window_device_ms(handle)
        return handle.block.numpy().copy()

    def wait_device(self) -> None:
        """Block until the device has finished everything queued on any
        stream (the capture stream included). On CUDA a device left
        unusable by an earlier fault (an illegal address, a device-side
        assert) raises here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def drop_carry(self) -> None:
        """Forget the device-resident carries, plain and spec (a pipeline
        restarts from host tokens), every unharvested spec reservation
        (the host lengths are authoritative again) and the upload
        memo."""
        self._carry = None
        self._spec_carry = None
        self._spec_unharvested = [0] * self.slots
        self._memo.clear()

    def _upload(self, name: str, host: np.ndarray,
                inputs: "WindowInputs | SpecWindowInputs | None" = None
                ) -> None:
        """Write one window input in place (into ``inputs``, the plain
        window's by default), unless it holds these bytes already."""
        inputs = self._in if inputs is None else inputs
        key = host.tobytes()
        memo = (id(inputs), name)
        if self._memo.get(memo) == key:
            return
        self._put(getattr(inputs, name), host)
        self._memo[memo] = key

    def _device_window_dispatch(self, params, tokens, n_steps: int,
                                active, caps, stop_tokens,
                                sampling) -> _WindowHandle:
        """Device seam: write the window's inputs, run it, and enqueue the
        copy of its block to the host (no wait)."""
        if tokens is None:
            carry_out, carry_n = self._carry
            self._in.tokens[:self.bucket].copy_(carry_out[carry_n - 1])
        else:
            self._put(self._in.tokens, _host_ids(tokens))
        self._upload("active", active)
        self._upload("steps_left", caps)
        self._upload("stop_tokens", stop_tokens)
        for name, host in (sampling or {}).items():
            self._upload(name, host)
        self._last_timing = None
        self._last_captured = False
        t0 = time.perf_counter()
        out = self._run_device_window(params, n_steps, sampling is not None)
        run_ms = (time.perf_counter() - t0) * 1e3
        self._carry = (out, n_steps)
        if out.is_cuda:
            # Both in-flight windows of one W share the graph's static
            # output: copy this one's out before the next replay.
            block = out.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _WindowHandle(n_steps, block, event, self._last_timing,
                                 captured=self._last_captured)
        return _WindowHandle(n_steps, out, None, host_ms=run_ms)

    def _run_device_window(self, params, n_steps: int,
                           sampled: bool) -> torch.Tensor:
        """Device seam: one window over the current inputs, returning its
        ``[n_steps + 2, bucket]`` block on the device. On CUDA it ALWAYS
        replays the captured graph of (bucket, greedy | sampled, W)
        (capturing it at first use; a failed capture raises); on the CPU
        it runs eagerly."""
        b = self.bucket
        if self.device.type != "cuda":
            return run_window(params, self.state, self.cfg,
                              _rows(self._in, b), n_steps, sampled,
                              self.mesh)
        return self._replay(self._graphs, (b, sampled, n_steps), params,
                            lambda inp: run_window(
                                params, self.state, self.cfg, inp, n_steps,
                                sampled, self.mesh),
                            _rows(self._in, b), _rows(self._idle_in, b),
                            "decode")

    def _replay(self, graphs: dict, key, params, run, inputs, idle,
                kind: str):
        """Replay the graph ``graphs[key]`` of ``run(inputs)``, capturing
        it first if it is not there, between two CUDA events whose
        interval adds to the ``kind`` device seconds; returns its static
        output."""
        if params is not self._graph_params:
            # A graph holds the addresses of the params it was captured
            # with.
            self._graphs.clear()
            self._spec_graphs.clear()
            self._prefill_graphs.clear()
            self._graph_params = params
        graph = graphs.get(key)
        if graph is None:
            graph = self._capture(run, inputs, idle,
                                  graphs is self._prefill_graphs)
            graphs[key] = graph
            self._last_captured = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.graph.replay()
        end.record()
        self._timing.append((kind, start, end))
        self._last_timing = (start, end)
        self._settle_timing(block=False)
        paged_decode_attention.launches += graph.b1_launches
        return graph.out

    def _settle_timing(self, block: bool) -> None:
        """Add the intervals of the replays the device has finished (all
        of them, waiting, with ``block``) to the device seconds."""
        while self._timing:
            kind, start, end = self._timing[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._device_s[kind] += start.elapsed_time(end) / 1e3
            self._timing.pop(0)

    @staticmethod
    def window_device_ms(handle: "_WindowHandle | _SpecHandle"
                         ) -> float | None:
        """A harvested window's device milliseconds, with no sync of its
        own: on the card the interval of the CUDA events around its graph
        replay, which has retired once the harvest waited (None while it
        has not, or for a window run outside a graph); on the CPU, where
        the window runs eagerly inside its dispatch, the host time of
        that run."""
        if handle.timing is not None:
            start, end = handle.timing
            return start.elapsed_time(end) if end.query() else None
        return handle.host_ms

    def device_seconds(self, wait: bool = True) -> dict:
        """Device seconds of the graph replays so far: ``{"decode":
        windows and spec windows, "prefill": chunks}``, waiting for the
        replays in flight (without ``wait``, those still running are left
        for a later call). Eager runs (the CPU, a single step, a per-pass
        verify) add nothing."""
        self._settle_timing(block=wait)
        return dict(self._device_s)

    def _capture(self, run, inputs, idle, prefill: bool = False) -> _Graph:
        """Capture ``run(inputs)`` as a CUDA graph. It runs once eagerly
        first on the capture stream over ``idle`` (every row inactive, so
        it writes only to the sink page; a prefill chunk's own inputs,
        whose writes the replay repeats), to warm kernel builds, library
        handles and the allocator. The caller holds the lock every other
        device launch takes, so nothing else launches during the
        capture. A prefill graph allocates from the prefill graphs'
        shared pool."""
        t0 = time.perf_counter()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            run(idle)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        pool = None
        if prefill:
            if self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            pool = self._prefill_pool
        graph = torch.cuda.CUDAGraph()
        before = paged_decode_attention.launches
        # No cyclic garbage collection during the capture: a graph held
        # in a reference cycle (a closed server and its cache hold each
        # other) would be destroyed there, which CUDA refuses while a
        # stream captures, and the capture is invalidated.
        collecting = gc.isenabled()
        gc.disable()
        caller_stream = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = run(inputs)
        except BaseException:
            # A failed capture stores no graph (the caller keeps nothing)
            # and its B1 count is dropped; when the capture's end itself
            # raises, torch leaves the capture stream current: restore
            # the caller's.
            paged_decode_attention.launches = before
            torch.cuda.set_stream(caller_stream)
            raise
        finally:
            if collecting:
                gc.enable()
        # The capture launched nothing: its count moves to each replay.
        captured = paged_decode_attention.launches - before
        paged_decode_attention.launches = before
        return _Graph(graph, out, captured, time.perf_counter() - t0)

    # ---- speculative windows (device-resident draft + verify passes) ----

    @staticmethod
    def spec_window_caps(n_passes: int, k_len: int, budgets,
                         sampled_mask=None) -> np.ndarray:
        """Worst-case token advance per slot of ONE spec window: a row
        runs passes while its budget is positive, each advancing 1 +
        accepted <= 1 + K, so the last pass may overshoot the budget by
        up to K. Pages and ``_spec_unharvested`` reserve this bound; the
        true advance is known at harvest. A sampled row advances exactly
        one token a live pass, so its cap is exact: ``min(budget,
        n_passes)`` (the server prices the next window's ``base_steps``
        off it)."""
        budgets_np = np.maximum(np.asarray(budgets, np.int64), 0)
        caps = np.minimum(budgets_np + k_len, n_passes * (k_len + 1))
        if sampled_mask is not None:
            caps = np.where(np.asarray(sampled_mask, bool),
                            np.minimum(budgets_np, n_passes), caps)
        return np.where(budgets_np > 0, caps, 0).astype(np.int32)

    def dispatch_spec_window(self, params, tokens, n_passes: int,
                             k_len: int, budgets, active=None, ctx=None,
                             ctx_len=None, sampling=None) -> _SpecHandle:
        """Enqueue ``n_passes`` speculative draft + verify passes
        (:func:`run_spec_window`) WITHOUT waiting for their result;
        :meth:`harvest_spec_window` reads it. ``budgets[b] > 0`` marks
        the participants.

        The first window of a pipeline passes ``tokens [slots]`` (each
        row's pending token) and its drafting context ``ctx [slots,
        S_ctx]`` / ``ctx_len [slots]`` (prompt + generated + pending);
        later ones pass ``tokens=None`` and ride the device carry, so
        pending tokens and contexts never visit the host between windows.
        ``sampling = (key_data, base_steps, temps, top_ps, sampled_mask)``
        runs the mixed greedy/sampled window. Pages and
        ``_spec_unharvested`` reserve the worst case
        (:meth:`spec_window_caps`); host lengths advance at harvest, by
        the true counts."""
        if n_passes < 1 or k_len < 1:
            raise ValueError("a spec window runs n_passes >= 1 passes of "
                             "k_len >= 1 drafts")
        slots = self._step_slots(active)
        sampled_mask = sampling[4] if sampling is not None else None
        caps = self.spec_window_caps(n_passes, k_len, budgets, sampled_mask)
        budgets_np = np.maximum(np.asarray(budgets, np.int64), 0)
        grew = False
        for slot in slots:
            if caps[slot] > 0:
                grew |= self.grow_to(
                    slot, self._spec_unharvested[slot] + int(caps[slot]))
        if grew:
            self._sync()
        if tokens is None:
            if self._spec_carry is None:
                raise PagedCacheError(
                    "no spec window in flight to carry from — the first "
                    "spec window of a pipeline must pass explicit tokens "
                    "and drafting context"
                )
        elif ctx is None or ctx_len is None:
            raise PagedCacheError(
                "a spec window dispatched from host tokens needs its "
                "drafting context (ctx, ctx_len)"
            )
        handle = self._device_spec_window(
            params, tokens, n_passes, k_len, self._row_mask(slots),
            budgets_np, ctx, ctx_len, sampling, caps)
        for slot in slots:
            if caps[slot] > 0:
                self._spec_unharvested[slot] += int(caps[slot])
        return handle

    def _spec_inputs(self, s_ctx: int) -> SpecWindowInputs:
        """The spec windows' inputs for a context of ``s_ctx`` columns
        (one more, the sink): allocated at the first dispatch, and again
        (dropping the spec graphs that read the old ones) if the width
        changes."""
        if self._spec_in is None or self._spec_in.ctx.shape[1] != s_ctx + 1:
            self._spec_in = SpecWindowInputs.zeros(self.slots, s_ctx,
                                                   self.device)
            self._spec_idle_in = SpecWindowInputs.zeros(self.slots, s_ctx,
                                                        self.device)
            self._spec_graphs.clear()
            self._spec_carry = None
            self._memo.clear()
        return self._spec_in

    def _device_spec_window(self, params, tokens, n_passes: int,
                            k_len: int, active, budgets, ctx, ctx_len,
                            sampling, caps) -> _SpecHandle:
        """Device seam: write the spec window's inputs (from the host, or
        nothing but budgets and sampling rows on the carry), run it, and
        enqueue the copy of its outputs to the host (no wait)."""
        if tokens is None:
            inp = self._spec_in
        else:
            host_ctx = _host_ids(ctx)
            inp = self._spec_inputs(host_ctx.shape[1])
            # The sink column rides along as zeros.
            padded = np.zeros((self.slots, host_ctx.shape[1] + 1), np.int64)
            padded[:, :-1] = host_ctx
            self._put(inp.pending, _host_ids(tokens))
            self._put(inp.ctx, padded)
            self._put(inp.ctx_len, _host_ids(ctx_len))
        self._upload("active", np.asarray(active, bool), inp)
        self._upload("budgets", np.asarray(budgets, np.int64), inp)
        if sampling is not None:
            key_data, base_steps, temps, top_ps, sampled_mask = sampling
            for name, host in (
                    ("key_data",
                     np.asarray(key_data, np.uint32).astype(np.int64)),
                    ("base_steps", np.asarray(base_steps, np.int64)),
                    ("temps", np.asarray(temps, np.float32)),
                    ("top_ps", np.asarray(top_ps, np.float32)),
                    ("sampled_mask", np.asarray(sampled_mask, bool))):
                self._upload(name, host, inp)
        self._last_timing = None
        self._last_captured = False
        t0 = time.perf_counter()
        emitted, counts, pending = self._run_device_spec_window(
            params, n_passes, k_len, sampling is not None)
        run_ms = (time.perf_counter() - t0) * 1e3
        b = self.bucket
        self._spec_carry = (inp.pending[:b], inp.ctx[:b], inp.ctx_len[:b])
        if emitted.is_cuda:
            # Two windows in flight share the graph's static outputs:
            # copy this one's before the next replay.
            outs = [t.to("cpu", non_blocking=True)
                    for t in (emitted, counts, pending)]
            event = torch.cuda.Event()
            event.record()
            return _SpecHandle(caps, *outs, event, self._last_timing,
                               captured=self._last_captured)
        return _SpecHandle(caps, emitted, counts, pending, None,
                           host_ms=run_ms)

    def _run_device_spec_window(self, params, n_passes: int, k_len: int,
                                sampled: bool):
        """Device seam: one spec window over the current spec inputs,
        returning ``(emitted, counts, pending)`` on the device. On CUDA
        it ALWAYS replays the captured graph of (greedy | sampled,
        n_passes, K) at this bucket, capturing it at first use (a
        failed capture raises); on the CPU it runs eagerly."""
        b = self.bucket
        if self.device.type != "cuda":
            return run_spec_window(params, self.state, self.cfg,
                                   _rows(self._spec_in, b), n_passes, k_len,
                                   sampled, self.mesh)
        return self._replay(self._spec_graphs,
                            (b, sampled, n_passes, k_len), params,
                            lambda inp: run_spec_window(
                                params, self.state, self.cfg, inp,
                                n_passes, k_len, sampled, self.mesh),
                            _rows(self._spec_in, b),
                            _rows(self._spec_idle_in, b), "decode")

    def harvest_spec_window(self, handle: _SpecHandle):
        """Wait for a dispatched spec window and settle what its dispatch
        could only bound: host lengths advance by each slot's true
        advance (the sum of its counts) and the worst-case reservation is
        returned. Returns ``(emitted [n_passes, bucket, K+1], counts
        [n_passes, bucket], pending [bucket])`` as numpy."""
        if handle.event is not None:
            handle.event.synchronize()
        self.last_window_ms = self.window_device_ms(handle)
        emitted = handle.emitted.numpy().copy()
        counts = handle.counts.numpy().copy()
        pending = handle.pending.numpy().copy()
        caps = handle.caps
        for slot in range(len(caps)):
            # A slot released (and perhaps re-admitted) while its window
            # was in flight had its reservation zeroed already; settling
            # here would resurrect it.
            if (caps[slot] > 0 and slot in self._pages_of
                    and self._spec_unharvested[slot] >= int(caps[slot])):
                self._host_lengths[slot] += int(counts[:, slot].sum())
                self._spec_unharvested[slot] -= int(caps[slot])
        return emitted, counts, pending

    def graph_stats(self) -> dict:
        """Captured graphs: the plain windows' count, the seconds spent
        capturing them (warm-up runs included) and the B1 launches each
        replay makes, by "greedy/W" or "sampled/W" (the same at every
        bucket); the spec windows' apart, by "greedy/P/K" or
        "sampled/P/K"; the prefill chunks' apart, with the chunk lengths
        captured; and each bucket's graphs and capture seconds, by
        kind, under ``per_bucket``."""
        def kind(sampled):
            return "sampled" if sampled else "greedy"

        def seconds(graphs):
            return sum(g.capture_s for g in graphs.values())

        per_bucket: dict = {}
        for label, graphs in (("window", self._graphs),
                              ("spec", self._spec_graphs),
                              ("prefill", self._prefill_graphs)):
            for key, g in graphs.items():
                doc = per_bucket.setdefault(key[0], {
                    f"{k}_{f}": 0 for k in ("window", "spec", "prefill")
                    for f in ("graphs", "capture_s")})
                doc[f"{label}_graphs"] += 1
                doc[f"{label}_capture_s"] += g.capture_s
                if label != "prefill":
                    doc.setdefault("b1_launches_per_replay", {})[
                        "/".join(str(k) for k in (kind(key[1]), *key[2:]))
                    ] = g.b1_launches
        return {
            "graphs": len(self._graphs),
            "capture_s": seconds(self._graphs),
            "b1_launches_per_replay": {
                f"{kind(s)}/{w}": g.b1_launches
                for (_, s, w), g in sorted(self._graphs.items())},
            "spec_graphs": len(self._spec_graphs),
            "spec_capture_s": seconds(self._spec_graphs),
            "spec_b1_launches_per_replay": {
                f"{kind(s)}/{p}/{k}": g.b1_launches
                for (_, s, p, k), g in sorted(self._spec_graphs.items())},
            "prefill_graphs": len(self._prefill_graphs),
            "prefill_capture_s": seconds(self._prefill_graphs),
            "prefill_lengths": sorted({n for _, n in self._prefill_graphs}),
            "per_bucket": {b: per_bucket[b] for b in sorted(per_bucket)},
        }
