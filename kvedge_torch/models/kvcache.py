"""Paged KV cache: fixed-size pages and block tables for ragged serving.

The counterpart of the JAX package's ``models/kvcache.py`` for the
serving slice. K/V live in pages of a pool ``[L, P, page, K, Dh]``; each
sequence owns an ordered block table of page ids. The host class
:class:`PagedKVCache` keeps the reference's method names and semantics
(``admit``/``grow``/``grow_to``/``release``, ``prefill_chunk``, ``step``,
``step_tokens``, ``step_window``, ``step_window_sampled``); the device
functions below it keep its math.

Differences that are the port's, not the reference's:

* The reference's programs donate the pools and return new ones; the
  port writes K/V into the pools IN PLACE.
* The reference routes inactive rows' scatters out of bounds and drops
  them (``mode="drop"``). Torch has no drop mode, so the port scatters
  only the rows the host marks active (an index tensor built once per
  step or window): an inactive row never writes anywhere, in particular
  never into page 0, which a zeroed table row would alias.
* A window of W decode steps is a Python loop of the step; the greedy
  (or sampled) pick feeds back on the device, and the host reads the
  ``[W, slots]`` tokens once at the end.
* Single-query decode attention goes through ``ops/paged_attention.py``
  when ``cfg.paged_attention`` picks the kernel ("auto" on CUDA, or
  "kernel"); prefill keeps the plain gather math on every device, as the
  reference keeps its einsum path there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.sampling import as_key_tensor, fold_in, sample_token
from kvedge_torch.models.transformer import (
    _rmsnorm,
    _rotary,
    mlp,
    split_qkv,
    stacked_layer_params,
    tied_readout,
    torch_dtype,
)
from kvedge_torch.ops.paged_attention import (
    gather_attention,
    gather_pages,
    paged_decode_attention,
)


@dataclasses.dataclass
class PagedState:
    """Device-side paged cache state (host policy lives in
    :class:`PagedKVCache`). ``scale_k``/``scale_v`` (``[L, P, page, K]``
    fp32) exist only for an int8 pool: one scale per token row and kv
    head, with the pools holding ``round(x / scale)`` int8."""

    pool_k: torch.Tensor    # [L, P, page, K, Dh]
    pool_v: torch.Tensor    # [L, P, page, K, Dh]
    tables: torch.Tensor    # [B, max_pages] int32 page ids
    lengths: torch.Tensor   # [B] int32 valid positions per sequence
    scale_k: torch.Tensor | None = None
    scale_v: torch.Tensor | None = None


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
    of ``pool [P, page, K, Dh]`` in place, quantizing for an int8 pool."""
    if scales is not None:
        rows_kv, row_scale = _kv_quantize(rows_kv)
        scales[page_idx, offset] = row_scale
    pool[page_idx, offset] = rows_kv


def _scatter_token(pool, scales, tables, lengths, kv_new, rows):
    """Write one ``[B, K, Dh]`` token row per sequence listed in ``rows``
    (int64 indices) at position ``lengths[b]`` of its pages: page
    ``tables[b, lengths[b] // page]``, offset ``lengths[b] % page``.
    Rows not listed write nothing."""
    page = pool.shape[1]
    pos = lengths[rows].long()
    page_idx = tables[rows, pos // page].long()
    _write_rows(pool, scales, page_idx, pos % page, kv_new[rows])


def _paged_attend_layer(cfg: TransformerConfig, state: PagedState, x,
                        layer_params, layer: int, q_positions, slot=None,
                        rows=None):
    """One block over the paged cache. x ``[B, Q, D]``; q_positions
    ``[B, Q]`` absolute positions of the new tokens. ``slot`` set = the
    prefill of one sequence (B == 1, Q tokens); otherwise a decode step
    (Q == 1) whose K/V are written for ``rows`` only."""
    w_qkv, w_out, w_up, w_down, ln_attn, ln_mlp = layer_params
    batch, q_len, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    pool_k, pool_v = state.pool_k[layer], state.pool_v[layer]
    scale_k = state.scale_k[layer] if state.scale_k is not None else None
    scale_v = state.scale_v[layer] if state.scale_v is not None else None

    q, k, v = split_qkv(cfg, _rmsnorm(x, ln_attn) @ w_qkv)
    # Decode rows each carry their own position; a prefill shares one.
    positions = q_positions if slot is None else q_positions[0]
    q = _rotary(q, positions)
    k = _rotary(k, positions)

    if slot is None:
        tables = state.tables
        _scatter_token(pool_k, scale_k, tables, state.lengths, k[:, 0], rows)
        _scatter_token(pool_v, scale_v, tables, state.lengths, v[:, 0], rows)
    else:
        tables = state.tables[slot][None]
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
    x = x + att.reshape(batch, q_len, h * dh) @ w_out
    return mlp(x, w_up, w_down, ln_mlp)


def _run_paged(cfg, params, state, x, q_positions, slot=None, rows=None):
    stacked = stacked_layer_params(params, cfg)
    for layer in range(cfg.n_layers):
        x = _paged_attend_layer(cfg, state, x,
                                tuple(p[layer] for p in stacked), layer,
                                q_positions, slot, rows)
    x = _rmsnorm(x, params["ln_final"])
    return tied_readout(x[:, -1], params["embedding"])


@torch.no_grad()
def _paged_prefill(params: dict, state: PagedState, tokens, slot: int,
                   cfg: TransformerConfig, offset: int = 0) -> torch.Tensor:
    """Prefill ``tokens [T]`` into ``slot`` at positions offset..;
    returns the last position's logits ``[V]``."""
    x = params["embedding"][tokens][None]
    q_positions = (offset + torch.arange(tokens.shape[0],
                                         device=tokens.device))[None]
    return _run_paged(cfg, params, state, x, q_positions, slot=slot)[0]


@torch.no_grad()
def _decode_step_core(params: dict, state: PagedState, tokens,
                      cfg: TransformerConfig, rows, active) -> torch.Tensor:
    """One batched decode step: ``tokens [B]`` in, logits ``[B, V]`` out.
    ``rows`` (int64 indices) are the rows whose K/V are written and
    whose lengths advance; ``active`` is the same set as a ``[B]`` bool.
    Shared by the single step and the windows, so the two agree token
    for token."""
    x = params["embedding"][tokens][:, None]
    logits = _run_paged(cfg, params, state, x, state.lengths[:, None],
                        rows=rows)
    state.lengths += active.to(state.lengths.dtype)
    return logits


class PagedKVCache:
    """Host-side pool manager wrapping a :class:`PagedState`.

    ``slots`` is the batch dim of every step. Unused slots keep length 0
    and write nothing. Every page has one owner (this slice shares no
    pages), so a page is either on the free list or in one slot's table.
    """

    def __init__(self, cfg: TransformerConfig, *, slots: int, pages: int,
                 page_size: int = 16, max_pages_per_seq: int | None = None,
                 kv_dtype: str = "", device: torch.device | str = "cpu"):
        cfg.validate()
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_dtype must be '' (the compute dtype) or 'int8', "
                f"got {kv_dtype!r}"
            )
        if slots < 1 or pages < 1 or page_size < 1:
            raise ValueError("slots, pages and page_size must be >= 1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.slots = slots
        self.num_pages = pages
        self.page_size = page_size
        self.max_pages_per_seq = (
            max_pages_per_seq or -(-cfg.max_seq // page_size)
        )
        self.kv_quantized = kv_dtype == "int8"
        dtype = torch.int8 if self.kv_quantized else torch_dtype(cfg.dtype)
        shape = (cfg.n_layers, pages, page_size, cfg.kv_heads, cfg.d_head)

        def scale():
            return (torch.zeros(shape[:-1], dtype=torch.float32,
                                device=self.device)
                    if self.kv_quantized else None)

        self.state = PagedState(
            pool_k=torch.zeros(shape, dtype=dtype, device=self.device),
            pool_v=torch.zeros(shape, dtype=dtype, device=self.device),
            tables=torch.zeros((slots, self.max_pages_per_seq),
                               dtype=torch.int32, device=self.device),
            lengths=torch.zeros((slots,), dtype=torch.int32,
                                device=self.device),
            scale_k=scale(),
            scale_v=scale(),
        )
        self._free: list[int] = list(range(pages))[::-1]  # pop() -> lowest
        self._pages_of: dict[int, list[int]] = {}
        self._host_tables = [[0] * self.max_pages_per_seq
                             for _ in range(slots)]
        self._host_lengths = [0] * slots

    # ---- control plane (host) -------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def page_accounting(self) -> dict:
        """Full-pool page census: conservation holds iff
        ``free + live == pages_total`` with no duplicate free entries and
        no page both free and owned."""
        free_set = set(self._free)
        owned = [p for pages in self._pages_of.values() for p in pages]
        return {
            "free": len(self._free),
            "live": len(set(owned)),
            "pages_total": self.num_pages,
            "free_dup": len(self._free) - len(free_set),
            "owned_dup": len(owned) - len(set(owned)),
            "free_live": len(free_set.intersection(owned)),
        }

    def is_admitted(self, slot: int) -> bool:
        return slot in self._pages_of

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._pages_of[slot])

    def admit(self, slot: int, prompt_len: int) -> None:
        """Reserve the pages of a ``prompt_len``-token prompt in ``slot``."""
        if slot in self._pages_of:
            raise PagedCacheError(f"slot {slot} already admitted")
        if not 0 <= slot < self.slots:
            raise PagedCacheError(f"slot {slot} outside 0..{self.slots - 1}")
        needed = -(-prompt_len // self.page_size) or 1
        if needed > self.max_pages_per_seq:
            raise PagedCacheError(
                f"prompt of {prompt_len} needs {needed} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        if needed > len(self._free):
            raise PagedCacheError(
                f"pool exhausted: need {needed} pages, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(needed)]
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
        needed (inside the request's admission-time reservation). True
        iff any page was allocated (caller must :meth:`_sync`)."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        length = self._host_lengths[slot]
        pages = self._pages_of[slot]
        grew = False
        while length + n > len(pages) * self.page_size:
            if len(pages) == self.max_pages_per_seq:
                raise PagedCacheError(f"slot {slot} hit max_pages_per_seq")
            if not self._free:
                raise PagedCacheError("pool exhausted mid-decode")
            page = self._free.pop()
            pages.append(page)
            self._host_tables[slot][len(pages) - 1] = page
            grew = True
        return grew

    def release(self, slot: int) -> None:
        """Finish a sequence: its pages return to the free list."""
        if slot not in self._pages_of:
            raise PagedCacheError(f"slot {slot} is not admitted")
        self._free.extend(self._pages_of.pop(slot))
        self._host_tables[slot] = [0] * self.max_pages_per_seq
        self._host_lengths[slot] = 0
        self._sync()

    def _sync(self) -> None:
        """Upload the host tables and lengths (after admit/grow/release)."""
        self.state.tables = torch.tensor(self._host_tables, dtype=torch.int32,
                                         device=self.device)
        self.state.lengths = torch.tensor(self._host_lengths,
                                          dtype=torch.int32,
                                          device=self.device)

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
        returns the chunk's last-position logits ``[V]``."""
        tokens = self._tokens(tokens)
        n = tokens.shape[0]
        if offset + n > self._host_lengths[slot]:
            raise PagedCacheError(
                f"chunk [{offset}, {offset + n}) exceeds slot {slot}'s "
                f"admitted length {self._host_lengths[slot]}"
            )
        return _paged_prefill(params, self.state, tokens, slot, self.cfg,
                              offset)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    def _step_slots(self, active) -> list[int]:
        """Admitted slots this step advances: every admitted slot, or
        those the caller's ``active`` ([slots] bool) marks — a slot whose
        chunked prefill is still landing is admitted but not active."""
        if active is None:
            return sorted(self._pages_of)
        return [s for s in sorted(self._pages_of) if active[s]]

    def _prepare(self, active, n_steps: int):
        """Grow every stepping slot by ``n_steps`` tokens and build the
        device row set: (slots, rows int64, active bool)."""
        slots = self._step_slots(active)
        grew = False
        for slot in slots:
            grew |= self.grow_to(slot, n_steps)
        if grew:
            self._sync()
        mask = np.zeros((self.slots,), bool)
        mask[slots] = True
        rows = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        return slots, rows, torch.as_tensor(mask, device=self.device)

    def _advance(self, slots, n_steps: int) -> None:
        for slot in slots:
            self._host_lengths[slot] += n_steps

    def step(self, params: dict, tokens, active=None) -> torch.Tensor:
        """One batched decode step; ``tokens [slots]``; returns logits
        ``[slots, V]`` (inactive rows' logits are garbage)."""
        slots, rows, mask = self._prepare(active, 1)
        logits = _decode_step_core(params, self.state, self._tokens(tokens),
                                   self.cfg, rows, mask)
        self._advance(slots, 1)
        return logits

    def step_tokens(self, params: dict, tokens, active=None) -> torch.Tensor:
        """One batched GREEDY step returning next tokens ``[slots]``."""
        return torch.argmax(self.step(params, tokens, active), dim=-1)

    def step_window(self, params: dict, tokens, n_steps: int,
                    active=None) -> torch.Tensor:
        """``n_steps`` greedy steps with the argmax fed back on the
        device; returns tokens ``[n_steps, slots]`` (row i was produced
        by feeding row i - 1; row 0 fed ``tokens``)."""
        slots, rows, mask = self._prepare(active, n_steps)
        toks = self._tokens(tokens)
        produced = []
        for _ in range(n_steps):
            logits = _decode_step_core(params, self.state, toks, self.cfg,
                                       rows, mask)
            toks = torch.argmax(logits, dim=-1)
            produced.append(toks)
        self._advance(slots, n_steps)
        return torch.stack(produced)

    def step_window_sampled(self, params: dict, tokens, n_steps: int, active,
                            key_data, base_steps, temps, top_ps,
                            sampled_mask) -> torch.Tensor:
        """``n_steps`` mixed greedy/sampled steps. Sampled row b's token
        at step i draws with ``fold_in(key_data[b], base_steps[b] + i)``
        through the nucleus filter; greedy rows take the argmax. All
        per-row inputs are host arrays of length ``slots``."""
        slots, rows, mask = self._prepare(active, n_steps)
        smask = np.asarray(sampled_mask, bool)
        srows_np = np.flatnonzero(smask)
        srows = torch.as_tensor(srows_np, device=self.device)
        keys = as_key_tensor(np.asarray(key_data)[srows_np], self.device)
        base = torch.as_tensor(np.asarray(base_steps, np.int64)[srows_np],
                               device=self.device)
        temps_t = torch.as_tensor(np.asarray(temps, np.float32)[srows_np],
                                  device=self.device)[:, None]
        top_p_t = torch.as_tensor(np.asarray(top_ps, np.float32)[srows_np],
                                  device=self.device)[:, None]
        toks = self._tokens(tokens)
        produced = []
        for i in range(n_steps):
            logits = _decode_step_core(params, self.state, toks, self.cfg,
                                       rows, mask)
            nxt = torch.argmax(logits, dim=-1)
            if srows_np.size:
                nxt[srows] = sample_token(logits[srows],
                                          fold_in(keys, base + i),
                                          temps_t, top_p_t)
            toks = nxt
            produced.append(toks)
        self._advance(slots, n_steps)
        return torch.stack(produced)
