"""Prompt-lookup speculative decoding: K drafted tokens, one verify pass.

The counterpart of the JAX package's ``models/speculative.py``. The
draft model is the context itself: find the most recent earlier
occurrence of the current bigram and propose the K tokens that followed
it. A draft is accepted only where it equals the model's own greedy
argmax, so the output is token for token :func:`decode.generate`'s
greedy output; bad drafts only cost speed.

Differences that are the port's, not the reference's:

* :func:`_propose_ngram` is batched, over ``ctx [B, S]`` and ``length
  [B]``, so the paged cache's spec windows (``models/kvcache.py``) run
  the same proposer on the device; ``torch.amax`` over the match mask
  stands in for the max and ``torch.gather`` over ``start + arange(k)``
  for ``dynamic_slice``.
* :func:`generate_speculative` is a host loop over verify passes (the
  reference's ``while_loop``) with one read of each pass's accepted
  count; the cache is written in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import (
    KVCache,
    _run_layers,
    init_cache,
    prefill,
)
from kvedge_torch.models.transformer import torch_dtype
from kvedge_torch.runtime.devicecheck import resolve_device


def _propose_ngram(ctx: torch.Tensor, length: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Draft ``k`` tokens per row from the row's own history.

    ``ctx [B, S]`` holds prompt + accepted tokens (junk beyond
    ``length``); ``length [B]`` is >= 2 on every row that drafts (a row
    with less, one a spec window does not run, reads its bigram from the
    end of ``ctx``, as ``jnp.take`` wraps a negative index). Row b finds
    the most recent
    position ``p < length[b] - 2`` where ``ctx[b, p:p+2]`` equals its
    final bigram and proposes ``ctx[b, p+2 : p+2+k]`` (the start clipped
    to ``[0, S - k]``); with no match it repeats its last token. Any
    guess is legal: verification makes the output draft-independent.
    Fixed shapes, no host read: it runs inside a captured graph."""
    s = ctx.shape[1]
    length = length.long()
    idx = torch.arange(s, device=ctx.device)
    g0 = torch.gather(ctx, 1, torch.remainder(length - 2, s)[:, None])
    g1 = torch.gather(ctx, 1, torch.remainder(length - 1, s)[:, None])
    match = ((ctx == g0) & (torch.roll(ctx, -1, dims=1) == g1)
             & (idx[None] < (length - 2)[:, None]))
    p = torch.amax(torch.where(match, idx[None], -1), dim=1)
    start = torch.clamp(p + 2, 0, s - k)
    draft = torch.gather(
        ctx, 1, start[:, None] + torch.arange(k, device=ctx.device)[None])
    return torch.where((p >= 0)[:, None], draft, g1)


def _verify(params: dict, cache: KVCache, tokens: torch.Tensor,
            cfg: TransformerConfig):
    """One forward over ``[1, 1+K]`` positions against the cache:
    ``tokens`` = [last accepted token, draft_0 .. draft_{K-1}]. Returns
    (the greedy argmax at every position ``[1, 1+K]``, the cache
    advanced by 1+K; the caller rewinds ``length`` to the accepted
    prefix). Runs decode's own layer stack, so the numerics are plain
    decode's."""
    x = params["embedding"][tokens].to(torch_dtype(cfg.dtype))
    logits, cache = _run_layers(cfg, params, x, cache, cache.length,
                                all_positions=True)
    return torch.argmax(logits, dim=-1), cache


@torch.no_grad()
def generate_speculative(params: dict, prompt, cfg: TransformerConfig,
                         n_new: int, draft_len: int = 4,
                         device: torch.device | str | None = None):
    """Greedy-decode ``n_new`` tokens after a ``[1, T]`` prompt with
    prompt-lookup speculation; returns ``([1, T + n_new] int64 on
    device, rate)``. ``rate`` is the mean tokens emitted per verify pass
    (the prefill's first token excluded, the total clamped at ``n_new``;
    0.0 when no pass ran, i.e. ``n_new == 1``), in fp32 as the
    reference computes it.

    Token for token :func:`decode.generate`'s greedy output, with the
    reference's one caveat: a ``1+K``-query matmul may round differently
    from a one-query matmul, so an exact logit tie may break another
    way."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    if prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is single-sequence (got batch "
            f"{prompt.shape[0]}); use generate()/the paged server for "
            "batched throughput"
        )
    k = draft_len
    prompt_len = prompt.shape[1]
    # Slack beyond n_new: a verify pass may write past the last needed
    # token.
    size = prompt_len + n_new + k + 1
    cache = init_cache(cfg, 1, max_seq=size, device=dev)
    logits, cache = prefill(params, prompt, cache, cfg)
    first = torch.argmax(logits, dim=-1)  # [1]

    ctx = torch.zeros((1, size), dtype=torch.int64, device=dev)
    ctx[0, :prompt_len] = prompt[0]
    ctx[0, prompt_len] = first[0]
    out = torch.zeros((n_new + k + 1,), dtype=torch.int64, device=dev)
    out[0] = first[0]
    offsets = torch.arange(k + 1, device=dev)
    produced, steps = 1, 0
    while produced < n_new:
        length = prompt_len + produced
        draft = _propose_ngram(
            ctx, torch.full((1,), length, dtype=torch.int64, device=dev),
            k)[0]
        tokens = torch.cat([ctx[0, length - 1:length], draft])[None]
        y, cache = _verify(params, cache, tokens, cfg)
        y = y[0]  # y[i] = the greedy token after position i
        accepted = torch.cumprod((draft == y[:k]).long(), dim=0).sum()
        a = int(accepted)  # the pass's one read
        # The accepted drafts then the bonus token (the model's argmax
        # after them); entries past it are overwritten next pass.
        emitted = torch.where(offsets < a, torch.cat([draft, y[-1:]]), y[a])
        out[produced:produced + k + 1] = emitted
        ctx[0, length:length + k + 1] = emitted
        # Valid K/V covers [0, length + a): the bonus token's K/V is the
        # next pass's first write, as in plain decode.
        cache = dataclasses.replace(cache, length=length + a)
        produced += a + 1
        steps += 1
    tokens = torch.cat([prompt[0], out[:n_new]])[None]
    delivered = min(produced, n_new)
    rate = (float(np.float32(delivered - 1) / np.float32(steps))
            if steps > 0 else 0.0)
    return tokens, rate
