"""Ulysses-style sequence parallelism: all-to-all head scatter and gather.

The counterpart of the JAX package's ``parallel/ulysses.py``, plain
products there (no Pallas kernel) and plain torch here. Where the ring
rotates K/V chunks around the ``seq`` axis, Ulysses re-shards once in
each direction:

* inputs arrive sequence-sharded, ``[B, T/sp, H, dh]`` a rank;
* one all-to-all a tensor on the ``seq`` group splits the head axis
  ``sp`` ways and concatenates the sequence: every rank then holds
  ``H/sp`` full-sequence heads ``[B, T, H/sp, dh]``, in the model dtype
  (bf16 halves the bytes moved);
* attention runs locally and exactly: a dense causal softmax in fp32
  over the rank's heads (:func:`_local_causal_attention`, the
  reference's), an ``[B, H/sp, T, T]`` score block a rank;
* the reverse all-to-all restores sequence sharding for the rest of the
  layer.

The all-to-all is a ``torch.autograd.Function`` whose backward is the
reverse all-to-all; the local attention is differentiated by autograd.
With a ``model`` axis the heads are first split over it (each rank holds
``H/tp``), and the all-to-all scatters those over ``seq``: ``n_heads``
must divide by ``sp * tp``.
"""

from __future__ import annotations

import torch

from kvedge_torch.parallel.ringattention import _check_sequence, local_block

# Same finite -inf stand-in as the ring: exp(_MASKED - m) == 0 in fp32.
_MASKED = -1e30


def _local_causal_attention(q, k, v):
    """Exact causal attention on full-sequence, head-local tensors.

    q, k, v: ``[B, T, Hl, dh]``, any dtype; scores and softmax in fp32.
    Returns fp32 ``[B, T, Hl, dh]``."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / (dh ** 0.5)
    seq = q.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal[None, None], s, _MASKED)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf)


def _all_to_all(x: torch.Tensor, group, n: int, split: int,
                concat: int) -> torch.Tensor:
    """Split ``x`` ``n`` ways along ``split`` (piece j to rank j of the
    group), and concatenate the pieces received along ``concat`` in rank
    order."""
    import torch.distributed as dist

    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, concat, split)
        return _all_to_all(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None, None


def ulysses_attention_local(q, k, v, mesh, *, seq_axis: str = "seq"):
    """The per-rank body. q, k, v: ``[B, Tl, Hl, dh]`` this rank's
    sequence chunk of its (model-local) heads; returns the chunk's
    attention in q's dtype."""
    group, sp = mesh.group(seq_axis), mesh.size(seq_axis)
    if group is None:
        return _local_causal_attention(q, k, v).to(q.dtype)
    # [B, Tl, Hl, dh] -> [B, T, Hl/sp, dh]: split heads, gather sequence.
    q, k, v = (_AllToAll.apply(x, group, sp, 2, 1) for x in (q, k, v))
    out = _local_causal_attention(q, k, v).to(q.dtype)
    # [B, T, Hl/sp, dh] -> [B, Tl, Hl, dh]: the reverse re-shard.
    return _AllToAll.apply(out, group, sp, 1, 2)


def ulysses_attention(q, k, v, mesh, *, seq_axis: str = "seq",
                      data_axis: str = "data", model_axis: str = "model"):
    """Causal self-attention, sequence-sharded via all-to-all head
    scatter, with the reference's checks and messages.

    q, k, v: ``[B, T, H, dh]`` global tensors, the same on every rank
    (rotary already applied). The batch dim shards on ``data_axis``; with
    a ``model_axis`` the heads shard over it first, so ``n_heads`` must
    divide by ``sp * tp``. Returns this rank's block ``[B/dp, T/sp,
    H/tp, dh]`` of the output; gradients flow to that block of q, k, v."""
    sp = _check_sequence(mesh, q.shape[1], seq_axis, "ulysses")
    tp = mesh.size(model_axis)
    heads = q.shape[2]
    if heads % (sp * tp):
        raise ValueError(
            f"n_heads {heads} must divide by {seq_axis!r} x "
            f"{model_axis!r} = {sp} x {tp} — ulysses scatters each "
            f"model shard's heads over the sequence axis; use ring "
            "attention when the axes exceed the head count"
        )
    blocks = [local_block(x, mesh, seq_axis=seq_axis, data_axis=data_axis,
                          model_axis=model_axis) for x in (q, k, v)]
    return ulysses_attention_local(*blocks, mesh, seq_axis=seq_axis)

