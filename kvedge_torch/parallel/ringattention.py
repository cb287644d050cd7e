"""Causal ring attention: sequence parallelism over the mesh's ``seq`` axis.

The counterpart of the JAX package's ``parallel/ringattention.py``, which
computes it as plain einsums inside a ``shard_map`` (no Pallas kernel),
so plain torch products are the faithful port:

* Each rank holds a contiguous chunk of ``T/sp`` tokens of q, k and v.
* K/V chunks rotate one hop a step (rank ``i`` sends to ``i + 1``) with
  ``dist.batch_isend_irecv`` on the ``seq`` group, started before the
  step's fold so the transfer overlaps it, while each rank folds the
  visiting chunk into a running online softmax (max and denominator)
  in fp32, with ``_MASKED = -1e30`` for masked scores.
* Causality by global positions; a chunk strictly above the diagonal
  (source index above the rank's own) skips its products but still
  rotates. The last chunk is folded without the trailing hop.

P2P ops have no autograd, so :class:`_RingAttention` is a
``torch.autograd.Function`` with a hand-written backward: it runs the
reverse ring (rank ``i`` sends to ``i - 1``) from the chunk the forward
ended on, carrying each chunk's ``dk`` and ``dv`` accumulators with it
until they are home at step 0, and recomputes each chunk's scores from
the saved per-row log-sum-exp (the reference checkpoints each ring step:
no ``sp`` score matrices are kept).
"""

from __future__ import annotations

import torch

# Finite stand-in for -inf: keeps fully-masked rows NaN-free in the online
# softmax (exp(-BIG - m) == 0 exactly in fp32) without special-casing.
_MASKED = -1e30


def _rotate(tensors, group, dst: int, src: int):
    """Send ``tensors`` to global rank ``dst`` and receive as many from
    ``src``; returns (received, works to wait on)."""
    import torch.distributed as dist

    recv = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, src, group) for r in recv])
    return recv, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _scores(qf, kf, q_pos, kv_pos):
    """Masked fp32 scores ``[B, H, Tq, Tk]`` of a (q chunk, kv chunk)."""
    s = torch.matmul(qf, kf.transpose(-1, -2))
    mask = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
    return torch.where(mask, s, _MASKED)


def _head_major(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, dh]`` -> fp32 ``[B, H, T, dh]``."""
    return x.float().transpose(1, 2)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, sp, my, nxt, prv):
        _, t_local, _, dh = q.shape
        scale = dh ** -0.5
        qf = _head_major(q.float() * scale)
        ar = torch.arange(t_local, device=q.device)
        q_pos = my * t_local + ar
        m = torch.full(qf.shape[:-1] + (1,), _MASKED, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        k_cur, v_cur = k, v
        for s in range(sp):
            src = (my - s) % sp  # chunk origin after s ring hops
            if s < sp - 1:
                (k_nxt, v_nxt), works = _rotate((k_cur, v_cur), group,
                                                nxt, prv)
            if src <= my:  # above-diagonal chunks contribute nothing
                sc = _scores(qf, _head_major(k_cur), q_pos, src * t_local + ar)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                correction = torch.exp(m - m_new)
                l = l * correction + p.sum(-1, keepdim=True)
                acc = acc * correction + torch.matmul(p, _head_major(v_cur))
                m = m_new
            if s < sp - 1:
                _wait(works)
                k_cur, v_cur = k_nxt, v_nxt
        out = acc / l  # every q row attends at least to itself, so l > 0
        ctx.save_for_backward(q, k_cur, v_cur, out, m + torch.log(l))
        ctx.ring = (group, sp, my, nxt, prv)
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k_cur, v_cur, out, lse = ctx.saved_tensors
        group, sp, my, nxt, prv = ctx.ring
        _, t_local, _, dh = q.shape
        scale = dh ** -0.5
        qf = _head_major(q.float() * scale)
        do = _head_major(grad)
        delta = (do * out).sum(-1, keepdim=True)
        ar = torch.arange(t_local, device=q.device)
        q_pos = my * t_local + ar
        dqf = torch.zeros_like(qf)
        dk = torch.zeros_like(qf)
        dv = torch.zeros_like(qf)
        # The reverse ring: step s holds chunk (my - s) % sp, as the
        # forward did, starting from the chunk the forward ended on.
        for s in reversed(range(sp)):
            src = (my - s) % sp
            if src <= my:
                kf, vf = _head_major(k_cur), _head_major(v_cur)
                p = torch.exp(_scores(qf, kf, q_pos, src * t_local + ar) - lse)
                dv = dv + torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
                dqf = dqf + torch.matmul(ds, kf)
                dk = dk + torch.matmul(ds.transpose(-1, -2), qf)
            if s > 0:
                recv, works = _rotate((k_cur, v_cur, dk, dv), group, prv, nxt)
                _wait(works)
                k_cur, v_cur, dk, dv = recv
        return ((dqf * scale).transpose(1, 2).to(q.dtype),
                dk.transpose(1, 2).to(k_cur.dtype),
                dv.transpose(1, 2).to(v_cur.dtype),
                None, None, None, None, None)


def ring_attention_local(q, k, v, mesh, *, seq_axis: str = "seq"):
    """The per-rank body. q, k, v: ``[B, Tl, H, dh]``, this rank's chunk
    of the sequence (rotary already applied, K/V heads repeated to H);
    returns the chunk's attention ``[B, Tl, H, dh]`` in q's dtype."""
    sp, my = mesh.size(seq_axis), mesh.index(seq_axis)
    group = mesh.group(seq_axis)
    nxt = prv = -1
    if group is not None:
        import torch.distributed as dist

        nxt = dist.get_global_rank(group, (my + 1) % sp)
        prv = dist.get_global_rank(group, (my - 1) % sp)
    return _RingAttention.apply(q, k, v, group, sp, my, nxt, prv)


def _check_sequence(mesh, seq: int, seq_axis: str, what: str) -> int:
    if seq_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {seq_axis!r} axis (axes: "
            f"{sorted(mesh.axis_names)}) — {what} attention needs a "
            "sequence axis"
        )
    sp = mesh.size(seq_axis)
    if seq % sp:
        raise ValueError(
            f"sequence length {seq} must divide by the {seq_axis!r} axis "
            f"size {sp}"
        )
    return sp


def local_block(x, mesh, *, seq_axis: str = "seq", data_axis: str = "data",
                model_axis: str = "model"):
    """This rank's block of a global ``[B, T, H, dh]`` tensor: rows by
    the data axis, sequence chunk by the seq axis, heads by the model
    axis (each only where the mesh has it)."""
    for axis, dim in ((data_axis, 0), (seq_axis, 1), (model_axis, 2)):
        n = mesh.size(axis)
        if n > 1:
            width = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axis) * width, width)
    return x


def ring_attention(q, k, v, mesh, *, seq_axis: str = "seq",
                   data_axis: str = "data", model_axis: str = "model"):
    """Causal self-attention with the sequence dim sharded over
    ``seq_axis``, with the reference's checks and messages.

    q, k, v: ``[B, T, H, dh]`` global tensors, the same on every rank
    (rotary already applied). The batch dim shards on ``data_axis`` and,
    when the mesh has one, the head dim on ``model_axis``. Returns this
    rank's block ``[B/dp, T/sp, H/tp, dh]`` of the output (the reference
    returns the global array sharded that way); gradients flow to that
    block of q, k and v."""
    seq = q.shape[1]
    _check_sequence(mesh, seq, seq_axis, "ring")
    heads = q.shape[2]
    if model_axis in mesh.axis_names and heads % mesh.size(model_axis):
        raise ValueError(
            f"n_heads {heads} must divide by the {model_axis!r} axis size "
            f"{mesh.size(model_axis)} when composing ring attention with tp"
        )
    blocks = [local_block(x, mesh, seq_axis=seq_axis, data_axis=data_axis,
                          model_axis=model_axis) for x in (q, k, v)]
    return ring_attention_local(*blocks, mesh, seq_axis=seq_axis)


def sequence_sharding(mesh, *, seq_axis: str = "seq",
                      data_axis: str = "data") -> tuple:
    """The spec of ``[B, T, D]`` activations under sequence parallelism:
    rows on the data axis, the sequence on the seq axis."""
    names = set(mesh.axis_names)
    return (data_axis if data_axis in names else None,
            seq_axis if seq_axis in names else None, None)
