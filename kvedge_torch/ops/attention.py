"""Causal flash attention: the hand-written Hopper kernels, their plain
PyTorch versions, and the ``torch.autograd.Function`` that ties them.

The counterpart of the JAX package's ``ops/attention.py``: there three
Pallas kernels (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)
sit behind a ``jax.custom_vjp``; here three CUDA kernels in
``csrc/flash_attention.cu`` (built at first use, ``ops/_build.py``) sit
behind :class:`_FlashAttention`. The forward saves ``(q, k, v, out,
lse)``; the backward computes ``delta = rowsum(dO * O)`` in fp32 in plain
torch, as the reference does outside its kernels, then launches the dq
and the dk/dv kernels.

Each kernel wrapper (:func:`flash_forward`, :func:`flash_backward_dq`,
:func:`flash_backward_dkv`) launches its kernel on a CUDA tensor or
raises, and computes its plain version only for a CPU tensor, because
there is no kernel to launch there; nothing falls back. Each counts its
launches in ``<wrapper>.launches``.

The plain versions are one dense ``[T, T]`` pass at the kernels'
rounding points: fp32 scores ``(q . k) * Dh^-0.5`` (never rounded to the
dtype), the ``-inf`` causal mask, ``m`` the row max, ``p = exp(s - m)``
rounded to the dtype before ``. V``, ``O = (p . V) / l``; the backward
recomputes ``p = exp(s - lse)``. They are the kernels at a single tile,
and differ from the blockwise kernels only in where each row's running
max is taken and in the order of the fp32 sums. This is NOT the naive
attention of ``models/transformer.py``, which rounds the score to the
dtype and divides by ``sqrt(Dh)`` in the dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kvedge_torch.ops import _build

_KERNEL = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
DEFAULT_BLOCK = 256
_DELTA_BLOCK = 64  # rows of the blocks whose products' diagonals give delta


def pick_block(seq: int) -> int:
    """The reference's block rule: the first of 256, 512, 128, 64, 32,
    16, 8 that divides ``seq``; raises when none does.

    The CUDA kernels tile by their own 64 rows and mask a partial tile,
    so the block is not theirs; the refusal is kept so that a
    configuration the reference refuses is refused here too."""
    for block in (DEFAULT_BLOCK, 512, 128, 64, 32, 16, 8):
        if seq % block == 0:
            return block
    raise ValueError(
        f"flash attention needs the sequence length to be divisible by 8, "
        f"got {seq} (training slices [B, S+1] batches to S tokens — choose "
        "S divisible by 8)"
    )


def cta_tiles(seq: int, kernel: str) -> list[list[tuple[int, int]]]:
    """The (q tile, k tile) products each CTA of one head runs, in order,
    in the bf16 kernels' schedule (``csrc/flash_attention.cu`` computes
    the same on the card from ``blockIdx.x``). CTA p owns the 64-row tiles
    of pair p, ``n - 1 - p`` and ``p`` (an odd ``n`` leaves the middle
    tile alone), so every CTA but that one runs ``n + 1`` tile products.
    ``kernel`` is "fwd" or "dq" (q tiles, the heavier first, each over k
    tiles 0..qt) or "dkv" (k tiles, the heavier first, each over q tiles
    kt..n-1)."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kernel must be fwd, dq or dkv, got {kernel!r}")
    n = -(-seq // 64)
    ctas = []
    for p in range((n + 1) // 2):
        owned = [n - 1 - p] + ([p] if p < n - 1 - p else [])
        if kernel == "dkv":
            owned.reverse()
            ctas.append([(qt, kt) for kt in owned for qt in range(kt, n)])
        else:
            ctas.append([(qt, kt) for qt in owned for kt in range(qt + 1)])
    return ctas


def softmax_scale(d_head: int) -> float:
    """``Dh ** -0.5`` as the fp32 value the reference multiplies by."""
    return float(np.float32(d_head ** -0.5))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Masked fp32 scores ``[BH, T, T]``: ``(q . k) * scale``, -inf above
    the diagonal. Products of bf16 values are exact in fp32, so the fp32
    matmul of the upcast operands is a bf16-operand, fp32-accumulate dot."""
    seq, dh = q.shape[1], q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * softmax_scale(dh)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~causal, float("-inf"))


def flash_forward_reference(q, k, v):
    """The plain forward: q, k, v ``[BH, T, Dh]`` -> (out ``[BH, T, Dh]``
    in q's dtype, lse ``[BH, T]`` fp32)."""
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _probabilities(q, k, v, dout, lse, delta):
    """(p, ds) ``[BH, T, T]`` fp32, p recomputed from the LSE."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_backward_dq_reference(q, k, v, dout, lse, delta):
    """The plain dq pass: ``dq = (scale * sum_k (ds -> dtype) . K) -> dtype``."""
    _, ds = _probabilities(q, k, v, dout, lse, delta)
    dq = torch.matmul(ds.to(q.dtype).float(), k.float())
    return (dq * softmax_scale(q.shape[2])).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, dout, lse, delta):
    """The plain dk/dv pass: ``dv = ((p -> dtype)^T . dO) -> dtype``,
    ``dk = (scale * (ds -> dtype)^T . Q) -> dtype``."""
    p, ds = _probabilities(q, k, v, dout, lse, delta)
    dv = torch.matmul(p.to(q.dtype).float().transpose(1, 2), dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float())
    return (dk * softmax_scale(q.shape[2])).to(k.dtype), dv.to(v.dtype)


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, ``[..., T]``. A product of two
    bf16 values is exact in fp32, so only the order of the fp32 sum is
    free. On the card, for bf16, it is the diagonal of the products of
    64-row blocks of dO and O^T, one batched matmul with fp32 output (the
    fastest plain-torch form measured, PERF.md section 6); otherwise one
    ``addcmul`` onto a one-element fp32 zero, which promotes both operands
    inside its kernel, and a sum."""
    dh = dout.shape[-1]
    if (dout.is_cuda and dout.dtype == torch.bfloat16
            and dout.numel() % (_DELTA_BLOCK * dh) == 0):
        blocks = torch.bmm(
            dout.reshape(-1, _DELTA_BLOCK, dh),
            out.reshape(-1, _DELTA_BLOCK, dh).transpose(1, 2),
            out_dtype=torch.float32)
        # A view when the rows of a head fill whole blocks: copy it.
        return blocks.diagonal(dim1=1, dim2=2).reshape(
            dout.shape[:-1]).contiguous()
    zero = torch.zeros((1,) * dout.dim(), dtype=torch.float32,
                       device=dout.device)
    return torch.addcmul(zero, dout, out).sum(dim=-1)


def flash_backward_reference(q, k, v, out, lse, dout):
    """The plain backward: (dq, dk, dv), each in its input's dtype."""
    delta = attention_delta(dout, out)
    dq = flash_backward_dq_reference(q, k, v, dout, lse, delta)
    dk, dv = flash_backward_dkv_reference(q, k, v, dout, lse, delta)
    return dq, dk, dv


def _check(name, tensors, rows=()):
    """Raise on anything the kernels do not take. ``tensors`` are the
    ``[BH, T, Dh]`` operands, ``rows`` the fp32 ``[BH, T]`` ones."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{name} wants [BH, T, Dh] operands, got "
                         f"{tuple(q.shape)}")
    bh, seq, dh = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes bf16 or fp32, got {q.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name} is built for Dh in {_HEAD_DIMS}, got {dh}")
    if not 1 <= bh <= 65535 or seq < 1:
        raise ValueError(f"{name} takes 1 <= BH <= 65535 and T >= 1, got "
                         f"BH={bh}, T={seq}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: operands must share shape and dtype, "
                             f"got {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    for t in rows:
        if t.shape != (bh, seq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be fp32 [BH, T]")
    for t in (*tensors, *rows):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (*tensors, *rows)):
        raise ValueError(f"{name} reads bf16 tiles, and lse and delta rows, "
                         "by TMA; the operands' storage must be 16-byte "
                         "aligned")
    return bh, seq, dh


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def flash_forward(q, k, v):
    """Causal attention forward (B2): q, k, v ``[BH, T, Dh]`` post-rotary
    and unscaled -> (out ``[BH, T, Dh]``, lse ``[BH, T]`` fp32)."""
    if not _build.on_cuda("flash forward", q):
        return flash_forward_reference(q, k, v)
    bh, seq, dh = _check("flash forward", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        _KERNEL, "flash forward", "kvedge_flash_fwd",
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), lse.data_ptr(), bh, seq, dh, softmax_scale(dh),
         stream), f"BH={bh}, T={seq}, Dh={dh}, dtype={q.dtype}", q.device)
    flash_forward.launches += 1
    return out, lse


def flash_backward_dq(q, k, v, dout, lse, delta):
    """The dq pass (B3): ``[BH, T, Dh]`` in q's dtype."""
    if not _build.on_cuda("flash dq", q):
        return flash_backward_dq_reference(q, k, v, dout, lse, delta)
    bh, seq, dh = _check("flash dq", (q, k, v, dout), (lse, delta))
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        _KERNEL, "flash dq", "kvedge_flash_bwd_dq",
        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
         dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
         bh, seq, dh, softmax_scale(dh), stream),
        f"BH={bh}, T={seq}, Dh={dh}, dtype={q.dtype}", q.device)
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta):
    """The dk/dv pass (B4): (dk, dv), ``[BH, T, Dh]`` each."""
    if not _build.on_cuda("flash dk/dv", q):
        return flash_backward_dkv_reference(q, k, v, dout, lse, delta)
    bh, seq, dh = _check("flash dk/dv", (q, k, v, dout), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        _KERNEL, "flash dk/dv", "kvedge_flash_bwd_dkv",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
         dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), bh, seq, dh, softmax_scale(dh), stream),
        f"BH={bh}, T={seq}, Dh={dh}, dtype={q.dtype}", q.device)
    flash_backward_dkv.launches += 1
    return dk, dv


# Kernel launches since the last reset (plain integers: set one to 0 to
# start a count). CPU calls compute the plain versions and are not counted.
flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out,
    lse); the backward takes delta in fp32 and runs the dq and dk/dv
    passes from the saved LSE (no [T, T] tensor on the card)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(dout, out)
        dq = flash_backward_dq(q, k, v, dout, lse, delta)
        dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta)
        return dq, dk, dv


def flash_attention(q, k, v, block: int | None = None) -> torch.Tensor:
    """Causal flash attention, q, k, v ``[BH, T, Dh]`` -> ``[BH, T, Dh]``,
    differentiable. Pass post-rotary, unscaled q (scaling happens
    inside). ``block`` is checked as the reference checks it
    (:func:`pick_block` when None; a seq it does not divide raises)."""
    seq = q.shape[1]
    if block is None:
        pick_block(seq)
    elif seq % block:
        raise ValueError(f"seq {seq} must be a multiple of block {block}")
    return _FlashAttention.apply(q, k, v)
