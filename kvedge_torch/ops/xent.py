"""Fused softmax cross-entropy of the tied readout: the hand-written
Hopper kernels, their plain PyTorch versions, and the
``torch.autograd.Function`` that ties them.

The counterpart of the JAX package's ``ops/xent.py``: there three Pallas
kernels (``_fwd_kernel``, ``_dx_kernel``, ``_de_kernel``) sit behind a
``jax.custom_vjp``; here three CUDA kernels in ``csrc/xent.cu`` (built at
first use, ``ops/_build.py``) sit behind :class:`_FusedXent`. Neither
pass writes an ``[N, V]`` tensor: the forward keeps an online max and sum
over the vocabulary and extracts the target logit as its tile streams
past; the backward recomputes the probabilities from the saved LSE. In
bf16 all three run on wgmma over TMA-fed mbarrier rings: the forward with
128 resident rows a CTA (two consumer warpgroups of 64) and E streamed in
K-chunks of 128 rows by 64 columns, the backward with 64 resident rows
and D split between two consumer warpgroups.

Each kernel wrapper (:func:`xent_forward`, :func:`xent_backward_dx`,
:func:`xent_backward_de`) launches its kernel on a CUDA tensor or
raises, and computes its plain version only for a CPU tensor, because
there is no kernel to launch there; nothing falls back. Each counts its
launches in ``<wrapper>.launches``.

The plain versions materialize the fp32 logits ``[N, V]`` (they exist for
the tests and ``chip_smoke.py``) at the kernels' rounding points: the
operands in the compute dtype, fp32 accumulation, ``p = exp(s - lse)``
and ``ds = (p - onehot) * g`` in fp32, ``ds`` rounded to the compute
dtype before ``ds . E`` and ``ds^T . x``, ``dx`` cast to x's dtype and
``dE`` kept fp32.
"""

from __future__ import annotations

import ctypes

import torch

from kvedge_torch.ops import _build

_KERNEL = "xent"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (64, 128, 256, 512)

# The reference's block preferences (its TPU tiling). The CUDA kernels
# tile by their own (bf16: 128 resident rows and 128-row K-chunks of E in
# the forward, 64 and 64-row tiles in the backward; fp32: 32 and 64),
# so these blocks are not theirs; the pickers are kept so that what the
# reference refuses is refused here too.
_VOCAB_BLOCKS = (1280, 1024, 512, 256, 128)
_ROW_BLOCKS = (1024, 512, 256, 128, 64, 32, 16, 8)


def pick_vocab_block(vocab: int) -> int:
    """Largest lane-aligned vocab block that divides ``vocab``."""
    for block in _VOCAB_BLOCKS:
        if vocab % block == 0:
            return block
    raise ValueError(
        f"fused cross-entropy needs vocab divisible by 128, got {vocab} "
        "(pad the vocabulary or disable fused_xent)"
    )


def pick_row_block(rows: int, max_block: int = 1024) -> int:
    """Largest sublane-aligned row block <= max_block dividing ``rows``."""
    for block in _ROW_BLOCKS:
        if block <= max_block and rows % block == 0:
            return block
    raise ValueError(
        f"fused cross-entropy needs batch*seq divisible by 8, got {rows}"
    )


def wrap_targets(targets: torch.Tensor, vocab: int):
    """``jnp.take_along_axis``'s index semantics: (ids wrapped and clipped
    into ``[0, vocab)``, valid mask). Negative ids in ``[-V, 0)`` wrap;
    ids outside ``[-V, V)`` are invalid, and the caller NaN-fills what it
    gathered for them."""
    wrapped = torch.where(targets < 0, targets + vocab, targets)
    valid = (targets >= -vocab) & (targets < vocab)
    return wrapped.clamp(0, vocab - 1), valid


def _logits(x, e):
    """fp32 ``x . E^T``: products of bf16 values are exact in fp32, so the
    fp32 matmul of the upcast operands is a bf16-operand, fp32-accumulate
    dot."""
    return torch.matmul(x.float(), e.float().t())


def xent_forward_reference(x, e, targets):
    """The plain forward: x ``[N, D]``, E ``[V, D]`` (same dtype), targets
    ``[N]`` in ``[0, V)`` -> (lse, target_logit), ``[N]`` fp32 each."""
    s = _logits(x, e)
    return (torch.logsumexp(s, dim=-1),
            s.gather(1, targets.long()[:, None])[:, 0])


def _cotangent(x, e, targets, lse, g):
    """``(ds -> dtype)`` as fp32 ``[N, V]``, with
    ``ds = (exp(s - lse) - onehot) * g``."""
    p = torch.exp(_logits(x, e) - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, targets.long()[:, None], 1.0)
    return ((p - onehot) * g[:, None]).to(x.dtype).float()


def xent_backward_dx_reference(x, e, targets, lse, g):
    """The plain dx pass: ``((ds -> dtype) . E) -> x's dtype``, ``[N, D]``."""
    return torch.matmul(_cotangent(x, e, targets, lse, g),
                        e.float()).to(x.dtype)


def xent_backward_de_reference(x, e, targets, lse, g):
    """The plain dE pass: ``(ds -> dtype)^T . x`` in fp32, ``[V, D]``."""
    return torch.matmul(_cotangent(x, e, targets, lse, g).t(), x.float())


def _check(name, x, e, targets, rows=()):
    """Raise on anything the kernels do not take; returns (N, V, D).
    ``rows`` are the fp32 ``[N]`` operands (lse, g)."""
    if x.dim() != 2 or e.dim() != 2 or x.shape[1] != e.shape[1]:
        raise ValueError(f"{name} wants x [N, D] and E [V, D], got "
                         f"{tuple(x.shape)} and {tuple(e.shape)}")
    n, d = x.shape
    v = e.shape[0]
    if x.dtype not in _DTYPE_CODES or e.dtype != x.dtype:
        raise ValueError(f"{name} takes bf16 or fp32 x and E of one dtype, "
                         f"got {x.dtype} and {e.dtype}")
    if d not in _WIDTHS:
        raise ValueError(f"{name} is built for D in {_WIDTHS}, got {d}")
    if n < 1 or v < 1:
        raise ValueError(f"{name} takes N, V >= 1, got N={n}, V={v}")
    if targets.shape != (n,) or targets.dtype != torch.int32:
        raise ValueError(f"{name}: targets must be int32 [N], got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    for t in rows:
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and g must be fp32 [N]")
    for t in (x, e, targets, *rows):
        if t.device != x.device:
            raise ValueError(f"{name}: inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, e)):
        raise ValueError(f"{name} reads bf16 tiles in 16-byte vectors; the "
                         "operands' storage must be 16-byte aligned")
    return n, v, d


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage is not 16-byte aligned:
    the bf16 backward reads lse, g and the targets by TMA."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_P, _I = ctypes.c_void_p, ctypes.c_int


def _note(n, v, d, dtype):
    return f"N={n}, V={v}, D={d}, dtype={dtype}"


def xent_forward(x, e, targets):
    """The forward (B5): x ``[N, D]``, E ``[V, D]`` in the compute dtype,
    int32 targets in ``[0, V)`` -> (lse, target_logit), ``[N]`` fp32."""
    if not _build.on_cuda("xent forward", x):
        return xent_forward_reference(x, e, targets)
    n, v, d = _check("xent forward", x, e, targets)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    tlogit = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch(_KERNEL, "xent forward", "kvedge_xent_fwd",
                  [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                  (_DTYPE_CODES[x.dtype], x.data_ptr(), e.data_ptr(),
                   targets.data_ptr(), lse.data_ptr(), tlogit.data_ptr(),
                   n, v, d, stream), _note(n, v, d, x.dtype), x.device)
    xent_forward.launches += 1
    return lse, tlogit


def _backward(what, symbol, out, x, e, targets, lse, g):
    """Launch a backward pass writing ``out`` (dx or dE)."""
    n, v, d = _check(what, x, e, targets, (lse, g))
    if x.dtype == torch.bfloat16:
        targets, lse, g = (_aligned16(t) for t in (targets, lse, g))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch(_KERNEL, what, symbol,
                  [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                  (_DTYPE_CODES[x.dtype], x.data_ptr(), e.data_ptr(),
                   targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
                   out.data_ptr(), n, v, d, stream), _note(n, v, d, x.dtype),
                  x.device)
    return out


def xent_backward_dx(x, e, targets, lse, g):
    """The dx pass (B6): ``[N, D]`` in x's dtype."""
    if not _build.on_cuda("xent dx", x):
        return xent_backward_dx_reference(x, e, targets, lse, g)
    dx = _backward("xent dx", "kvedge_xent_bwd_dx", torch.empty_like(x),
                   x, e, targets, lse, g)
    xent_backward_dx.launches += 1
    return dx


def xent_backward_de(x, e, targets, lse, g):
    """The dE pass (B7): ``[V, D]`` fp32."""
    if not _build.on_cuda("xent dE", x):
        return xent_backward_de_reference(x, e, targets, lse, g)
    de = torch.empty(e.shape, dtype=torch.float32, device=x.device)
    de = _backward("xent dE", "kvedge_xent_bwd_de", de, x, e, targets, lse, g)
    xent_backward_de.launches += 1
    return de


# Kernel launches since the last reset (plain integers: set one to 0 to
# start a count). CPU calls compute the plain versions and are not counted.
xent_forward.launches = 0
xent_backward_dx.launches = 0
xent_backward_de.launches = 0


class _FusedXent(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_fused_xent_fwd`` /
    ``_fused_xent_bwd``): the fp32 master embedding is cast to x's dtype
    once, in here; the forward saves (x, E in the dtype, the clipped ids,
    lse); the backward runs the dx and dE passes from them, so an id
    outside ``[-V, V)`` (NaN in the forward) gets the clipped id's
    one-hot, as the reference's residuals give it."""

    @staticmethod
    def forward(ctx, x, embedding, targets):
        vocab = embedding.shape[0]
        e = embedding.to(x.dtype).contiguous()
        ids, valid = wrap_targets(targets, vocab)
        ids = ids.to(torch.int32).contiguous()
        x = x.contiguous()
        lse, tlogit = xent_forward(x, e, ids)
        ctx.save_for_backward(x, e, ids, lse)
        return lse - tlogit.masked_fill(~valid, float("nan"))

    @staticmethod
    def backward(ctx, g):
        x, e, ids, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dx = de = None
        if ctx.needs_input_grad[0]:
            dx = xent_backward_dx(x, e, ids, lse, g)
        if ctx.needs_input_grad[1]:
            # fp32 from the kernel's accumulator: the fp32 master sees
            # full-precision gradients, no round trip through the dtype.
            de = xent_backward_de(x, e, ids, lse, g)
        return dx, de, None


def fused_xent(x: torch.Tensor, embedding: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy of the tied readout, fused:
    x ``[N, D]`` (compute dtype), embedding ``[V, D]`` (the fp32 master),
    targets ``[N]`` int -> ``[N]`` fp32 ``logsumexp(x . E^T) -
    logit[target]``, differentiable in x and the embedding. Refuses what
    the reference refuses (``N % 8``, ``V % 128``) with its messages."""
    pick_row_block(x.shape[0])
    pick_vocab_block(embedding.shape[0])
    return _FusedXent.apply(x, embedding, targets)
