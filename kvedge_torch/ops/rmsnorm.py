"""One-pass RMSNorm: the hand-written Hopper kernel (B8), its plain
PyTorch version, and ``rmsnorm_fused``, the ``torch.autograd.Function``
that pairs the kernel with the analytic backward.

The counterpart of the JAX package's ``ops/rmsnorm.py``, the reference's
RMSNorm-fusion experiment: ``rmsnorm_fused`` is a drop-in for
``models.transformer._rmsnorm`` (the bench tool swaps it in for a train
step). The forward is ``csrc/rmsnorm.cu`` (built at first use,
``ops/_build.py``) at ``_rmsnorm``'s rounding points: a warp holds a row
in registers, reads x once in 16-byte vectors and keeps the dtype-rounded
gain in registers across the rows it walks; the grid is capped at what
the SMs hold at once. The backward is the reference's analytic VJP in
plain torch.

:func:`rmsnorm_forward` launches the kernel on a CUDA tensor or raises,
and computes the plain version only for a CPU tensor; nothing falls
back. It counts its launches in ``rmsnorm_forward.launches``. The
reference's jnp fallback for row counts not divisible by 8 is a TPU
tiling rule and is not carried over: the kernel takes every N >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from kvedge_torch.ops import _build

_KERNEL = "rmsnorm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-6


def rmsnorm_reference(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """The plain forward, ``_rmsnorm``'s formula: the mean of squares in
    fp32, ``rsqrt(+1e-6)``, the scale cast to the dtype, then ``x *
    scale`` and ``* gain`` in the dtype."""
    scale = torch.rsqrt(
        torch.mean(torch.square(x.float()), dim=-1, keepdim=True) + EPS)
    return (x * scale.to(x.dtype)) * gain.to(x.dtype)


def rmsnorm_forward(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """The forward (B8): x ``[N, D]`` bf16 or fp32, gain ``[D]`` fp32 ->
    ``[N, D]`` in x's dtype."""
    if not _build.on_cuda("rmsnorm", x):
        return rmsnorm_reference(x, gain)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm wants x [N, D] in bf16 or fp32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"rmsnorm takes N, D >= 1, got N={n}, D={d}")
    if gain.shape != (d,) or gain.dtype != torch.float32:
        raise ValueError(f"rmsnorm: gain must be fp32 [D], got "
                         f"{tuple(gain.shape)} {gain.dtype}")
    for t in (x, gain):
        if t.device != x.device:
            raise ValueError("rmsnorm: inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("rmsnorm: inputs must be contiguous")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    _build.launch(_KERNEL, "rmsnorm", "kvedge_rmsnorm_fwd",
                  [i, p, p, p, i, i, p],
                  (_DTYPE_CODES[x.dtype], x.data_ptr(), gain.data_ptr(),
                   y.data_ptr(), n, d, stream), f"N={n}, D={d}, {x.dtype}",
                  x.device)
    rmsnorm_forward.launches += 1
    return y


# Kernel launches since the last reset (a plain integer: set it to 0 to
# start a count). CPU calls compute the plain version and are not counted.
rmsnorm_forward.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The reference's ``custom_vjp``: the kernel forward over ``[-1, D]``
    rows, the analytic backward (``_rmsnorm_vjp_bwd``) in fp32 torch."""

    @staticmethod
    def forward(ctx, x, gain):
        d = x.shape[-1]
        y = rmsnorm_forward(x.reshape(-1, d).contiguous(),
                            gain.float().contiguous())
        ctx.save_for_backward(x, gain)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        d = x.shape[-1]
        xf, dyf, gf = x.float(), dy.float(), gain.float()
        s = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + EPS)
        dyg = dyf * gf
        proj = torch.sum(dyg * xf, dim=-1, keepdim=True) / d
        dx = (dyg * s - xf * proj * (s ** 3)).to(x.dtype)
        dg = torch.sum((dyf * (xf * s)).reshape(-1, d), dim=0)
        return dx, dg.to(gain.dtype)


def rmsnorm_fused(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``models.transformer._rmsnorm``: x ``[..., D]``, gain
    ``[D]``, differentiable in both."""
    return _RMSNorm.apply(x, gain)
