"""Paged decode attention: the hand-written Hopper kernel and its plain
PyTorch version.

``paged_decode_attention`` replaces the JAX package's Pallas kernel
``_decode_flat_kernel`` (``kvedge_tpu/ops/paged_attention.py``) with the
same signature and shapes. On a CUDA tensor it launches the CUDA kernel
in ``csrc/paged_decode.cu`` (built at first use, ``ops/_build.py``) or
raises; on a CPU tensor it computes the plain version, because there is
no kernel to launch there. There is no fallback from the kernel to the
plain version.

The plain version, :func:`paged_decode_attention_reference`, is the
gather math of the reference's ``_paged_attend_layer``
(``kvcache.py:1596-1614``) at one query per row: gather each row's
padded ``[S_cap, K, Dh]`` view, score, mask, softmax, weight.
:func:`gather_attention` is that math for any number of queries; the
paged cache's prefill uses it on every device.
"""

from __future__ import annotations

import ctypes

import torch

from kvedge_torch.models.transformer import scale_scores, score_divisor
from kvedge_torch.ops import _build

_KERNEL = "paged_decode"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GROUPS = (1, 2, 4, 8)
_DH = 64
# The kernel's launch shape (csrc/paged_decode.cu): a cluster of at most
# 8 CTAs (the portable cluster size) of 8 warps per (sequence, kv head),
# about 128 pool positions a CTA, K and V staged in rings of 32 KB each.
_MAX_SPLIT = 8
_ROWS_PER_CTA = 128
_RING_BYTES = 32768
_WARPS = 8
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on Hopper (227 KB)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """int8 rows times their fp32 scale, rounded to ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def gather_pages(pool: torch.Tensor, scales, tables: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``pool [P, page, K, Dh]`` pages of every table row as one
    contiguous ``[B, max_pages * page, K, Dh]`` view per sequence
    (dequantized to ``dtype`` for an int8 pool)."""
    batch, max_pages = tables.shape
    page, kv, dh = pool.shape[1:]
    x = pool[tables.long()]
    if scales is not None:
        x = _kv_dequantize(x, scales[tables.long()], dtype)
    return x.reshape(batch, max_pages * page, kv, dh)


def gather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor) -> torch.Tensor:
    """Grouped attention of q ``[B, Q, H, Dh]`` over k/v ``[B, S, K, Dh]``
    where query (b, i) sees key positions ``<= q_positions[b, i]``.

    The reference's rounding chain: a dtype matmul for the scores, the
    divide by ``sqrt(Dh)`` in the dtype, the mask at
    ``finfo(dtype).min``, an fp32 softmax, the weights rounded to the
    dtype, a dtype matmul with V. Returns ``[B, Q, H, Dh]``."""
    batch, q_len, h, dh = q.shape
    kv = k.shape[2]
    group = h // kv
    dtype = q.dtype
    qg = q.reshape(batch, q_len, kv, group, dh)
    scores = scale_scores(torch.einsum("bqkgd,bskd->bkgqs", qg, k), dh)
    key_pos = torch.arange(k.shape[1], device=q.device)
    allowed = key_pos[None, None, :] <= q_positions[:, :, None]  # [B, Q, S]
    scores = scores.masked_fill(~allowed[:, None, None],
                                torch.finfo(dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    attended = torch.einsum("bkgqs,bskd->bqkgd", weights, v)
    return attended.reshape(batch, q_len, h, dh)


def paged_decode_attention_reference(q, pool_k, pool_v, tables, q_positions,
                                     *, scale_k=None, scale_v=None):
    """The plain version: q ``[B, H, Dh]``, pools ``[P, page, K, Dh]``,
    tables ``[B, max_pages]``, q_positions ``[B]`` -> ``[B, H, Dh]``."""
    k = gather_pages(pool_k, scale_k, tables, q.dtype)
    v = gather_pages(pool_v, scale_v, tables, q.dtype)
    return gather_attention(q[:, None], k, v, q_positions[:, None])[:, 0]


def _check(q, pool_k, pool_v, tables, q_positions, scale_k, scale_v):
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or pool_k.dim() != 4:
        raise ValueError("paged decode kernel wants q [B, H, Dh] and pools "
                         "[P, page, K, Dh]")
    batch, h, dh = q.shape
    _, page, kv, pdh = pool_k.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged decode kernel takes bf16 or fp32 q, got "
                         f"{q.dtype}")
    if dh != 64 or pdh != 64:
        raise ValueError(f"paged decode kernel is built for Dh = 64, got "
                         f"q {dh} / pool {pdh}")
    if h % kv or h // kv not in _GROUPS:
        raise ValueError(f"paged decode kernel takes H / K in {_GROUPS}, got "
                         f"H={h}, K={kv}")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v must match in shape and dtype")
    quantized = scale_k is not None
    if quantized != (scale_v is not None):
        raise ValueError("scale_k and scale_v come together")
    if quantized:
        if pool_k.dtype != torch.int8:
            raise ValueError("scales mark an int8 pool; got pools of "
                             f"{pool_k.dtype}")
        for s in (scale_k, scale_v):
            if s.dtype != torch.float32 or s.shape != pool_k.shape[:3]:
                raise ValueError("scales must be fp32 [P, page, K]")
    elif pool_k.dtype != q.dtype:
        raise ValueError(f"pool dtype {pool_k.dtype} != q dtype {q.dtype} "
                         "(an int8 pool needs its scales)")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != batch:
        raise ValueError("tables must be int32 [B, max_pages]")
    if q_positions.dtype != torch.int32 or q_positions.shape != (batch,):
        raise ValueError("q_positions must be int32 [B]")
    tensors = [q, pool_k, pool_v, tables, q_positions]
    if quantized:
        tensors += [scale_k, scale_v]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged decode kernel inputs must share one "
                             "CUDA device")
        if not t.is_contiguous():
            raise ValueError("paged decode kernel inputs must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged decode kernel reads the pools in 16-byte "
                         "vectors; their storage must be 16-byte aligned")
    return quantized


def decode_split(max_pages: int, page: int, group: int,
                 pool_itemsize: int) -> tuple[int, int, int, int]:
    """The kernel's launch shape for a pool of ``max_pages`` pages of
    ``page`` positions a row, ``group`` = H / K query heads per kv head
    and pool elements of ``pool_itemsize`` bytes (1 marks int8):
    ``(split, slice_rows, ring_rows, smem_bytes)``.

    Each (row, kv head) runs on a cluster of ``split`` CTAs, one per
    contiguous slice of at most ``slice_rows`` positions, chosen from the
    pool's shape alone (the live lengths stay on the card). A CTA keeps
    its slice's scores in shared memory and stages K and V through rings
    of ``ring_rows`` rows. Raises when that does not fit in a CTA's
    shared memory."""
    s_cap = max_pages * page
    split = max(1, min(_MAX_SPLIT, -(-s_cap // _ROWS_PER_CTA)))
    slice_rows = -(-s_cap // split)
    row_bytes = _DH * pool_itemsize
    ring_rows = min(slice_rows, _RING_BYTES // row_bytes)
    floats = (group * slice_rows + (2 * ring_rows if pool_itemsize == 1 else 0)
              + 2 * _WARPS * group + 4 * group + _WARPS * group * _DH
              + group * _DH)
    smem = 2 * ring_rows * row_bytes + 4 * floats
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"paged decode kernel: a slice of {slice_rows} positions x "
            f"{group} heads needs {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT} (227 KB) a CTA may use; the pool's rows "
            f"({max_pages} pages of {page}) are too long for {split} CTAs")
    return split, slice_rows, ring_rows, smem


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def paged_decode_attention(q, pool_k, pool_v, tables, q_positions,
                           *, scale_k=None, scale_v=None):
    """Decode attention over a paged KV pool, block-table-indexed.

    q ``[B, H, Dh]`` (post-rotary, one query token per sequence,
    kv-major heads: head h reads kv head ``h // (H / K)``); pool_k/pool_v
    ``[P, page, K, Dh]``; tables ``[B, max_pages]`` int32; q_positions
    ``[B]`` int32 (row b attends key positions ``0..q_positions[b]``,
    whose K/V are already written). ``scale_k``/``scale_v``
    (``[P, page, K]`` fp32) mark an int8 pool. Returns ``[B, H, Dh]`` in
    q's dtype. The kernel reads each row's LIVE pages only, each row
    split across a cluster of CTAs (:func:`decode_split`).
    """
    if not _build.on_cuda("paged decode", q):
        return paged_decode_attention_reference(
            q, pool_k, pool_v, tables, q_positions,
            scale_k=scale_k, scale_v=scale_v)
    quantized = _check(q, pool_k, pool_v, tables, q_positions,
                       scale_k, scale_v)
    batch, h, dh = q.shape
    _, page, kv, _ = pool_k.shape
    max_pages = tables.shape[1]
    split, slice_rows, ring_rows, smem = decode_split(
        max_pages, page, h // kv, pool_k.element_size())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        _KERNEL, "paged decode", "kvedge_paged_decode", _ARGTYPES,
        (_DTYPE_CODES[q.dtype], int(quantized), q.data_ptr(),
         pool_k.data_ptr(), pool_v.data_ptr(),
         scale_k.data_ptr() if quantized else None,
         scale_v.data_ptr() if quantized else None,
         tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
         batch, h, kv, dh, page, max_pages, split, slice_rows, ring_rows,
         smem, score_divisor(dh, q.dtype), stream),
        f"B={batch}, H={h}, K={kv}, Dh={dh}, page={page}, "
        f"max_pages={max_pages}, dtype={q.dtype}, int8={quantized}, "
        f"split={split}", q.device)
    paged_decode_attention.launches += 1
    return out


# Kernel launches since the last reset (a plain integer: set it to 0 to
# start a count). CPU calls compute the plain version and are not counted.
paged_decode_attention.launches = 0
