"""The flagship decoder in PyTorch: the counterpart of the JAX package's
``models/transformer.py`` for inference.

Params are a flat dict of layer-stacked tensors with the reference's
keys and shapes (``[L, ...]`` for per-layer weights), held in the
compute dtype: the bridge (``models/weights.py``) casts each fp32
master weight ONCE at load, which gives the same bits as the
reference's cast at every use. Every function keeps the reference's
rounding points, because the tests hold the port to the JAX package
token for token at fp32:

* ``_rmsnorm``: mean of squares in fp32, ``rsqrt(+1e-6)``, the SCALE
  cast to the dtype, then ``x * scale`` and ``* gain`` in the dtype.
* ``_rotary``: frequencies, angles, ``cos`` and ``sin`` in fp32, cast
  to the dtype, products in the dtype.
* attention scores: a dtype matmul (fp32 accumulation, one rounding),
  then the divide by ``sqrt(d_head)`` in the dtype, the causal mask at
  ``finfo(dtype).min``, the softmax on the fp32 upcast and the weights
  rounded back to the dtype.
* GELU is the tanh approximation (``jax.nn.gelu``'s default).
* ``tied_readout``: bf16 operands upcast to fp32 and one fp32 matmul —
  products of bf16 values are exact in fp32, so this is the
  reference's bf16-operand, fp32-accumulate dot.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from kvedge_torch.models.config import TransformerConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype must be one of {sorted(_DTYPES)}, got {name!r}"
        ) from None


def init_params(seed: int, cfg: TransformerConfig) -> dict[str, np.ndarray]:
    """The fp32 param tree, made with numpy from ``seed``.

    Same keys, shapes and scales as the reference's ``init_params``
    (normal(0, 1) times 0.02 for the embedding, ``fan_in ** -0.5`` for
    the projections, ones for the norm gains); the draws come from
    ``np.random.default_rng(seed)``, so the values are the port's own.
    """
    cfg.validate()
    d, h, kv, dh, f, layers = (
        cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_head, cfg.d_ff,
        cfg.n_layers,
    )
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    return {
        "embedding": normal((cfg.vocab, d), 0.02),
        "w_qkv": normal((layers, d, (h + 2 * kv) * dh), d ** -0.5),
        "w_out": normal((layers, h * dh, d), (h * dh) ** -0.5),
        "ln_attn": np.ones((layers, d), np.float32),
        "ln_mlp": np.ones((layers, d), np.float32),
        "ln_final": np.ones((d,), np.float32),
        "w_up": normal((layers, d, f), d ** -0.5),
        "w_down": normal((layers, f, d), f ** -0.5),
    }


def tied_readout(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Weight-tied logits, fp32: ``x [..., D] @ embedding [V, D].T``."""
    return torch.matmul(x.float(), embedding.float().t())


def stacked_layer_params(params: dict, cfg: TransformerConfig) -> tuple:
    """The per-layer tensors in the order the layer bodies unpack them."""
    return (
        params["w_qkv"], params["w_out"], params["w_up"], params["w_down"],
        params["ln_attn"], params["ln_mlp"],
    )


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    scale = torch.rsqrt(
        torch.mean(torch.square(x.float()), dim=-1, keepdim=True) + 1e-6
    )
    return (x * scale.to(x.dtype)) * gain.to(x.dtype)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the head dim of x ``[B, T, H, Dh]``.

    ``positions`` is ``[T]`` (shared by every row) or ``[B, T]`` (each
    decode row at its own position)."""
    dh = x.shape[-1]
    half = dh // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (log_base.to(x.device) / half)
    )
    angles = positions.to(torch.float32)[..., None] * freqs  # [.., T, half]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]  # broadcast over heads
    sin = sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def split_qkv(cfg: TransformerConfig, qkv: torch.Tensor):
    """Split a fused ``[..., (H+2K)*Dh]`` projection into q/k/v heads."""
    *lead, _ = qkv.shape
    h, kv, dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
    q = qkv[..., : h * dh].reshape(*lead, h, dh)
    k = qkv[..., h * dh:(h + kv) * dh].reshape(*lead, kv, dh)
    v = qkv[..., (h + kv) * dh:].reshape(*lead, kv, dh)
    return q, k, v


def score_divisor(d_head: int, dtype: torch.dtype) -> float:
    """``sqrt(d_head)`` rounded to the compute dtype, as the reference's
    ``scores / (dh ** 0.5)`` converts its Python scalar to the array's
    dtype before dividing."""
    return torch.tensor(math.sqrt(d_head), dtype=dtype).item()


def scale_scores(scores: torch.Tensor, d_head: int) -> torch.Tensor:
    """The divide by ``sqrt(d_head)`` in the scores' dtype: an fp32
    division of the upcast scores by the dtype-rounded divisor, rounded
    back once."""
    div = score_divisor(d_head, scores.dtype)
    return (scores.float() / div).to(scores.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, w_up, w_down, ln_mlp) -> torch.Tensor:
    """The MLP half of a block, residual included."""
    normed = _rmsnorm(x, ln_mlp)
    return x + gelu(normed @ w_up) @ w_down


def _layer(cfg: TransformerConfig, x: torch.Tensor, layer_params) -> torch.Tensor:
    """One pre-norm block with naive causal attention; x ``[B, T, D]``."""
    w_qkv, w_out, w_up, w_down, ln_attn, ln_mlp = layer_params
    batch, seq, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
    dtype = x.dtype

    q, k, v = split_qkv(cfg, _rmsnorm(x, ln_attn) @ w_qkv)
    positions = torch.arange(seq, device=x.device)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    if kv != h:
        # Head h reads kv head h // group (split_qkv's kv-major layout).
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    scores = scale_scores(torch.einsum("bqhd,bkhd->bhqk", q, k), dh)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, torch.finfo(dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    attended = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    x = x + attended.reshape(batch, seq, h * dh) @ w_out
    return mlp(x, w_up, w_down, ln_mlp)


def forward(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, T]`` int -> logits ``[B, T, V]`` fp32.

    The naive-attention forward pass: the in-port oracle that paged
    decode is held to (paged greedy tokens == this pass's argmax)."""
    x = params["embedding"][tokens]
    stacked = stacked_layer_params(params, cfg)
    with torch.no_grad():
        for layer in range(cfg.n_layers):
            x = _layer(cfg, x, tuple(p[layer] for p in stacked))
        x = _rmsnorm(x, params["ln_final"])
        return tied_readout(x, params["embedding"])
