"""The weight bridge: a numpy param tree -> the port's params.

The tree is the reference's layout (``init_params`` keys, layer-stacked
``[L, ...]`` shapes) as numpy arrays — a JAX tree through ``np.asarray``
or the port's own numpy ``init_params``. No transposes: both frameworks
compute ``x @ w`` with ``w`` as ``[in, out]``.

Each weight is cast to the compute dtype ONCE here. The reference casts
its fp32 master weights per use (``w.astype(dtype)``); one
round-to-nearest cast of the same fp32 values gives the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.transformer import torch_dtype

_KEYS = ("embedding", "w_qkv", "w_out", "w_up", "w_down",
         "ln_attn", "ln_mlp", "ln_final")


def expected_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    return {
        "embedding": (cfg.vocab, d),
        "w_qkv": (L, d, (h + 2 * kv) * dh),
        "w_out": (L, h * dh, d),
        "w_up": (L, d, f),
        "w_down": (L, f, d),
        "ln_attn": (L, d),
        "ln_mlp": (L, d),
        "ln_final": (d,),
    }


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device: torch.device | str,
                      dtype: torch.dtype | None = None) -> dict:
    """``tree`` (key -> fp32 array-like) -> dict of ``dtype`` tensors on
    ``device`` (``dtype`` defaults to the config's compute dtype).

    Refuses a tree with missing or extra keys or a wrong shape: a
    silently mis-shaped weight would serve garbage, not fail."""
    cfg.validate()
    dtype = dtype or torch_dtype(cfg.dtype)
    want = expected_shapes(cfg)
    if set(tree) != set(_KEYS):
        raise ValueError(
            f"param tree keys {sorted(tree)} != expected {sorted(_KEYS)} "
            "(dense decoder; MoE trees are not served by this port)"
        )
    out = {}
    for key in _KEYS:
        arr = np.array(tree[key], dtype=np.float32)  # a writable copy
        if arr.shape != want[key]:
            raise ValueError(
                f"param {key!r} has shape {arr.shape}, config wants "
                f"{want[key]}"
            )
        out[key] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return out
