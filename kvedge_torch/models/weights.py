"""The weight bridge: a numpy param tree -> the port's params.

The tree is the reference's layout (``init_params`` keys, layer-stacked
``[L, ...]`` shapes) as numpy arrays — a JAX tree through ``np.asarray``
or the port's own numpy ``init_params``. No transposes: both frameworks
compute ``x @ w`` with ``w`` as ``[in, out]``.

Each weight is cast to the compute dtype ONCE here. The reference casts
its fp32 master weights per use (``w.astype(dtype)``); one
round-to-nearest cast of the same fp32 values gives the same bits. The
one exception is an MoE tree's ``router``: the reference routes on
``x.astype(float32) @ router.astype(float32)``, so the router stays
fp32 (a bf16 router would move tokens to other experts).
"""

from __future__ import annotations

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.transformer import torch_dtype

# Kept in fp32 whatever the compute dtype (module doc).
_FP32_KEYS = ("router",)


def expected_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    """Key -> shape of the tree ``init_params`` builds: the dense FFN's
    ``w_up`` / ``w_down``, or with ``cfg.n_experts`` the ``router`` and
    the stacked experts in their place."""
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    if cfg.n_experts:
        e = cfg.n_experts
        ffn = {"router": (L, d, e), "w_up_experts": (L, e, d, f),
               "w_down_experts": (L, e, f, d)}
    else:
        ffn = {"w_up": (L, d, f), "w_down": (L, f, d)}
    return {
        "embedding": (cfg.vocab, d),
        "w_qkv": (L, d, (h + 2 * kv) * dh),
        "w_out": (L, h * dh, d),
        **ffn,
        "ln_attn": (L, d),
        "ln_mlp": (L, d),
        "ln_final": (d,),
    }


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device: torch.device | str,
                      dtype: torch.dtype | None = None) -> dict:
    """``tree`` (key -> fp32 array-like) -> dict of ``dtype`` tensors on
    ``device`` (``dtype`` defaults to the config's compute dtype; an MoE
    ``router`` stays fp32).

    Refuses a tree with missing or extra keys or a wrong shape: a
    silently mis-shaped weight would serve garbage, not fail."""
    cfg.validate()
    dtype = dtype or torch_dtype(cfg.dtype)
    want = expected_shapes(cfg)
    if set(tree) != set(want):
        kind = f"MoE, {cfg.n_experts} experts" if cfg.n_experts else "dense"
        raise ValueError(
            f"param tree keys {sorted(tree)} != expected {sorted(want)} "
            f"(the configured model is {kind})"
        )
    out = {}
    for key, shape in want.items():
        arr = np.array(tree[key], dtype=np.float32)  # a writable copy
        if arr.shape != shape:
            raise ValueError(
                f"param {key!r} has shape {arr.shape}, config wants {shape}"
            )
        out[key] = torch.from_numpy(arr).to(
            device=device,
            dtype=torch.float32 if key in _FP32_KEYS else dtype)
    return out


def sharded_params(tree: dict, cfg: TransformerConfig,
                   device: torch.device | str, mesh) -> dict:
    """:func:`params_from_numpy` of the full ``tree``, cut to this rank's
    slices under ``mesh`` (``parallel/sharding.shard_params``: whole
    heads over ``model``, whole layers over ``stage``, whole experts
    over ``expert``; the whole tree without such an axis), each slice a
    tensor of its own on ``device``: the serving weights of one rank of
    a sharded slice."""
    from kvedge_torch.parallel.sharding import shard_params

    full = params_from_numpy(tree, cfg, "cpu")
    return {k: v.contiguous().to(device)
            for k, v in shard_params(mesh, full, cfg).items()}
