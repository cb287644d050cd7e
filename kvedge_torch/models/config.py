"""Model shape: the port's own copy of ``TransformerConfig`` and ``PRESETS``.

The fields, ``d_head``, ``kv_heads`` and ``validate`` follow the JAX
package's ``models/transformer.py`` for the fields the serving slice
uses. Training-only fields (remat, MoE, pipeline, fused cross-entropy,
sequence-parallel attention) are not carried: the slice serves a dense
decoder, and a config naming them is refused rather than ignored.

``paged_attention`` has CUDA semantics here. "auto" means the
hand-written paged-decode kernel (``ops/paged_attention.py``) for every
single-query decode step on a CUDA device, at every page size, and the
plain PyTorch version on the CPU. "kernel" forces the kernel (on a CPU
tensor the wrapper still computes the plain version: there is no kernel
to launch there). "gather" forces the plain version on every device.
The TPU gates of the reference (128-aligned pages and widths, VMEM
budgets, ``max_seq >= 2048``) are TPU layout rules and do not apply.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # Grouped-query attention: number of K/V heads. 0 means n_heads (MHA).
    n_kv_heads: int = 0
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: str = "bfloat16"  # compute dtype: "bfloat16" or "float32"
    # Paged decode attention: "auto" | "kernel" | "gather" (module doc).
    paged_attention: str = "auto"

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def param_count(self) -> int:
        """Exact parameter count of the tree ``init_params`` builds."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        h, kv, dh = self.n_heads, self.kv_heads, self.d_head
        per_layer = d * (h + 2 * kv) * dh + h * dh * d + 2 * d + 2 * d * f
        return v * d + L * per_layer + d

    def validate(self) -> None:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.paged_attention not in ("auto", "kernel", "gather"):
            raise ValueError(
                "paged_attention must be 'auto', 'kernel', or "
                f"'gather', got {self.paged_attention!r}"
            )
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}"
            )
        if self.max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {self.max_seq}")


# Named model shapes, the same table as the JAX package's: "probe" is
# the tiny machinery-verification shape, "flagship" the 41.6M-parameter
# model every serving number describes.
PRESETS: dict[str, dict] = {
    "probe": dict(vocab=512, d_model=128, n_heads=4, n_kv_heads=0,
                  n_layers=2, d_ff=512),
    "flagship": dict(vocab=32000, d_model=512, n_heads=8, n_kv_heads=0,
                     n_layers=8, d_ff=2048),
}
