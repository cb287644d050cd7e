"""Model shape: the port's own copy of ``TransformerConfig`` and ``PRESETS``.

The fields, ``d_head``, ``kv_heads``, ``param_count`` and ``validate``
follow the JAX package's ``models/transformer.py`` for the fields the
serving and training slices use, with the same validation messages.
``pipeline_stages > 1`` shards the layer stack over a ``stage`` mesh
axis (``L/S`` whole layers a stage) and trains through a pipeline
schedule: ``"gpipe"`` (``parallel/pipeline.py``, the forward schedule
with its backward run in reverse) or ``"1f1b"``
(``parallel/pipeline1f1b.py``, one fused forward and backward schedule
with a stash of at most ``2S`` stage inputs), over
``pipeline_microbatches`` microbatches (0 = one a stage). 1F1B refuses
MoE layers, sequence-parallel attention and ``fused_xent`` at
validation, with the reference's messages.

``n_experts > 0`` makes every layer's FFN a mixture of switch-routed
experts (``models/moe.py``): top-``expert_top_k`` routing, a capacity of
``ceil(k * tokens / E * expert_capacity_factor)`` slots an expert in
training, dropless per-token routing in serving, and the router's
load-balancing loss added to the training loss at ``moe_aux_weight``.

``attention`` picks the training and full-sequence attention:
``"naive"`` materializes the ``[T, T]`` scores in plain torch;
``"flash"`` runs the hand-written flash kernels (``ops/attention.py``);
``"ring"`` and ``"ulysses"`` shard the sequence over the mesh's ``seq``
axis (``parallel/ringattention.py``, ``parallel/ulysses.py``) and need
the mesh passed to the forward and the train step.
``remat`` recomputes each layer in backward (``torch.utils.checkpoint``)
instead of saving its activations: ``remat_policy="full"`` saves nothing
of the layer, ``"dots"`` saves the outputs of its non-batched products
and recomputes the rest (the reference's
``dots_with_no_batch_dims_saveable``). ``fused_xent`` trains through
the hand-written fused cross-entropy kernels (``ops/xent.py``): no
``[B*T, V]`` logits tensor exists in either pass.

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
    # Training (module doc).
    remat: bool = True
    remat_policy: str = "full"
    attention: str = "naive"
    fused_xent: bool = False
    # Mixture-of-experts FFN (module doc): 0 = dense.
    n_experts: int = 0
    # Per-expert slot headroom in training: capacity = ceil(k * tokens /
    # E * factor); dispatches past it are dropped.
    expert_capacity_factor: float = 1.25
    # Experts per token: 1 = Switch (raw gate), 2 = GShard (the pair's
    # gates normalised; first choices take capacity first).
    expert_top_k: int = 1
    # Weight of the router's load-balancing loss in the training loss.
    moe_aux_weight: float = 0.01
    # Pipelining (module doc): 0 = off; with S > 1 the layer stack
    # shards over a ``stage`` mesh axis.
    pipeline_stages: int = 0
    # Microbatches a step under pipelining; 0 = one a stage. More shrink
    # the bubble (M / (M + S - 1)).
    pipeline_microbatches: int = 0
    # "gpipe" or "1f1b" (module doc); training only.
    pipeline_schedule: str = "gpipe"

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
        per_layer = d * (h + 2 * kv) * dh + h * dh * d + 2 * d
        if self.n_experts:
            per_layer += d * self.n_experts * (1 + 2 * f)  # router + experts
        else:
            per_layer += 2 * d * f
        return v * d + L * per_layer + d

    @property
    def needs_mesh(self) -> bool:
        """True when the mesh is required by the forward and the train
        step: sequence-parallel attention, MoE layers, the pipelines and
        the fused cross-entropy (the reference's rule; every model
        function of the port takes a mesh, ``NO_MESH`` by default)."""
        return (self.attention in ("ring", "ulysses")
                or self.n_experts > 0 or self.pipeline_stages > 1
                or self.fused_xent)

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
        if self.attention not in ("naive", "flash", "ring", "ulysses"):
            raise ValueError(
                "attention must be 'naive', 'flash', 'ring', or "
                f"'ulysses', got {self.attention!r}"
            )
        if self.n_experts < 0:
            raise ValueError("n_experts must be >= 0 (0 = dense FFN)")
        if self.n_experts and self.expert_capacity_factor <= 0:
            raise ValueError("expert_capacity_factor must be > 0")
        if self.n_experts:
            if self.expert_top_k not in (1, 2):
                raise ValueError("expert_top_k must be 1 or 2")
            if self.expert_top_k > self.n_experts:
                raise ValueError(
                    f"expert_top_k {self.expert_top_k} needs at least "
                    f"that many experts (n_experts={self.n_experts})"
                )
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got "
                f"{self.remat_policy!r}"
            )
        if self.pipeline_stages < 0:
            raise ValueError("pipeline_stages must be >= 0 (0 = off)")
        if self.pipeline_microbatches < 0:
            raise ValueError(
                "pipeline_microbatches must be >= 0 (0 = one per stage)"
            )
        if (self.pipeline_stages > 1
                and self.n_layers % self.pipeline_stages):
            raise ValueError(
                f"n_layers {self.n_layers} must divide by "
                f"pipeline_stages {self.pipeline_stages}"
            )
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                "pipeline_schedule must be 'gpipe' or '1f1b', got "
                f"{self.pipeline_schedule!r}"
            )
        if self.pipeline_schedule == "1f1b":
            if self.n_experts:
                raise ValueError(
                    "pipeline_schedule='1f1b' does not support MoE "
                    "layers (use 'gpipe')"
                )
            if self.attention in ("ring", "ulysses"):
                raise ValueError(
                    "pipeline_schedule='1f1b' does not compose with "
                    "sequence-parallel attention (use 'gpipe')"
                )
            if self.fused_xent:
                raise ValueError(
                    "pipeline_schedule='1f1b' computes its loss head "
                    "inside the pipeline's manual region, where the "
                    "Pallas fused-xent kernel cannot run (use 'gpipe' "
                    "or disable fused_xent)"
                )


# Named model shapes, the same table as the JAX package's: "probe" is
# the tiny machinery-verification shape, "flagship" the 41.6M-parameter
# model every serving number describes.
PRESETS: dict[str, dict] = {
    "probe": dict(vocab=512, d_model=128, n_heads=4, n_kv_heads=0,
                  n_layers=2, d_ff=512),
    "flagship": dict(vocab=32000, d_model=512, n_heads=8, n_kv_heads=0,
                     n_layers=8, d_ff=2048),
}
