"""kvedge-torch: the kvedge payloads in PyTorch and CUDA for Hopper.

A second package beside ``kvedge_tpu``, which stays as it is and is the
reference. This package ports the reference's main path slice by slice:

* the paged ``serve`` payload: ``POST /generate`` over a
  continuous-batching server, a paged KV cache, the flagship decoder,
  and a hand-written CUDA kernel for single-query paged decode attention
  (``ops/csrc/paged_decode.cu``);
* the ``train`` and ``eval`` payloads: the corpus feeder, the loss with
  per-layer remat, optax-ordered AdamW, the port's own checkpoints
  (which ``serve`` restores), and ``attention = "flash"`` as an autograd
  function over three hand-written CUDA kernels, the flash forward and
  its dq and dk/dv backward passes (``ops/csrc/flash_attention.cu``);
* later slices: the fused cross-entropy head and the other kernels of
  the reference, windows and prefill chunks as CUDA graphs,
  speculation, the prefix cache, the scheduler, recovery and
  observability, mixture-of-experts models in serving and training
  (``[model] experts``, ``models/moe.py``) and ``remat_policy =
  "dots"``, and the runtime's boot contract: ``kvedge-runtime boot``
  from a ``#kvedge-boot-config`` document (``bootstrap/``), heartbeats
  with ``boot_count``, the probe payloads, ``/profile`` on
  ``torch.profiler`` and the health probe (``runtime/boot.py``), and
  the GPU deployment: the renderer (``render/``), its chart and image
  (``deployment/gpu/``) and the fake cluster (``testing/``).
  ``ROADMAP.md`` lists what is still to port.

Ground rules, kept by every module here:

* The JAX package is the reference and is not edited. The port imports
  ``torch``, never ``jax``, and nothing of ``kvedge_tpu`` — not even a
  module there that uses no framework. What it needs (the model config
  and presets, the request parser, the serving knobs, the sampling key
  schedule) is copied. Only the tests import both, to hold one against
  the other.
* The card by default. Entry points run on the CUDA device unless the
  caller passes ``device="cpu"`` (``--device cpu``); with no card and no
  explicit CPU request they raise. A kernel wrapper given a CUDA tensor
  launches its kernel or raises; it computes its plain PyTorch version
  only for a CPU tensor. Nothing falls back.
* Float32 on the card is full float32: ``runtime/devicecheck.py``
  switches off TF32 (``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32``) and reduced-precision bf16/fp16
  matmul reductions explicitly, rather than relying on defaults.
* The layout mirrors ``kvedge_tpu`` (``models/``, ``ops/``,
  ``runtime/``) so a module's counterpart is easy to find. Inside, plain
  functions on tensors, an explicit ``device`` argument, and an explicit
  key for every random draw.

Importing the package builds no kernel and touches no device: kernels
compile with ``nvcc`` at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
