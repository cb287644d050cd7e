"""kvedge-torch: the kvedge serving payload in PyTorch and CUDA for Hopper.

A second package beside ``kvedge_tpu``, which stays as it is and is the
reference. This package ports the reference's main path slice by slice;
the first slice is the paged ``serve`` payload: ``POST /generate`` over
a continuous-batching server, a paged KV cache, the flagship decoder,
and one hand-written CUDA kernel for single-query paged decode attention
(``ops/csrc/paged_decode.cu``).

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
