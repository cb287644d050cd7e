"""The probe payloads: one train step, and cached decode against teacher
forcing.

The counterparts of the JAX package's ``run_transformer_probe`` and
``run_inference_probe`` (``kvedge_tpu/runtime/workload.py``), with its
constants and checks, on one device:

* ``transformer-probe`` runs the device check, then one AdamW train
  step of the ``[model]`` config at ``PROBE_SEQ`` tokens (with ``[payload]
  attention = "flash"`` the step runs the flash kernels forward and
  backward), and holds the loss of the untrained model on random tokens
  within ±50% of ln V; ``probe_checksum`` carries that loss.
* ``inference-probe`` runs the device check, then greedy decode through
  the KV cache (``models/decode.generate``) of a small GQA model, and
  requires every generated token to equal the argmax of the cache-less
  forward pass over the tokens so far; ``probe_checksum`` carries the
  sum of the tokens.

Across processes the transformer probe runs on the mesh of ``[mesh]``
over the world (``parallel/mesh.py``), with the model derived from it:
the batch is ``PROBE_BATCH_PER_DEVICE`` rows a device, each rank
training on its data rows, seq chunk and model slices. The inference
probe decodes there too, through the sharded contiguous decode
(``models/decode.generate(mesh=)``) on the rank's slices of the probe
model (its heads over ``model``, its layers over ``stage``; the dense
probe model has no experts to split, so an ``expert`` rank holds it
whole), held against the full model's teacher-forced forward pass; a
``model`` axis that does not divide the probe's heads, or a ``stage``
axis its layers, fails the probe with its message.

Both return a :class:`DeviceCheckResult` with ``probe_ms``; a failure is
a result with ``ok`` false and the reference's message, never a raise.
Weights come from the port's numpy ``init_params(0)`` and the tokens
from a seeded numpy generator (the reference draws both from JAX's
PRNG); ``params`` and ``tokens`` take another tree and batch.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.runtime.devicecheck import (
    DeviceCheckResult,
    resolve_device,
    run_device_check,
)

# Deliberately tiny: the probe verifies machinery, not throughput.
PROBE_VOCAB = 512
PROBE_D_MODEL = 128
PROBE_LAYERS = 2
PROBE_SEQ = 64
PROBE_BATCH_PER_DEVICE = 2

# Inference probe: small GQA model, short prompt, a few greedy steps.
PROBE_KV_HEADS = 2
PROBE_PROMPT = 8
PROBE_NEW_TOKENS = 4


def transformer_probe_config(cfg: RuntimeConfig, dtype: str = "bfloat16",
                             device=None) -> TransformerConfig:
    """The ``[model]`` config at ``PROBE_SEQ`` tokens."""
    return dataclasses.replace(cfg, max_seq=PROBE_SEQ).model_config(
        dtype, device)


def inference_probe_config(dtype: str = "bfloat16") -> TransformerConfig:
    """The inference probe's fixed model (the reference's)."""
    return TransformerConfig(
        vocab=PROBE_VOCAB, d_model=PROBE_D_MODEL, n_heads=4,
        n_kv_heads=PROBE_KV_HEADS, n_layers=PROBE_LAYERS,
        d_ff=4 * PROBE_D_MODEL, max_seq=PROBE_SEQ, dtype=dtype)


def run_transformer_probe(cfg: RuntimeConfig, device=None,
                          dtype: str = "bfloat16", *, params=None,
                          tokens=None) -> DeviceCheckResult:
    """One train step of the ``[model]`` config (module doc). ``tokens``
    is a global ``[B, PROBE_SEQ + 1]`` batch (default
    ``PROBE_BATCH_PER_DEVICE`` rows a device from ``default_rng(0)``)."""
    # The matmul device check runs first: fail fast on visibility problems
    # with a cheaper, clearer error before building a model.
    base = run_device_check(cfg, device)
    if not base.ok:
        return base

    from kvedge_torch.models.training import make_train_step, master_params
    from kvedge_torch.models.transformer import init_params

    try:
        tcfg = transformer_probe_config(cfg, dtype, resolve_device(device))
    except RuntimeConfigError as e:
        # A healthy runtime with an un-runnable model: a clear config
        # message, not a generic "probe failed" traceback.
        return dataclasses.replace(base, ok=False, error=str(e))
    try:
        from kvedge_torch.parallel.mesh import build_mesh
        from kvedge_torch.parallel.sharding import shard_batch

        dev = resolve_device(device)
        mesh = build_mesh(cfg.mesh)
        tree = params if params is not None else init_params(0, tcfg)
        weights = master_params(tree, tcfg, dev, mesh)
        init_opt, train_step = make_train_step(tcfg, dev, mesh)
        opt_state = init_opt(weights)
        if tokens is None:
            tokens = np.random.default_rng(0).integers(
                0, tcfg.vocab,
                (PROBE_BATCH_PER_DEVICE * base.device_count, PROBE_SEQ + 1))
        batch = shard_batch(mesh, torch.as_tensor(np.array(tokens),
                                                  dtype=torch.long))
        start = time.perf_counter()
        _, _, loss = train_step(weights, opt_state, batch.to(dev))
        loss = float(loss)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
    except Exception as e:
        return dataclasses.replace(
            base, ok=False, error=f"transformer probe failed: {e!r}",
        )

    # Untrained model on random tokens: loss ≈ ln(vocab). Allow a wide band;
    # NaN/inf or wildly-off values mean broken math.
    expected = math.log(tcfg.vocab)
    if not math.isfinite(loss) or abs(loss - expected) > 0.5 * expected:
        return dataclasses.replace(
            base, ok=False,
            error=f"probe loss {loss:.3f} far from ln(V)={expected:.3f}",
        )
    return dataclasses.replace(
        base, probe_ms=elapsed_ms, probe_checksum=loss,
    )


def run_inference_probe(cfg: RuntimeConfig, device=None,
                        dtype: str = "bfloat16", *, params=None,
                        prompt=None) -> DeviceCheckResult:
    """Cached greedy decode == teacher forcing (module doc). ``prompt``
    is a ``[2, PROBE_PROMPT]`` batch (default from ``default_rng(1)``)."""
    base = run_device_check(cfg, device)
    if not base.ok:
        return base

    from kvedge_torch.models.decode import generate
    from kvedge_torch.models.transformer import forward, init_params
    from kvedge_torch.models.weights import params_from_numpy

    from kvedge_torch.models.weights import sharded_params
    from kvedge_torch.parallel.mesh import build_mesh
    from kvedge_torch.parallel.sharding import check_stages

    tcfg = inference_probe_config(dtype)
    try:
        dev = resolve_device(device)
        mesh = build_mesh(cfg.mesh)
        check_stages(tcfg, mesh.size("stage"))
        tree = params if params is not None else init_params(0, tcfg)
        weights = params_from_numpy(tree, tcfg, dev)
        local = sharded_params(tree, tcfg, dev, mesh)
        if prompt is None:
            prompt = np.random.default_rng(1).integers(
                0, tcfg.vocab, (2, PROBE_PROMPT))
        prompt = torch.as_tensor(np.array(prompt), dtype=torch.long,
                                 device=dev)
        with torch.no_grad():
            start = time.perf_counter()
            out = generate(local, prompt, tcfg, n_new=PROBE_NEW_TOKENS,
                           device=dev, mesh=mesh)
            out_host = out.cpu()  # waits for the device
            elapsed_ms = (time.perf_counter() - start) * 1000.0

            # Cross-check every generated token against the cache-less
            # forward pass — the decode path must reproduce training-time
            # math exactly.
            so_far = prompt
            for _ in range(PROBE_NEW_TOKENS):
                nxt = torch.argmax(forward(weights, so_far, tcfg)[:, -1],
                                   dim=-1)
                so_far = torch.cat([so_far, nxt[:, None]], dim=1)
        if not torch.equal(out_host, so_far.cpu()):
            return dataclasses.replace(
                base, ok=False,
                error="inference probe: cached decode disagrees with "
                      "teacher-forced forward pass",
            )
    except Exception as e:
        return dataclasses.replace(
            base, ok=False, error=f"inference probe failed: {e!r}",
        )
    return dataclasses.replace(
        base, probe_ms=elapsed_ms, probe_checksum=float(out_host.sum()),
    )
