"""The ``train`` and ``eval`` payloads.

The counterparts of the JAX package's ``run_train_payload`` and
``run_eval_payload`` (``runtime/workload.py``) for one device:

* ``train`` trains ``[payload] steps`` total steps over the ``corpus``
  token file, checkpointing through the state directory. A rerun
  restores the latest checkpoint and reopens the feeder at exactly that
  batch, so steps count from 0 across all runs. Progress goes to
  ``<state_dir>/train-progress.json`` (atomic, throttled to once a second
  and always written at the last step; a non-finite loss is recorded as
  null). A non-finite final loss fails the payload: "training diverged".
* ``eval`` restores the latest checkpoint as ``serve`` does (the fresh
  seed-0 init when there is none) and reports the mean next-token loss
  over ``steps`` batches of ``eval_corpus`` from batch 0, falling back to
  the training corpus with a loud warning. It prints
  ``[kvedge-eval] checkpoint_step=... batches=... held_out=... loss=...
  ppl=...``.

Batch tokens fold into the vocabulary (``% vocab``), as the reference's
do. Both payloads run on the card unless the CPU is asked for, and
raise without one.

Across processes (``[distributed]``, joined at boot by
``parallel/distributed.py``) both run on the mesh of ``[mesh]`` over the
world (``parallel/mesh.py``), with the model derived from it
(``RuntimeConfig.model_config``) and the reference's feed geometry
(:func:`feed_geometry`): the global batch divides by the ``data`` axis,
each rank reads its ``batch / data`` rows at ``data_index * rows``
through the feeder's ``global_batch`` and ``shard_offset`` (ranks that
share a data index read the same rows), and a world of more than one
pod needs ``[runtime] checkpoint_dir`` on storage every rank reaches
(the local ranks of one pod share its state dir, as one reference host
does). Checkpoints are the global tree, written by global rank 0
(``runtime/checkpoint.py``), and so is the progress file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import torch

from kvedge_torch.data.feeder import open_feeder
from kvedge_torch.models.training import master_params, run_training
from kvedge_torch.models.transformer import global_loss, init_params, loss_fn
from kvedge_torch.models.weights import expected_shapes
from kvedge_torch.parallel.distributed import rank
from kvedge_torch.parallel.mesh import build_mesh
from kvedge_torch.runtime.checkpoint import StateCheckpointer
from kvedge_torch.runtime.config import MeshConfigError, RuntimeConfig
from kvedge_torch.runtime.devicecheck import (
    DeviceCheckResult,
    resolve_device,
    run_device_check,
)

TRAIN_PROGRESS_FILE = "train-progress.json"


@dataclasses.dataclass
class PayloadResult:
    """What a payload reports: ``ok``/``error`` as the reference's device
    check result carries them, and the run's numbers."""

    ok: bool
    error: str = ""
    step: int | None = None  # train: the last step; eval: the checkpoint's
    loss: float = float("nan")  # train: the final loss; eval: the mean
    losses: list = dataclasses.field(default_factory=list)
    resumed_from: int | None = None
    held_out: bool | None = None
    elapsed_ms: float = 0.0


def write_train_progress(state_dir: str, doc: dict) -> None:
    """Atomically persist the latest training progress document."""
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, TRAIN_PROGRESS_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)


def read_train_progress(state_dir: str) -> dict | None:
    try:
        with open(os.path.join(state_dir, TRAIN_PROGRESS_FILE),
                  encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def _batches(feeder, vocab: int, device):
    for batch in feeder:
        yield torch.from_numpy(batch % vocab).to(device, torch.long)


def feed_geometry(cfg: RuntimeConfig, mesh, kind: str):
    """``(error | None, (rows, shard_offset))``: the reference's
    ``_feed_geometry`` prechecks, with its messages, for the mesh this
    rank runs (module doc)."""
    data = mesh.size("data")
    if cfg.train_batch % data:
        return (f"[payload] batch = {cfg.train_batch} must divide by the "
                f"mesh's data axis size ({data}) — it is the global "
                "batch, sharded across data-parallel devices"), None
    if cfg.num_processes > 1 and not cfg.checkpoint_dir:
        return (f"multi-host {kind} needs [runtime] checkpoint_dir on "
                "shared storage (a shared-filesystem mount): per-host "
                "PVCs cannot hold a slice-wide checkpoint"), None
    rows = cfg.train_batch // data
    return None, (rows, mesh.index("data") * rows)


def restore_latest_params(cfg: RuntimeConfig, tcfg, seed: int = 0):
    """(step | None, numpy param tree) from the latest checkpoint, or
    (None, the fresh ``init_params(seed)``) when there is none. The
    optimizer moments are neither read nor checked."""
    ckpt = StateCheckpointer(cfg.state_dir, checkpoint_dir=cfg.checkpoint_dir)
    restored = ckpt.restore_latest({"params": expected_shapes(tcfg)},
                                   params_only=True)
    if restored is None:
        return None, init_params(seed, tcfg)
    step, tree = restored
    return step, {k: v.cpu().numpy() for k, v in tree["params"].items()}


def run_train_payload(cfg: RuntimeConfig, device=None,
                      dtype: str = "bfloat16",
                      check: DeviceCheckResult | None = None
                      ) -> PayloadResult:
    """The ``train`` payload (module doc). ``check`` is the device check
    the caller already made (boot makes it against the config); None
    makes one here."""
    dev = resolve_device(device)
    if check is None:
        check = run_device_check(device=dev)
    if not check.ok:
        return PayloadResult(ok=False, error=check.error)
    if not cfg.train_corpus:
        return PayloadResult(
            ok=False, error="[payload] kind = 'train' requires corpus = "
            "'<path>' (a KVFEED01 token file, typically on the state volume)")
    try:
        tcfg = cfg.model_config(dtype, dev)
    except MeshConfigError as e:
        return PayloadResult(ok=False, error=str(e))
    mesh = build_mesh(cfg.mesh)
    error, geometry = feed_geometry(cfg, mesh, "train")
    if error is not None:
        return PayloadResult(ok=False, error=error)
    rows, offset = geometry
    try:
        # The feeder starts at the batch the restored step consumes next.
        resume_step = StateCheckpointer(
            cfg.state_dir, checkpoint_dir=cfg.checkpoint_dir).latest_step() or 0
        feeder = open_feeder(cfg.train_corpus, batch=rows,
                             seq=cfg.max_seq, start_batch=resume_step,
                             global_batch=cfg.train_batch,
                             shard_offset=offset)
        last_write = 0.0
        writer = rank() == 0

        def on_step(step: int, loss: float) -> None:
            # Best-effort telemetry from global rank 0, throttled off the
            # hot loop; a failed write never aborts healthy training.
            nonlocal last_write
            now = time.time()
            if not writer or (step < cfg.train_steps
                              and now - last_write < 1.0):
                return
            last_write = now
            try:
                write_train_progress(cfg.state_dir, {
                    "step": step,
                    "target_steps": cfg.train_steps,
                    "loss": round(loss, 6) if math.isfinite(loss) else None,
                    "ts": now,
                })
            except OSError:
                pass

        start = time.perf_counter()
        result = run_training(
            tcfg, cfg.state_dir, num_steps=cfg.train_steps,
            batches=_batches(feeder, tcfg.vocab, dev),
            checkpoint_every=cfg.train_checkpoint_every, on_step=on_step,
            checkpoint_dir=cfg.checkpoint_dir, device=dev, mesh=mesh)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
    except Exception as e:  # reported in the result, as the reference does
        return PayloadResult(ok=False, error=f"train payload failed: {e!r}")
    final_loss = result.losses[-1] if result.losses else float("nan")
    out = PayloadResult(ok=True, step=result.step,
                        loss=final_loss if result.losses else 0.0,
                        losses=result.losses,
                        resumed_from=result.resumed_from,
                        elapsed_ms=elapsed_ms)
    if result.losses and not math.isfinite(final_loss):
        out.ok = False
        out.error = f"training diverged: loss {final_loss}"
    return out


def run_eval_payload(cfg: RuntimeConfig, device=None,
                     dtype: str = "bfloat16",
                     check: DeviceCheckResult | None = None
                     ) -> PayloadResult:
    """The ``eval`` payload (module doc). ``check`` is the device check
    the caller already made (boot makes it against the config); None
    makes one here."""
    dev = resolve_device(device)
    if check is None:
        check = run_device_check(device=dev)
    if not check.ok:
        return PayloadResult(ok=False, error=check.error)
    if not (cfg.eval_corpus or cfg.train_corpus):
        return PayloadResult(
            ok=False, error="[payload] kind = 'eval' requires corpus = "
            "'<path>' or eval_corpus = '<path>' (a KVFEED01 token file; "
            "eval_corpus is the held-out split)")
    try:
        tcfg = cfg.model_config(dtype, dev)
    except MeshConfigError as e:
        return PayloadResult(ok=False, error=str(e))
    mesh = build_mesh(cfg.mesh)
    error, geometry = feed_geometry(cfg, mesh, "eval")
    if error is not None:
        return PayloadResult(ok=False, error=error)
    rows, offset = geometry
    try:
        step, tree = restore_latest_params(cfg, tcfg)
        params = master_params(tree, tcfg, dev, mesh)
        held_out = bool(cfg.eval_corpus)
        if not held_out:
            print(
                "[kvedge-eval] WARNING: no [payload] eval_corpus set — "
                "evaluating on the TRAINING corpus; this number is "
                "training loss, NOT held-out loss",
                flush=True,
            )
        feeder = open_feeder(cfg.eval_corpus or cfg.train_corpus,
                             batch=rows, seq=cfg.max_seq,
                             global_batch=cfg.train_batch,
                             shard_offset=offset)
        batches = _batches(feeder, tcfg.vocab, dev)
        start = time.perf_counter()
        total = 0.0
        with torch.no_grad():
            for _ in range(cfg.train_steps):
                total += float(global_loss(
                    loss_fn(params, next(batches), tcfg, mesh), mesh))
        mean_loss = total / cfg.train_steps
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        print(
            f"[kvedge-eval] checkpoint_step={step} batches="
            f"{cfg.train_steps} held_out={held_out} loss={mean_loss:.4f} "
            f"ppl={math.exp(min(mean_loss, 30.0)):.2f}",
            flush=True,
        )
    except Exception as e:  # reported in the result, as the reference does
        return PayloadResult(ok=False, error=f"eval payload failed: {e!r}")
    if not math.isfinite(mean_loss):
        return PayloadResult(ok=False, error=f"eval loss is {mean_loss}",
                             step=step, loss=mean_loss)
    return PayloadResult(ok=True, step=step, loss=mean_loss,
                         held_out=held_out, elapsed_ms=elapsed_ms)
