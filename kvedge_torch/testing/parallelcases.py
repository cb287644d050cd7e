"""Cases a gloo world runs (``testing/world.run_world``): each function
takes numpy inputs, builds its mesh over the world, runs the port's
parallel code on this rank's block, and returns numpy results the caller
assembles and holds against the JAX package. Every rank calls every
collective in the same order; a refusal is returned as its message."""

from __future__ import annotations

import numpy as np
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.training import (
    loss_and_grads,
    make_train_step,
    master_params,
)
from kvedge_torch.parallel import distributed
from kvedge_torch.parallel.mesh import build_mesh
from kvedge_torch.parallel.ringattention import local_block, ring_attention
from kvedge_torch.parallel.sharding import (
    gather_params,
    shard_batch,
    shard_params,
)
from kvedge_torch.parallel.ulysses import ulysses_attention
from kvedge_torch.runtime.config import MeshSpec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _placed(block: torch.Tensor, like: torch.Tensor, mesh) -> np.ndarray:
    """``block`` written into a zero global-shaped fp32 array: summed over
    the ranks, the blocks assemble the global tensor."""
    full = torch.zeros(like.shape, dtype=torch.float32)
    local_block(full, mesh).copy_(block.float())
    return full.numpy()


def attention_cases(cases: list) -> list:
    """``{"kind": "ring" | "ulysses", "axes", "q", "k", "v", "dout",
    "dtype"}`` -> ``{"out", "dq", "dk", "dv"}`` (global-shaped, this
    rank's block filled) or ``{"error": message}``."""
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    results = []
    for case in cases:
        mesh = build_mesh(MeshSpec(tuple(case["axes"])))
        dtype = _DTYPES[case.get("dtype", "float32")]
        q, k, v = (torch.tensor(case[n]).to(dtype).requires_grad_(True)
                   for n in ("q", "k", "v"))
        try:
            out = fns[case["kind"]](q, k, v, mesh)
        except ValueError as e:
            results.append({"error": str(e)})
            continue
        dout = local_block(torch.tensor(case["dout"]), mesh)
        (out.float() * dout).sum().backward()
        results.append({"out": _placed(out.detach(), q, mesh),
                        **{name: t.grad.float().numpy()
                           for name, t in (("dq", q), ("dk", k), ("dv", v))}})
    return results


def train_cases(cases: list) -> list:
    """``{"axes", "cfg" (TransformerConfig fields), "params" (numpy
    tree), "batches" (global [B, T+1] arrays)}`` -> ``{"losses",
    "grads", "params"}``: a train step a batch on this rank's slices and
    rows, the loss after each, the gathered gradients of the first batch
    as the first step hands them to AdamW (every rank's: a replicated
    leaf is this rank's own copy), and (rank 0 only) the gathered params
    after the last step; or ``{"error": message}``."""
    results = []
    for case in cases:
        mesh = build_mesh(MeshSpec(tuple(case["axes"])))
        cfg = TransformerConfig(**case["cfg"])
        params = master_params(case["params"], cfg, "cpu", mesh)
        init_opt, step = make_train_step(cfg, "cpu", mesh)
        opt_state = init_opt(params)
        losses = []
        try:
            _, grads = loss_and_grads(
                params, shard_batch(mesh, torch.as_tensor(case["batches"][0])),
                cfg, mesh)
            grads = gather_params(mesh, grads, cfg)
            for batch in case["batches"]:
                local = shard_batch(mesh, torch.as_tensor(batch))
                params, opt_state, loss = step(params, opt_state, local)
                losses.append(float(loss))
        except ValueError as e:
            results.append({"error": str(e)})
            continue
        full = gather_params(mesh, params, cfg)
        first = distributed.rank() == 0
        results.append({
            "losses": losses,
            "grads": {k: v.numpy() for k, v in grads.items()},
            "params": ({k: v.numpy() for k, v in full.items()}
                       if first else None)})
    return results


def shard_round_trip(axes, cfg_fields: dict, tree: dict) -> dict:
    """:func:`shard_params` then :func:`gather_params` of a numpy tree,
    with the shapes of this rank's slices."""
    mesh = build_mesh(MeshSpec(tuple(axes)))
    cfg = TransformerConfig(**cfg_fields)
    local = shard_params(mesh, {k: torch.tensor(v) for k, v in tree.items()},
                         cfg)
    full = gather_params(mesh, local, cfg)
    return {"shapes": {k: tuple(v.shape) for k, v in local.items()},
            "full": {k: v.numpy() for k, v in full.items()}}


def stash_cases(cases: list) -> list:
    """``{"axes", "cfg", "params", "batch"}`` of a 1F1B config ->
    ``{"peak", "depth"}``: the most stage inputs this rank's stash held
    at once over one ``loss_and_grads``, and its ring's depth."""
    from kvedge_torch.parallel import pipeline1f1b

    results = []
    real = pipeline1f1b._Stash
    stashes = []

    class Recording(real):
        def __init__(self, depth):
            super().__init__(depth)
            self.peak = 0
            stashes.append(self)

        def put(self, i, x):
            super().put(i, x)
            self.peak = max(self.peak,
                            sum(s is not None for s in self.slots))

    pipeline1f1b._Stash = Recording
    try:
        for case in cases:
            mesh = build_mesh(MeshSpec(tuple(case["axes"])))
            cfg = TransformerConfig(**case["cfg"])
            params = master_params(case["params"], cfg, "cpu", mesh)
            loss_and_grads(params, shard_batch(
                mesh, torch.as_tensor(case["batch"])), cfg, mesh)
            results.append({"peak": stashes[-1].peak,
                            "depth": len(stashes[-1].slots)})
    finally:
        pipeline1f1b._Stash = real
    return results


def families(attention: list = (), train: list = (),
             round_trips: list = (), payloads: list = (),
             stash: list = ()) -> dict:
    """Every case family in one world: ``{"attention": ..., "train":
    ..., "round_trips": ..., "payloads": ..., "stash": ...}`` (a round
    trip is ``(axes, cfg fields, tree)``)."""
    return {"attention": attention_cases(list(attention)),
            "train": train_cases(list(train)),
            "round_trips": [shard_round_trip(*case) for case in round_trips],
            "payloads": payload_cases(list(payloads)),
            "stash": stash_cases(list(stash))}


def payload_cases(cases: list) -> list:
    """``{"toml", "kind": "devicecheck" | "transformer-probe" | "train" |
    "eval", "tokens"}`` -> each payload's result on this rank, at fp32
    on the CPU: ``{"ok", "error", "value", "mesh_shape"}`` (``value`` the
    probe's loss, the train's final or the eval's mean loss, or the
    device check's checksum)."""
    from kvedge_torch.runtime import probes, train
    from kvedge_torch.runtime.config import RuntimeConfig
    from kvedge_torch.runtime.devicecheck import run_device_check

    results = []
    for case in cases:
        cfg = RuntimeConfig.parse(case["toml"])
        check = run_device_check(cfg, "cpu")
        if case["kind"] == "transformer-probe":
            out = probes.run_transformer_probe(cfg, "cpu", "float32",
                                               tokens=case.get("tokens"))
            value, ok, error = out.probe_checksum, out.ok, out.error
        elif case["kind"] in ("train", "eval"):
            run = (train.run_train_payload if case["kind"] == "train"
                   else train.run_eval_payload)
            out = run(cfg, device="cpu", dtype="float32")
            value, ok, error = out.loss, out.ok, out.error
        else:
            value, ok, error = check.probe_checksum, check.ok, check.error
        results.append({"ok": ok, "error": error, "value": value,
                        "mesh_shape": tuple(check.mesh_shape),
                        "device_count": check.device_count})
    return results
