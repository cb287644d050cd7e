"""The 1F1B schedule (``kvedge_torch/parallel/pipeline1f1b.py``) against
the JAX package's ``pipeline_1f1b_loss_and_grads`` and against the
port's own GPipe: the counterpart of ``tests/test_pipeline1f1b.py``.

The port runs in gloo worlds of 2 and 4 CPU ranks, the JAX side on the
conftest's virtual CPU devices, from the same numpy-made fp32 weights
and batch. On (stage 2), (data 2, stage 2) and (stage 2, model 2), the
first train step's loss within 1e-5 and every gradient within a
relative 1e-4 (its largest difference over its largest magnitude): the
reference test's bounds. Against the port's GPipe on the same world,
the same bounds.

The refusals are config-time (``TransformerConfig.validate``: MoE,
ring or Ulysses, ``fused_xent``) and at the call (no stage axis), with
the reference's messages.

Memory, structurally: the reference measures its compiled peak, which
the port cannot read. Here the schedule's own stash is recorded in the
world at M = S and M = 4S (it never holds more than ``2S`` inputs and
refuses a slot collision), and the tick plan is checked for S up to 4:
every microbatch forwarded and then backwarded once on every stage, at
most ``2S`` in flight, the last stage's backward one tick after its
forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvedge_torch.models.config import TransformerConfig as TorchConfig
from kvedge_torch.models.transformer import init_params as torch_init
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.models import TransformerConfig
from kvedge_tpu.parallel import build_mesh, shard_batch, shard_params
from kvedge_tpu.parallel.pipeline1f1b import pipeline_1f1b_loss_and_grads

BASE = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=0, n_layers=4,
            d_ff=64, max_seq=16, dtype="float32", pipeline_stages=2,
            pipeline_microbatches=4, pipeline_schedule="1f1b")
# name -> (world size, axes)
MESHES = {
    "stage2": (2, (("stage", 2),)),
    "data2-stage2": (4, (("data", 2), ("stage", 2))),
    "stage2-model2": (4, (("stage", 2), ("model", 2))),
}
# The stash at M = S and M = 4S, in the world of 2.
STASH_M = (2, 8)


def _inputs(**over):
    cfg = dict(BASE, **over)
    params = torch_init(31, TorchConfig(**cfg))
    batch = np.random.default_rng(32).integers(
        0, cfg["vocab"], (16, cfg["max_seq"] + 1))
    return cfg, params, batch


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Per mesh: the 1F1B step and the GPipe step; the stash records."""
    root = tmp_path_factory.mktemp("1f1b")
    out = {}
    for n in (2, 4):
        names = [k for k, (size, _) in MESHES.items() if size == n]
        train = []
        for name in names:
            axes = MESHES[name][1]
            for schedule in ("1f1b", "gpipe"):
                cfg, params, batch = _inputs(pipeline_schedule=schedule)
                train.append(dict(axes=axes, cfg=cfg, params=params,
                                  batches=[batch]))
        stash = []
        if n == 2:
            for micro in STASH_M:
                cfg, params, batch = _inputs(pipeline_microbatches=micro)
                stash.append(dict(axes=MESHES["stage2"][1], cfg=cfg,
                                  params=params, batch=batch))
        ranks = run_world("kvedge_torch.testing.parallelcases:families", n,
                          train=train, stash=stash,
                          tmp_dir=str(root / f"world{n}"))
        for i, name in enumerate(names):
            out[name] = {"1f1b": [r["train"][2 * i] for r in ranks],
                         "gpipe": [r["train"][2 * i + 1] for r in ranks]}
        if n == 2:
            out["stash"] = [r["stash"] for r in ranks]
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    axes = MESHES[name][1]
    cfg, params, batch = _inputs()
    tcfg = TransformerConfig(**cfg)
    n = int(np.prod([size for _, size in axes]))
    mesh = build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:n])
    p = shard_params(mesh, {k: jnp.asarray(v) for k, v in params.items()})
    loss, grads = jax.jit(
        lambda q, b: pipeline_1f1b_loss_and_grads(q, b, tcfg, mesh))(
        p, shard_batch(mesh, jnp.asarray(batch, jnp.int32)))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _assert_parity(loss, grads, want_loss, want_grads):
    assert abs(loss - want_loss) < 1e-5
    assert set(grads) == set(want_grads)
    for key, want in want_grads.items():
        err = (np.max(np.abs(grads[key] - want))
               / (np.max(np.abs(want)) + 1e-12))
        assert err < 1e-4, (key, err)


def _steps(ranks):
    """Every rank's (loss, gathered gradients): a replicated leaf's
    gradient is each rank's own copy."""
    assert all("error" not in r for r in ranks), ranks[0]
    losses = {r["losses"][0] for r in ranks}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    return [(r["losses"][0], r["grads"]) for r in ranks]


@pytest.mark.parametrize("name", MESHES)
def test_1f1b_matches_the_reference_schedule(port, name):
    for step in _steps(port[name]["1f1b"]):
        _assert_parity(*step, *_reference(name))


@pytest.mark.parametrize("name", MESHES)
def test_1f1b_matches_the_ports_gpipe(port, name):
    for ours, gpipe in zip(_steps(port[name]["1f1b"]),
                           _steps(port[name]["gpipe"])):
        _assert_parity(*ours, *gpipe)


def test_the_stash_never_holds_more_than_2s(port):
    for micro, per_rank in zip(STASH_M, zip(*port["stash"])):
        for stage, rec in enumerate(per_rank):
            assert rec["depth"] == 4, rec
            # Stage s holds 2(S - s) inputs at once at its peak, when M
            # is large enough to fill the ring: 4 at stage 0, 2 at 1.
            assert rec["peak"] == min(2 * (2 - stage), micro), (micro, rec)


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_the_tick_plan_is_the_references(stages):
    from kvedge_torch.parallel.pipeline1f1b import ticks

    for micro in (stages, 4 * stages):
        last_f = {}
        for stage in range(stages):
            plan = ticks(stages, micro, stage)
            assert len(plan) == micro + 2 * stages - 1
            held, forwarded, backwarded = set(), [], []
            for t, (i_f, i_b) in enumerate(plan):
                if i_f is not None:
                    assert i_f % (2 * stages) not in {
                        i % (2 * stages) for i in held}
                    held.add(i_f)
                    forwarded.append(i_f)
                    if stage == stages - 1:
                        last_f[i_f] = t
                assert len(held) <= 2 * stages
                if i_b is not None:
                    assert i_b in held
                    held.remove(i_b)
                    backwarded.append(i_b)
                    if stage == stages - 1:
                        assert t == last_f[i_b] + 1
            assert forwarded == backwarded == list(range(micro))


def test_refusals_carry_the_references_messages():
    from kvedge_torch.models.training import master_params
    from kvedge_torch.parallel.mesh import Mesh
    from kvedge_torch.parallel.pipeline1f1b import (
        pipeline_1f1b_loss_and_grads as ours,
    )
    import torch

    cfg, params, batch = _inputs()
    for change in (dict(n_experts=4), dict(attention="ring"),
                   dict(attention="ulysses"), dict(fused_xent=True)):
        with pytest.raises(ValueError) as want:
            dataclasses.replace(TransformerConfig(**cfg),
                                **change).validate()
        with pytest.raises(ValueError) as got:
            dataclasses.replace(TorchConfig(**cfg), **change).validate()
        assert str(got.value) == str(want.value), change
    mesh = build_mesh(MeshSpec(axes=(("data", 2),)),
                      devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        pipeline_1f1b_loss_and_grads(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(batch, jnp.int32), TransformerConfig(**cfg), mesh)
    tcfg = TorchConfig(**cfg)
    with pytest.raises(ValueError) as got:
        ours(master_params(params, tcfg, "cpu"), torch.as_tensor(batch),
             tcfg, Mesh(("data",), (2,), (0,)))
    assert str(got.value) == str(want.value)
