"""The port's tensor and data parallelism (``kvedge_torch/parallel/
sharding.py``: the partition rules, the Megatron f and g, the gathered
embedding and tied readout, the gradient sums) against the JAX package's
``make_train_step`` on the same mesh, where XLA partitions one global
program.

The port runs in one gloo world of 4 CPU ranks
(``kvedge_torch.testing.world``); the JAX side on the conftest's virtual
CPU devices, its mesh from ``jax.devices()[:4]``. numpy makes the
weights (the port's ``init_params``) and the batches from seeds; both
packages train from the same fp32 tree with the same AdamW. Tolerances,
fp32: every step's loss within 1e-5; every updated parameter within
1e-4, a sixth of the ~6e-4 that two AdamW steps move a weight (Adam's
first steps divide each gradient element by its own magnitude, so an
element whose gradient is near ``eps`` = 1e-8 turns a 1e-9 difference of
summation order into a visible one: one embedding element of 4096 moves
3.9e-5 apart in the GQA case); the first step's gradients, as they reach
AdamW, against ``jax.grad`` of the reference's ``loss_fn`` on the same
mesh within 1e-5 of each leaf's largest magnitude (Adam ignores a
constant scale on a gradient, so only this check sees a leaf's gradient
summed the wrong number of times); the world of 4 against the port in
one process within 1e-6, gradients too; ``shard_params`` then ``gather_params`` exactly;
``fused_xent`` under a model axis refused with the reference's message.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig as TorchConfig
from kvedge_torch.models.training import loss_and_grads
from kvedge_torch.models.training import make_train_step as torch_step
from kvedge_torch.models.training import master_params
from kvedge_torch.models.transformer import init_params as torch_init
from kvedge_torch.parallel.mesh import Mesh
from kvedge_torch.parallel.sharding import abstract_shard_tree
from kvedge_torch.models.weights import expected_shapes
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.models import TransformerConfig, loss_fn, make_train_step
from kvedge_tpu.parallel import build_mesh, shard_batch, shard_params

N = 4
BASE = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=0, n_layers=2,
            d_ff=64, max_seq=16, dtype="float32")
# name -> (axes, model fields)
TRAIN = {
    "data2-model2": ((("data", 2), ("model", 2)), dict(attention="naive")),
    "data2-model2-gqa": ((("data", 2), ("model", 2)),
                         dict(attention="naive", n_kv_heads=2)),
    "data1-model4": ((("data", 1), ("model", 4)), dict(attention="naive")),
    "flash-data2-model2": ((("data", 2), ("model", 2)),
                           dict(attention="flash")),
    "moe-data4": ((("data", 4),), dict(attention="naive", n_experts=4,
                                       expert_top_k=2,
                                       expert_capacity_factor=1.0)),
    # Top-2 at half the drop-free capacity: dispatches are dropped.
    "moe-data2-model2": ((("data", 2), ("model", 2)),
                         dict(attention="naive", n_experts=4,
                              expert_top_k=2,
                              expert_capacity_factor=0.5)),
    "moe-data2-seq2-ring": ((("data", 2), ("seq", 2)),
                            dict(attention="ring", n_experts=4,
                                 expert_capacity_factor=1.0)),
}
STEPS = 2
# Refused: the fused cross-entropy under a model axis above 1.
FUSED_TP = ((("data", 2), ("model", 2)), dict(fused_xent=True))
ROUND_TRIPS = {
    "dense-model4": ((("data", 1), ("model", 4)), dict(n_kv_heads=0)),
    "gqa-model2": ((("data", 2), ("model", 2)), dict(n_kv_heads=2)),
    "moe-model2": ((("model", 2), ("data", 2)), dict(n_experts=4)),
}


def _inputs(fields):
    cfg = dict(BASE, **fields)
    params = torch_init(11, TorchConfig(**cfg))
    rng = np.random.default_rng(12)
    batches = [rng.integers(0, cfg["vocab"], (8, cfg["max_seq"] + 1))
               for _ in range(STEPS)]
    return cfg, params, batches


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    train = []
    for axes, fields in TRAIN.values():
        cfg, params, batches = _inputs(fields)
        train.append(dict(axes=axes, cfg=cfg, params=params,
                          batches=batches))
    cfg, params, batches = _inputs(FUSED_TP[1])
    train.append(dict(axes=FUSED_TP[0], cfg=cfg, params=params,
                      batches=batches[:1]))
    trips = []
    for axes, fields in ROUND_TRIPS.values():
        cfg = dict(BASE, **fields)
        trips.append((axes, cfg, torch_init(13, TorchConfig(**cfg))))
    ranks = run_world("kvedge_torch.testing.parallelcases:families", N,
                      train=train, round_trips=trips,
                      tmp_dir=str(tmp_path_factory.mktemp("shard-world")))
    out = {name: [r["train"][i] for r in ranks]
           for i, name in enumerate([*TRAIN, "fused-xent-model2"])}
    out.update({name: [r["round_trips"][i] for r in ranks]
                for i, name in enumerate(ROUND_TRIPS)})
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's first gradients and train steps on the same
    mesh."""
    axes, fields = TRAIN[name]
    cfg, params, batches = _inputs(fields)
    tcfg = TransformerConfig(**cfg)
    mesh = build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:N])
    step_mesh = mesh if tcfg.needs_mesh else None
    init_opt, step = make_train_step(tcfg, mesh=step_mesh)
    p = shard_params(mesh, {k: jnp.asarray(v) for k, v in params.items()})
    grads = jax.jit(jax.grad(lambda q, b: loss_fn(q, b, tcfg, step_mesh)))(
        p, shard_batch(mesh, jnp.asarray(batches[0], jnp.int32)))
    grads = {k: np.asarray(v) for k, v in grads.items()}
    opt = init_opt(p)
    losses = []
    for batch in batches:
        p, opt, loss = step(p, opt, shard_batch(
            mesh, jnp.asarray(batch, jnp.int32)))
        losses.append(float(loss))
    return losses, grads, {k: np.asarray(v) for k, v in p.items()}


def _assert_grads_close(got, want, rel):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(
            got[key], value, rtol=0,
            atol=rel * float(np.abs(value).max()), err_msg=key)


@pytest.mark.parametrize("name", TRAIN)
def test_train_steps_match_the_reference_on_its_mesh(port, name):
    want_losses, want_grads, want_params = _reference(name)
    losses = {tuple(r["losses"]) for r in port[name]}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    np.testing.assert_allclose(losses.pop(), want_losses, atol=1e-5,
                               rtol=0)
    _assert_grads_close(port[name][0]["grads"], want_grads, 1e-5)
    got = port[name][0]["params"]
    assert set(got) == set(want_params)
    for key in want_params:
        np.testing.assert_allclose(got[key], want_params[key], atol=1e-4,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["data2-model2", "moe-data4"])
def test_world_of_four_equals_one_process(port, name):
    """The port across 4 ranks against the port in one plain process
    (no mesh, no collective) on the same tree and batches."""
    _, fields = TRAIN[name]
    cfg, params, batches = _inputs(fields)
    tcfg = TorchConfig(**cfg)
    p = master_params(params, tcfg, "cpu")
    _, grads = loss_and_grads(p, torch.as_tensor(batches[0]), tcfg)
    _assert_grads_close(port[name][0]["grads"],
                        {k: v.numpy() for k, v in grads.items()}, 1e-6)
    init_opt, step = torch_step(tcfg, "cpu")
    opt = init_opt(p)
    losses = []
    for batch in batches:
        p, opt, loss = step(p, opt, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(port[name][0]["losses"], losses, atol=1e-6,
                               rtol=0)
    for key, value in p.items():
        np.testing.assert_allclose(port[name][0]["params"][key],
                                   value.detach().numpy(), atol=1e-6,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ROUND_TRIPS)
def test_shard_then_gather_is_the_identity(port, name):
    axes, fields = ROUND_TRIPS[name]
    cfg = TorchConfig(**dict(BASE, **fields))
    tree = torch_init(13, cfg)
    mesh = Mesh(tuple(a for a, _ in axes), tuple(s for _, s in axes),
                tuple(0 for _ in axes))
    want_shapes = abstract_shard_tree(mesh, expected_shapes(cfg), cfg)
    for rank in port[name]:
        assert rank["shapes"] == want_shapes
        for key, value in tree.items():
            np.testing.assert_array_equal(rank["full"][key], value,
                                          err_msg=key)


def test_shard_cuts_whole_heads():
    """Rank r's ``w_qkv`` slice holds its own q, k and v heads (each
    segment cut by whole heads), not a contiguous block of columns."""
    from kvedge_torch.parallel.sharding import shard_params as cut

    cfg = TorchConfig(**dict(BASE, n_kv_heads=2))
    tree = torch_init(0, cfg)
    dh = cfg.d_head
    h, kv = cfg.n_heads, cfg.kv_heads
    for r in range(2):
        mesh = Mesh(("data", "model"), (1, 2), (0, r))
        got = cut(mesh, tree, cfg)["w_qkv"]
        w = tree["w_qkv"]
        q = w[..., r * h // 2 * dh:(r + 1) * h // 2 * dh]
        k = w[..., (h + r * kv // 2) * dh:(h + (r + 1) * kv // 2) * dh]
        v = w[..., (h + kv + r * kv // 2) * dh:
              (h + kv + (r + 1) * kv // 2) * dh]
        np.testing.assert_array_equal(got, np.concatenate([q, k, v], -1))


def test_model_axis_refuses_what_it_cannot_cut():
    from kvedge_torch.runtime.config import MeshConfigError, RuntimeConfig

    cfg = dataclasses.replace(RuntimeConfig(), num_processes=4,
                              mesh_axes=(("data", 1), ("model", 4)),
                              n_kv_heads=2)
    with pytest.raises(MeshConfigError, match="kv heads 2 must divide"):
        cfg.model_config()


def test_fused_xent_refuses_a_model_axis_as_the_reference(port):
    from kvedge_tpu.models import loss_fn

    cfg, params, batches = _inputs(FUSED_TP[1])
    mesh = build_mesh(MeshSpec(axes=FUSED_TP[0]), devices=jax.devices()[:N])
    with pytest.raises(ValueError) as theirs:
        loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(batches[0], jnp.int32),
                TransformerConfig(**cfg), mesh)
    assert all(r == {"error": str(theirs.value)}
               for r in port["fused-xent-model2"])
