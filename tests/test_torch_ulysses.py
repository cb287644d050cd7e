"""The port's Ulysses attention (``kvedge_torch/parallel/ulysses.py``)
against the JAX package's ``ulysses_attention`` on the same mesh.

The port runs in one gloo world of 4 CPU ranks
(``kvedge_torch.testing.world``); the JAX side on the conftest's virtual
CPU devices, its mesh built from ``jax.devices()[:4]`` as
``tests/test_ring_attention.py`` builds it. numpy makes every input from
a seed. Tolerances, fp32: outputs within 1e-5, gradients (the port's
differentiable all-to-all against ``jax.grad`` of the reference) within
1e-4, a train step's loss against the reference's ``loss_fn`` on the
same mesh within 1e-5; ``n_heads % (sp * tp)`` and the other refusals
with the reference's messages; bf16 outputs within 2e-2 (one bf16 rounding of
values of size ~1: 2^-8 relative, doubled for the two packages'
summation orders) and bf16 gradients within 2% of their largest
magnitude.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig as TorchConfig
from kvedge_torch.models.transformer import forward_hidden
from kvedge_torch.models.transformer import init_params as torch_init
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.models import TransformerConfig, forward, loss_fn
from kvedge_tpu.parallel import build_mesh, ulysses_attention

N = 4
B, T, H, DH = 4, 16, 4, 8

# name -> (axes, seed, dtype, seq, heads)
CASES = {
    "sp4": ((("seq", 4),), 0, "float32", T, H),
    "sp2-data2": ((("data", 2), ("seq", 2)), 1, "float32", T, H),
    "sp2-model2": ((("data", 1), ("model", 2), ("seq", 2)), 2, "float32",
                   T, H),
    "sp4-bf16": ((("seq", 4),), 3, "bfloat16", T, H),
    "refuse-indivisible": ((("seq", 4),), 4, "float32", 14, H),
    "refuse-no-seq": ((("data", 4),), 5, "float32", T, H),
    "refuse-heads": ((("model", 2), ("seq", 2)), 6, "float32", T, 2),
}
FP32 = ("sp4", "sp2-data2", "sp2-model2")
REFUSED = ("refuse-indivisible", "refuse-no-seq", "refuse-heads")

MODEL = dict(vocab=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16, dtype="float32", attention="ulysses")
# name -> (axes, n_kv_heads)
TRAIN = {
    "data2-seq2": ((("data", 2), ("seq", 2)), 0),
    "model2-seq2-gqa": ((("model", 2), ("seq", 2)), 2),
}


def _inputs(seed, seq, heads):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, seq, heads, DH)).astype(np.float32)
            for _ in range(4)]


def _train_inputs(n_kv_heads):
    cfg = dict(MODEL, n_kv_heads=n_kv_heads)
    params = torch_init(7, TorchConfig(**cfg))
    batch = np.random.default_rng(8).integers(0, MODEL["vocab"],
                                              (B, MODEL["max_seq"] + 1))
    return cfg, params, batch


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case in one world of 4 ranks; per case, the ranks' results."""
    attention = []
    for axes, seed, dtype, seq, heads in CASES.values():
        q, k, v, dout = _inputs(seed, seq, heads)
        attention.append(dict(kind="ulysses", axes=axes, q=q, k=k, v=v,
                              dout=dout, dtype=dtype))
    train = []
    for axes, kv in TRAIN.values():
        cfg, params, batch = _train_inputs(kv)
        train.append(dict(axes=axes, cfg=cfg, params=params,
                          batches=[batch]))
    ranks = run_world("kvedge_torch.testing.parallelcases:families", N,
                      attention=attention, train=train,
                      tmp_dir=str(tmp_path_factory.mktemp("ulysses-world")))
    out = {name: [r["attention"][i] for r in ranks]
           for i, name in enumerate(CASES)}
    out.update({name: [r["train"][i] for r in ranks]
                for i, name in enumerate(TRAIN)})
    return out


def _assembled(ranks, key):
    """Blocks are disjoint and zero elsewhere: the sum is the tensor."""
    return sum(r[key] for r in ranks)


def _mesh(axes):
    n = int(np.prod([size for _, size in axes]))
    return build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's output and its vjp with ``dout``, jitted once."""
    axes, seed, dtype, seq, heads = CASES[name]
    q, k, v, dout = _inputs(seed, seq, heads)
    mesh = _mesh(axes)

    @jax.jit
    def run(q, k, v, dout):
        out, vjp = jax.vjp(lambda *a: ulysses_attention(*a, mesh), q, k, v)
        return out.astype(jnp.float32), vjp(dout.astype(out.dtype))

    out, grads = run(*(jnp.asarray(x, dtype) for x in (q, k, v, dout)))
    return np.asarray(out), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("name", FP32)
def test_forward_matches_reference(port, name):
    want, _ = _reference(name)
    np.testing.assert_allclose(_assembled(port[name], "out"), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", FP32)
def test_gradients_match_jax_grad(port, name):
    _, want = _reference(name)
    for key, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_assembled(port[name], key), w,
                                   atol=1e-4, rtol=0, err_msg=key)


def test_bf16_within_tolerance(port):
    want, grads = _reference("sp4-bf16")
    np.testing.assert_allclose(_assembled(port["sp4-bf16"], "out"), want,
                               atol=2e-2, rtol=0)
    for key, w in zip(("dq", "dk", "dv"), grads):
        got = _assembled(port["sp4-bf16"], key)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got, w, atol=2e-2 * scale, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_carry_the_reference_messages(port, name):
    axes, seed, _, seq, heads = CASES[name]
    q, k, v, _ = _inputs(seed, seq, heads)
    with pytest.raises(ValueError) as theirs:
        ulysses_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          _mesh(axes))
    assert all(r == {"error": str(theirs.value)} for r in port[name])


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_loss_matches_reference_loss_fn(port, name):
    """One train step's loss (computed before its update) at 2 layers:
    the port's Ulysses across the world against the reference's
    ``loss_fn`` on the same mesh."""
    axes, kv = TRAIN[name]
    cfg, params, batch = _train_inputs(kv)
    want = float(loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(batch, jnp.int32),
                         TransformerConfig(**cfg), _mesh(axes)))
    losses = {tuple(r["losses"]) for r in port[name]}
    assert len(losses) == 1, losses
    assert abs(losses.pop()[0] - want) < 1e-5


def test_ulysses_needs_the_mesh():
    """Without a mesh the port's forward refuses Ulysses attention with
    the reference's message."""
    cfg = TorchConfig(**MODEL)
    jcfg = TransformerConfig(**MODEL)
    params = torch_init(0, cfg)
    tokens = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError) as theirs:
        forward({k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(tokens), jcfg)
    with pytest.raises(ValueError) as ours:
        forward_hidden({k: torch.tensor(v) for k, v in params.items()},
                       torch.tensor(tokens, dtype=torch.long),
                       dataclasses.replace(cfg, remat=False))
    assert str(ours.value) == str(theirs.value)
