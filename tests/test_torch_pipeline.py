"""The GPipe schedule (``kvedge_torch/parallel/pipeline.py``) against the
JAX package's ``parallel/pipeline.py`` on the same mesh: the counterpart
of ``tests/test_pipeline.py``.

The port runs in gloo worlds of 2 and 4 CPU ranks
(``kvedge_torch.testing.world``), the JAX side on the conftest's
virtual CPU devices; numpy makes the weights (the port's
``init_params``) and the batch from seeds, at fp32 and small size. Each
mesh's first train-step loss and gradients, as they reach AdamW on
every rank, are held to ``jax.value_and_grad`` of the reference's
``loss_fn`` on the same mesh within the reference's ``atol=2e-4``, and
each gradient leaf
within 1e-4 of its largest magnitude as well (a leaf summed the wrong
number of times fails that, however small it is). Meshes: (stage 2),
(data 2, stage 2), (stage 2, model 2) with ``remat_policy = "dots"``,
(stage 2, seq 2) with ring and with Ulysses, (stage 2, expert 2) with
top-2 MoE at half the drop-free capacity (the load-balancing loss over
the real microbatch x layer evaluations only), and MoE on (data 2,
stage 2), where a rank's microbatches are the reference's strided rows.

Refusals carry the reference's messages: no stage axis, a batch that
does not divide into the microbatches, a microbatch smaller than the
data axis, layers that do not divide by the stages.

Payloads in the world of 4: the transformer probe on ``{ data = 0,
stage = 2 }`` equals the probe in one process within 1e-5; a ``train``
payload on that mesh writes a checkpoint that one process restores (its
eval equals the world's within 1e-5), and ``tools/orbax_torch.py``
converts it to the JAX package's orbax layout and back unchanged.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig as TorchConfig
from kvedge_torch.models.transformer import init_params as torch_init
from kvedge_torch.runtime.checkpoint import StateCheckpointer
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.models import TransformerConfig, loss_fn
from kvedge_tpu.parallel import build_mesh, shard_batch, shard_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=0, n_layers=4,
            d_ff=64, max_seq=16, dtype="float32", pipeline_stages=2)
MOE = dict(n_experts=4, expert_top_k=2, expert_capacity_factor=1.0)
# name -> (world size, axes, model fields)
CASES = {
    "stage2": (2, (("stage", 2),), dict(pipeline_microbatches=4)),
    "data2-stage2": (4, (("data", 2), ("stage", 2)),
                     dict(pipeline_microbatches=4)),
    "stage2-model2-dots": (4, (("stage", 2), ("model", 2)),
                           dict(remat_policy="dots")),
    "stage2-seq2-ring": (4, (("stage", 2), ("seq", 2)),
                         dict(attention="ring")),
    "stage2-seq2-ulysses": (4, (("stage", 2), ("seq", 2)),
                            dict(attention="ulysses")),
    "stage2-expert2-moe": (4, (("stage", 2), ("expert", 2)),
                           dict(MOE, pipeline_microbatches=4)),
    "moe-data2-stage2": (4, (("data", 2), ("stage", 2)),
                         dict(MOE, pipeline_microbatches=2)),
}
PROBE_AXES = "{ data = 0, stage = 2 }"


def _inputs(fields):
    cfg = dict(BASE, **fields)
    params = torch_init(21, TorchConfig(**cfg))
    batch = np.random.default_rng(22).integers(
        0, cfg["vocab"], (8, cfg["max_seq"] + 1))
    return cfg, params, batch


def _toml(root, kind, axes, n):
    return (
        "[runtime]\n"
        f'state_dir = "{root / "state"}"\n'
        f'checkpoint_dir = "{root / "ckpt"}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[mesh]\n"
        f"axes = {axes}\n"
        "[distributed]\n"
        f"num_processes = {n}\n"
        "[payload]\n"
        f'kind = "{kind}"\n'
        f'corpus = "{root / "corpus.kvfeed"}"\n'
        "steps = 2\n"
        "batch = 8\n"
        "seq = 32\n"
    )


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case's first step in its world, and the world-of-4
    payloads (probe, train, eval on the trained checkpoint)."""
    from kvedge_torch.data.feeder import write_corpus
    from kvedge_torch.runtime import probes

    root = tmp_path_factory.mktemp("pipeline")
    write_corpus(root / "corpus.kvfeed", np.random.default_rng(23)
                 .integers(0, 512, size=4000, dtype=np.int32))
    tokens = np.random.default_rng(24).integers(
        0, 512, (8, probes.PROBE_SEQ + 1))
    out = {"root": root, "tokens": tokens}
    for n in (2, 4):
        names = [k for k, (size, _, _) in CASES.items() if size == n]
        train = []
        for name in names:
            _, axes, fields = CASES[name]
            cfg, params, batch = _inputs(fields)
            train.append(dict(axes=axes, cfg=cfg, params=params,
                              batches=[batch]))
        payloads = []
        if n == 4:
            payloads = [dict(toml=_toml(root, kind, PROBE_AXES, 4), kind=kind,
                             tokens=tokens)
                        for kind in ("transformer-probe", "train", "eval")]
        ranks = run_world("kvedge_torch.testing.parallelcases:families", n,
                          train=train, payloads=payloads,
                          tmp_dir=str(root / f"world{n}"))
        for i, name in enumerate(names):
            out[name] = [r["train"][i] for r in ranks]
        if n == 4:
            out["payloads"] = [r["payloads"] for r in ranks]
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's loss and gradients on the same mesh."""
    _, axes, fields = CASES[name]
    cfg, params, batch = _inputs(fields)
    tcfg = TransformerConfig(**cfg)
    n = int(np.prod([size for _, size in axes]))
    mesh = build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:n])
    p = shard_params(mesh, {k: jnp.asarray(v) for k, v in params.items()})
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q, b: loss_fn(q, b, tcfg, mesh)))(
        p, shard_batch(mesh, jnp.asarray(batch, jnp.int32)))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def assert_grads_close(got, want, atol, rel):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol,
                                   err_msg=key)
        np.testing.assert_allclose(
            got[key], value, rtol=0,
            atol=rel * float(np.abs(value).max()), err_msg=key)


@pytest.mark.parametrize("name", CASES)
def test_gpipe_matches_the_reference_on_its_mesh(port, name):
    want_loss, want_grads = _reference(name)
    ranks = port[name]
    assert all("error" not in r for r in ranks), ranks[0]
    losses = {r["losses"][0] for r in ranks}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    assert abs(losses.pop() - want_loss) < 2e-4
    for rank in ranks:  # a replicated leaf's copy on every rank
        assert_grads_close(rank["grads"], want_grads, 2e-4, 1e-4)


def _port_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_carry_the_references_messages():
    """Each refusal on the same mesh shape in both packages (the port's
    mesh built without a world: the checks come before any
    collective)."""
    from kvedge_tpu.parallel.pipeline import pipeline_layers as theirs

    from kvedge_torch.models.transformer import loss_fn as torch_loss
    from kvedge_torch.models.training import master_params
    from kvedge_torch.parallel.mesh import Mesh
    from kvedge_torch.parallel.pipeline import pipeline_layers as ours

    def jmesh(axes):
        n = int(np.prod([s for _, s in axes]))
        return build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:n])

    def tmesh(axes):
        return Mesh(tuple(a for a, _ in axes), tuple(s for _, s in axes),
                    tuple(0 for _ in axes))

    cfg, params, batch = _inputs({})
    body = (lambda c, lp: (c, jnp.zeros((), jnp.float32)),
            lambda c, lp: (c, torch.zeros(())))
    stacked = (jnp.zeros((4, 2)),), (torch.zeros((2, 2)),)
    cases = {
        # (axes, global batch, micro, n_layers)
        "no-stage-axis": ((("data", 2), ("model", 2)), 8, 0, 4),
        "indivisible-batch": ((("stage", 2),), 6, 4, 4),
        "microbatch-below-data": ((("data", 2), ("stage", 2)), 8, 8, 4),
        "layers-not-dividing": ((("stage", 2),), 8, 0, 3),
    }
    for name, (axes, b, micro, layers) in cases.items():
        with pytest.raises(ValueError) as want:
            theirs(jnp.zeros((b, 4, 8)), stacked[0], body[0], jmesh(axes),
                   n_layers=layers, n_microbatches=micro)
        dp = dict(axes).get("data", 1)
        got = _port_error(lambda: ours(
            torch.zeros((b // dp, 4, 8)), stacked[1], body[1], tmesh(axes),
            n_layers=layers, n_microbatches=micro))
        assert got == str(want.value), name
    # Through the model: a stage axis the mesh lacks, and layers the
    # config's stages do not divide.
    tcfg = TorchConfig(**cfg)
    p = master_params(params, tcfg, "cpu")
    axes = (("data", 2), ("model", 2))
    with pytest.raises(ValueError) as want:
        loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(batch, jnp.int32), TransformerConfig(**cfg),
                jmesh(axes))
    got = _port_error(lambda: torch_loss(
        p, torch.as_tensor(batch[:4]), tcfg, tmesh(axes)))
    assert got == str(want.value)
    with pytest.raises(ValueError) as want:
        TransformerConfig(**dict(cfg, n_layers=3)).validate()
    assert _port_error(lambda: TorchConfig(**dict(cfg, n_layers=3))
                       .validate()) == str(want.value)


def test_transformer_probe_on_a_stage_axis_equals_one_process(port):
    from kvedge_torch.runtime import probes

    got = [r[0] for r in port["payloads"]]
    assert all(g["ok"] for g in got), got
    assert {g["mesh_shape"] for g in got} == {(2, 2)}
    assert len({g["value"] for g in got}) == 1
    single = RuntimeConfig.parse(_toml(port["root"], "transformer-probe",
                                       "{ data = 0 }", 1))
    want = probes.run_transformer_probe(single, "cpu", "float32",
                                        tokens=port["tokens"])
    assert want.ok, want.error
    assert abs(got[0]["value"] - want.probe_checksum) < 1e-5


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_torch", os.path.join(REPO, "tools", "orbax_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_stage_axis_checkpoint_restores_in_one_process(port, tmp_path):
    """The train payload's checkpoint from (data 2, stage 2): gathered
    whole, restored by one process, whose eval equals the world's; the
    orbax converter takes it to the JAX package and back unchanged."""
    from kvedge_torch.runtime import train as tpay

    root = port["root"]
    trained = [r[1] for r in port["payloads"]]
    evals = [r[2] for r in port["payloads"]]
    assert all(g["ok"] for g in trained + evals), (trained, evals)
    assert len({g["value"] for g in evals}) == 1
    text = _toml(root, "eval", "{ data = 0 }", 1)
    single = tpay.run_eval_payload(RuntimeConfig.parse(text), device="cpu",
                                   dtype="float32")
    assert single.ok and single.step == 2, single
    assert abs(single.loss - evals[0]["value"]) < 1e-5
    tool = _tool()
    world_text = _toml(root, "train", PROBE_AXES, 4)
    tool.torch_to_orbax(world_text, str(root / "ckpt"), str(tmp_path / "o"))
    tool.orbax_to_torch(world_text, str(tmp_path / "o"), str(tmp_path / "t"))
    a = StateCheckpointer("", checkpoint_dir=str(root / "ckpt"))
    b = StateCheckpointer("", checkpoint_dir=str(tmp_path / "t"))
    assert a.latest_step() == b.latest_step() == 2
    for part in ("params.pt", "opt_state.pt"):
        x = torch.load(os.path.join(a.directory, "2", part),
                       weights_only=True)
        y = torch.load(os.path.join(b.directory, "2", part),
                       weights_only=True)
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key


def test_stage_axis_cuts_whole_layers():
    """A stage rank's slices are its own layers' (contiguous L/S), and
    shard then gather over stage x expert x model is the identity in
    shape bookkeeping (``abstract_shard_tree``)."""
    from kvedge_torch.models.weights import expected_shapes
    from kvedge_torch.parallel.mesh import Mesh
    from kvedge_torch.parallel.sharding import (
        abstract_shard_tree,
        shard_params as cut,
    )

    cfg = TorchConfig(**dict(BASE, **MOE))
    tree = torch_init(0, cfg)
    for s in range(2):
        for e in range(2):
            mesh = Mesh(("stage", "expert", "model"), (2, 2, 2), (s, e, 0))
            got = cut(mesh, tree, cfg)
            np.testing.assert_array_equal(got["ln_attn"],
                                          tree["ln_attn"][2 * s:2 * s + 2])
            np.testing.assert_array_equal(
                got["w_up_experts"],
                tree["w_up_experts"][2 * s:2 * s + 2, 2 * e:2 * e + 2,
                                     :, :cfg.d_ff // 2])
            np.testing.assert_array_equal(got["embedding"][:, :16],
                                          tree["embedding"][:, :16])
            assert {k: v.shape for k, v in got.items()} == \
                abstract_shard_tree(mesh, expected_shapes(cfg), cfg)
