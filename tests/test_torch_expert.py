"""The ``expert`` mesh axis (``kvedge_torch/models/moe.py``,
``parallel/sharding.py``) against the JAX package's expert-parallel MoE:
the counterpart of the expert cases of ``tests/test_moe.py``; and the
runtime config's mesh derivation for the ``stage`` and ``expert`` axes
against the reference's parser and ``derive_model_config``.

The port runs in gloo worlds of 4 and 2 CPU ranks, the JAX side on the
conftest's virtual CPU devices, from the same numpy-made fp32 weights
and batch: on (data 2, expert 2), (expert 2, model 2) and top-2 on
(expert 2), the first train step's loss within 1e-5 and its gathered
gradients, as they reach AdamW on every rank, within 1e-5 of each leaf's largest
magnitude (the tolerance of ``tests/test_torch_sharding.py``), against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same mesh.
The transformer probe on ``{ stage = 2, expert = 2 }`` in the world of
4 equals the same pipelined step in one process within 1e-5.

Config, case by case against the reference: experts follow the expert
axis, an explicit count it does not divide is refused with the
reference's message; a preset's depth rounds up to the stages and an
explicit one that does not divide is refused; ``pipeline_schedule``;
the dtype the reference derives on its CPU backend (float32 for a stage
axis with a model axis or experts); ``serve`` and ``inference-probe``
over a stage or expert axis accepted by both parsers with the same
mesh, on one process as on several, and still refused by name beside a
``seq`` axis.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig as TorchConfig
from kvedge_torch.models.transformer import init_params as torch_init
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.models import TransformerConfig, loss_fn
from kvedge_tpu.parallel import build_mesh, shard_batch, shard_params

BASE = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=0, n_layers=2,
            d_ff=64, max_seq=16, dtype="float32", n_experts=4,
            expert_capacity_factor=1.0)
# name -> (world size, axes, model fields)
CASES = {
    "data2-expert2": (4, (("data", 2), ("expert", 2)), {}),
    "expert2-model2": (4, (("expert", 2), ("model", 2)),
                       dict(expert_top_k=2, expert_capacity_factor=2.0)),
    "expert2-top2": (2, (("expert", 2),),
                     dict(expert_top_k=2, expert_capacity_factor=0.5)),
}
PROBE_TOML = ("[tpu]\nplatform = \"cpu\"\n[mesh]\n"
              "axes = { stage = 2, expert = 2 }\n[distributed]\n"
              "num_processes = 4\n[payload]\nkind = \"transformer-probe\"\n")


def _inputs(fields):
    cfg = dict(BASE, **fields)
    params = torch_init(41, TorchConfig(**cfg))
    batch = np.random.default_rng(42).integers(
        0, cfg["vocab"], (8, cfg["max_seq"] + 1))
    return cfg, params, batch


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from kvedge_torch.runtime import probes

    root = tmp_path_factory.mktemp("expert")
    tokens = np.random.default_rng(43).integers(
        0, 512, (8, probes.PROBE_SEQ + 1))
    out = {"tokens": tokens}
    for n in (4, 2):
        names = [k for k, (size, _, _) in CASES.items() if size == n]
        train = []
        for name in names:
            _, axes, fields = CASES[name]
            cfg, params, batch = _inputs(fields)
            train.append(dict(axes=axes, cfg=cfg, params=params,
                              batches=[batch]))
        payloads = ([dict(toml=PROBE_TOML, kind="transformer-probe",
                          tokens=tokens)] if n == 4 else [])
        ranks = run_world("kvedge_torch.testing.parallelcases:families", n,
                          train=train, payloads=payloads,
                          tmp_dir=str(root / f"world{n}"))
        for i, name in enumerate(names):
            out[name] = [r["train"][i] for r in ranks]
        if n == 4:
            out["probe"] = [r["payloads"][0] for r in ranks]
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's loss and gradients on the mesh."""
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


@pytest.mark.parametrize("name", CASES)
def test_expert_axis_matches_the_reference_on_its_mesh(port, name):
    want_loss, want_grads = _reference(name)
    ranks = port[name]
    assert all("error" not in r for r in ranks), ranks[0]
    losses = {r["losses"][0] for r in ranks}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    assert abs(losses.pop() - want_loss) < 1e-5
    for rank in ranks:  # a replicated leaf's copy on every rank
        got = rank["grads"]
        assert set(got) == set(want_grads)
        for key, value in want_grads.items():
            np.testing.assert_allclose(
                got[key], value, rtol=0,
                atol=1e-5 * float(np.abs(value).max()), err_msg=key)


def test_probe_on_stage_and_expert_axes_equals_one_process(port):
    """The world's probe against the same derived model's first step in
    one process, run through GPipe on a stage axis of 1 (so each
    microbatch's MoE capacity and balance statistics bind as in the
    world's)."""
    from kvedge_torch.models.training import loss_and_grads, master_params
    from kvedge_torch.parallel.mesh import Mesh

    got = port["probe"]
    assert all(g["ok"] for g in got), got
    assert {g["mesh_shape"] for g in got} == {(2, 2)}
    assert len({g["value"] for g in got}) == 1
    from kvedge_torch.runtime.probes import transformer_probe_config

    tcfg = transformer_probe_config(RuntimeConfig.parse(PROBE_TOML),
                                    "bfloat16", "cpu")
    assert (tcfg.dtype, tcfg.n_experts, tcfg.pipeline_stages) == (
        "float32", 2, 2)
    one = dataclasses.replace(tcfg, pipeline_microbatches=2)
    loss, _ = loss_and_grads(master_params(torch_init(0, one), one, "cpu"),
                             torch.as_tensor(port["tokens"]), one,
                             Mesh(("stage",), (1,), (0,)))
    assert abs(got[0]["value"] - float(loss)) < 1e-5


# [mesh] axes over 8 processes (the conftest's 8 devices for the
# reference), and [payload] / [model] lines
DERIVATIONS = {
    "experts-follow-axis": ("{ data = 0, expert = 2 }", ""),
    "experts-explicit": ("{ data = 0, expert = 2 }", "[model]\nexperts = 4\n"),
    "experts-not-dividing": ("{ data = 0, expert = 4 }",
                             "[model]\nexperts = 6\n"),
    "layers-round-up": ("{ data = 0, stage = 4 }", ""),
    "layers-explicit-refused": ("{ data = 0, stage = 2 }",
                                "[model]\nn_layers = 3\n"),
    "stage-1f1b": ("{ data = 0, stage = 2 }",
                   '[model]\npipeline_schedule = "1f1b"\n'),
    "stage-one-is-off": ("{ data = 0, stage = 1 }", ""),
    "stage-model-fp32": ("{ data = 0, stage = 2, model = 2 }", ""),
    "stage-expert-fp32": ("{ data = 0, stage = 2, expert = 2 }", ""),
    "stage-expert-seq-ulysses": ("{ stage = 2, expert = 2, seq = 2 }",
                                 '[payload]\nattention = "ulysses"\n'),
}


@pytest.mark.parametrize("name", DERIVATIONS)
def test_model_derivation_matches_the_reference(name):
    from kvedge_tpu.runtime.workload import derive_model_config

    axes, extra = DERIVATIONS[name]
    text = (f"[mesh]\naxes = {axes}\n[distributed]\nnum_processes = 8\n"
            f"{extra}")
    try:
        jcfg, _ = derive_model_config(JaxConfig.parse(text), seq=32)
    except ValueError as e:
        with pytest.raises(RuntimeConfigError) as ours:
            RuntimeConfig.parse(text).model_config(device="cpu")
        assert str(ours.value) == str(e)
        return
    tcfg = dataclasses.replace(RuntimeConfig.parse(text),
                               max_seq=32).model_config(device="cpu")
    for field in ("attention", "n_heads", "n_layers", "n_experts",
                  "expert_top_k", "expert_capacity_factor",
                  "pipeline_stages", "pipeline_microbatches",
                  "pipeline_schedule", "dtype", "max_seq"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    # The card keeps the compute dtype the caller asks for.
    on_card = RuntimeConfig.parse(text).model_config("bfloat16", "cuda")
    assert on_card.dtype == "bfloat16"


@pytest.mark.parametrize("text,match", [
    ('[mesh]\naxes = { seq = 2, stage = 2 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "serve"\n',
     r"kind = 'serve' over a 'seq' axis of 2"),
    ('[mesh]\naxes = { expert = 2, seq = 0 }\n[distributed]\n'
     'num_processes = 4\n[payload]\nkind = "inference-probe"\n',
     r"kind = 'inference-probe' over a 'seq' axis of 2"),
    ('[mesh]\naxes = { stage = 2, expert = 2, seq = 2 }\n'
     '[distributed]\nnum_processes = 8\n[payload]\nkind = "serve"\n',
     r"kind = 'serve' over a 'seq' axis of 2"),
    ('[model]\npipeline_schedule = "zb"\n',
     r"pipeline_schedule must be 'gpipe' or '1f1b'"),
])
def test_serving_over_stage_or_expert_is_refused_by_name(text, match):
    """Serving over ``stage`` and ``expert`` is accepted (below); with a
    ``seq`` axis beside them it is still refused, by the seq axis's
    name."""
    with pytest.raises(RuntimeConfigError, match=match):
        RuntimeConfig.parse(text)


@pytest.mark.parametrize("text", [
    '[mesh]\naxes = { data = 0, stage = 2 }\n[distributed]\n'
    'num_processes = 4\n[payload]\nkind = "train"\ncorpus = "c"\n',
    '[mesh]\naxes = { stage = 2, expert = 2 }\n[distributed]\n'
    'num_processes = 4\n[payload]\nkind = "transformer-probe"\n',
    '[mesh]\naxes = { expert = 0 }\n[distributed]\nnum_processes = 2\n'
    '[payload]\nkind = "eval"\ncorpus = "c"\n'
    '[model]\npipeline_schedule = "1f1b"\n',
    '[mesh]\naxes = { data = 2, stage = 2 }\n[distributed]\n'
    'num_processes = 4\n',
    '[mesh]\naxes = { data = 1, stage = 2 }\n[distributed]\n'
    'num_processes = 2\n[payload]\nkind = "serve"\n',
    '[mesh]\naxes = { expert = 0 }\n[distributed]\nnum_processes = 4\n'
    '[payload]\nkind = "inference-probe"\n',
    '[mesh]\naxes = { stage = 2 }\n[payload]\nkind = "serve"\n',
    '[mesh]\naxes = { stage = 2, expert = 2 }\n[distributed]\n'
    'num_processes = 4\n[payload]\nkind = "serve"\nserving = "paged"\n',
], ids=["train-stage", "probe-stage-expert", "eval-expert", "devicecheck",
        "serve-stage", "inference-probe-expert", "serve-stage-one-process",
        "serve-stage-expert"])
def test_stage_and_expert_meshes_parse_as_the_reference(text):
    """Accepted by both parsers, with the same mesh, schedule and
    round trip through the TOML (serving over ``stage`` and ``expert``
    among them)."""
    ours, theirs = RuntimeConfig.parse(text), JaxConfig.parse(text)
    assert ours.mesh_axes == theirs.mesh.axes
    assert ours.pipeline_schedule == theirs.model.pipeline_schedule
    assert ours.payload == theirs.payload
    assert RuntimeConfig.parse(ours.to_toml()) == ours
