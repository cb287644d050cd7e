"""The multi-process ``serve`` and ``inference-probe`` payloads over the
``stage`` and ``expert`` mesh axes, in gloo worlds of CPU ranks.

Two worlds (``testing/world.run_world``, ``testing/slicecases.
serve_cases``) each run their cases in turn, at fp32, at the width of
``tests/test_torch_slice_world.py`` (vocab 128, d_model 32, 4 heads, 2
K/V heads; 2 layers, 4 where a stage needs them), with weights from a
numpy seed:

* a world of 2: ``{ expert = 2 }`` paged (4 experts, top 2, spec
  windows on), ``{ stage = 2 }`` paged (spec windows on) and
  contiguous, the inference probe on ``{ expert = 2 }`` and on
  ``{ stage = 2 }``, and the MoE serving block on the rank's experts at
  top 1 and top 2;
* a world of 4: ``{ stage = 2, expert = 2 }`` paged, then ``train`` on
  ``{ data = 2, expert = 2 }`` and ``serve`` from its checkpoint on
  shared storage with a ``RuntimeWarning`` an error (the counterpart of
  ``tests/test_serve.py::test_expert_mesh_train_serve_agree_without_
  warning``).

Held here:

* the leader's greedy tokens equal the JAX package's ``generate`` on the
  same numpy weights, under the config the JAX parser derives (experts
  from the axis or ``[model] experts``, depth rounded to the stages);
  every token (sampled and streamed too) equals the port's one-process
  serve;
* the pools equal one process's BIT FOR BIT, with no tolerance: on
  ``expert`` every rank's whole pool; on ``stage`` the stages' pools
  concatenated in layer order, and the pool the leader gathers by a
  swap-out. Each stage runs its layers on the same inputs as one
  process, and an expert rank's share of a choice is nonzero on its
  own rows only, so the ``expert`` sum adds zeros. Each rank's pool is
  read twice, each reading held on its own: as the swap-out reaches it
  (what the requests wrote) and after the gathered pages are swapped
  back in (what the swap-in keeps). With spec windows, the one-process
  reference boots without the speculation probe, as a slice does
  (``runtime/serve.py``): the probe's admissions and releases of slot
  0 leave the first two free pages in the other order, so with it the
  traffic writes the same bytes into pages 1 and 0 exchanged, and no
  value differs;
* the block on the rank's experts (a local gather, the other rows
  zeroed, one sum a choice) equals the whole block on one process bit
  for bit;
* every follower's tables and lengths equal the leader's, and a
  follower answers ``/generate`` with ``GenerateUnavailable`` (503);
* a rank's weights are the JAX package's shards of the same tree on the
  same mesh (``parallel/sharding.shard_params`` against the reference's
  placement), and without a group the serving collectives are the
  identity.
"""

import dataclasses
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.transformer import forward, init_params
from kvedge_torch.models.weights import params_from_numpy, sharded_params
from kvedge_torch.parallel.mesh import NO_MESH, Mesh
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_torch.runtime.serve import run_serve_payload
from kvedge_torch.testing.world import run_world
from kvedge_tpu.config.runtime_config import MeshSpec
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.models import generate as jax_generate
from kvedge_tpu.parallel import build_mesh, shard_params
from kvedge_tpu.runtime.workload import derive_model_config

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_slice_world import (  # noqa: E402
    GREEDY,
    ONE_ROW,
    REQUESTS,
    SPEC,
)

WIDTH = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64)
# [model] lines of each model: (layers, experts line)
TOP2 = (2, "experts = 4\nexpert_top_k = 2\n")
STAGED = (4, "")
STAGED_MOE = (4, "experts = 2\n")
TRAINED = (2, "experts = 2\n")
CONTIGUOUS = [REQUESTS[0], REQUESTS[1], REQUESTS[4]]
# Spec windows ride cases of their own, a greedy and a sampled request.
SPEC_CASES = (("top2", "{ expert = 2 }", TOP2),
              ("staged", "{ stage = 2 }", STAGED))
SERVED = [REQUESTS[0], REQUESTS[4]]


def _toml(tmp_path, n, axes, model, kind="serve", serving="paged",
          extra=""):
    layers, experts = model
    return (
        "[runtime]\n"
        f'state_dir = "{tmp_path / "state"}"\n'
        f'checkpoint_dir = "{tmp_path / "shared-ckpt"}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[mesh]\n"
        f"axes = {axes}\n"
        "[distributed]\n"
        f"num_processes = {n}\n"
        "[model]\n"
        "vocab = 128\nd_model = 32\nn_heads = 4\nn_kv_heads = 2\n"
        f"n_layers = {layers}\nd_ff = 64\n{experts}"
        "[payload]\n"
        f'kind = "{kind}"\n'
        f'serving = "{serving}"\n'
        "seq = 64\n"
        "serving_slots = 3\n"
        "serving_page_size = 4\n"
        "serving_window = 4\n"
        "serving_prefix_persist = false\n"
        f'corpus = "{tmp_path / "corpus.kvfeed"}"\n'
        "steps = 2\nbatch = 8\ncheckpoint_every = 2\n"
        + extra
    )


def _config(model) -> TransformerConfig:
    """The port's model of ``model`` (experts as ``[model]`` names
    them; an axis-derived count is written there too)."""
    layers, experts = model
    fields = dict(WIDTH, n_layers=layers, max_seq=64, dtype="float32")
    for line in experts.splitlines():
        key, value = (s.strip() for s in line.split("="))
        fields["n_experts" if key == "experts" else key] = int(value)
    return TransformerConfig(**fields)


def _tree(model, seed) -> dict:
    """The numpy init with its embedding and projections scaled up, as
    ``test_torch_sliceserve.slice_tree``, so a tiny model's tokens vary
    and the router spreads them over the experts."""
    tree = init_params(seed, _config(model))
    tree["embedding"] = tree["embedding"] * np.float32(10)
    for key in ("w_qkv", "w_out", "w_up", "w_down", "w_up_experts",
                "w_down_experts", "router"):
        if key in tree:
            tree[key] = tree[key] * np.float32(4)
    return tree


def _jax_config(axes: str, model):
    """The config the JAX parser derives for ``axes`` (over its 8
    devices, the rest on ``data``), at fp32."""
    layers, experts = model
    text = (f"[mesh]\naxes = {{ data = 0, {axes.strip('{} ')} }}\n"
            "[distributed]\nnum_processes = 8\n[model]\n"
            "vocab = 128\nd_model = 32\nn_heads = 4\nn_kv_heads = 2\n"
            f"n_layers = {layers}\nd_ff = 64\n{experts}"
            '[payload]\nkind = "serve"\n')
    jcfg, _ = derive_model_config(JaxConfig.parse(text), seq=64)
    return dataclasses.replace(jcfg, dtype="float32", remat=False)


def _jax_rows(tree, body, jcfg):
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    out = jax_generate(jparams, jnp.asarray(body["tokens"], jnp.int32),
                       jcfg, n_new=body["n_new"])
    return np.asarray(out).tolist()


def _one_process(tmp_path, model, tree, bodies, serving="paged", extra=""):
    """``bodies`` through the port's one-process serve payload: each
    response's tokens and, paged, the pool afterwards. An explicit
    ``serving_speculative`` boots without the speculation probe, as on a
    slice, with speculation on as the slice keeps it."""
    cfg = RuntimeConfig.parse(_toml(tmp_path, 1, "{ data = 1 }", model,
                                    serving=serving, extra=extra))
    with mock.patch.object(PagedGenerationServer, "_probe_spec_timings",
                           lambda self: {"verify_s": 1.0, "window_s": 1.0}):
        check, serve_fn = run_serve_payload(cfg, "cpu", "float32",
                                            params=tree)
    assert check.ok, check.error
    try:
        out = []
        for body in bodies:
            doc = serve_fn(body)
            if "_stream" in doc:
                doc = [x for x in doc["_stream"] if "done" in x][0]
            out.append(doc["tokens"])
        server = serve_fn.runtime.server
        pool = None if server is None else (
            server._cache.state.pool_k.numpy().copy(),
            server._cache.state.pool_v.numpy().copy())
    finally:
        serve_fn.close()
    return out, pool


def _check_serve(docs, backend, want, tree, jcfg, bodies):
    """One case on every rank: the backend, the followers' 503, the
    leader's tokens against one process and its greedy rows against the
    JAX package."""
    assert all(d["ok"] for d in docs), docs
    assert docs[0]["backend"] == f"multihost-{backend}"
    for d in docs[1:]:
        assert d["backend"] == (f"multihost-{backend}-follower"
                                if backend == "paged"
                                else "multihost-follower")
        assert d["follower_error"] == "GenerateUnavailable"
    got = docs[0]["tokens"]
    assert got == want
    for body, rows in zip(bodies, got):
        if body in [REQUESTS[j] for j in GREEDY]:
            assert rows == _jax_rows(tree, body, jcfg), body


def _check_pools(docs, pool):
    """Followers replay the leader's tables. In each reading on its own
    (as the swap-out reaches a rank, and after the swap-in), every rank
    of a stage holds the one-process pool's layers of that stage bit for
    bit (an expert rank the stage's whole pool), so the stages' pools
    in layer order are the one-process pool; so is the leader's
    swap-out gather."""
    lead = docs[0]
    for d in docs[1:]:
        np.testing.assert_array_equal(d["tables"], lead["tables"])
        np.testing.assert_array_equal(d["lengths"], lead["lengths"])
    stages = sorted({d["stage_index"] for d in docs})
    for d in docs:
        assert d["model_index"] == 0
        layers = pool[0].shape[0] // len(stages)
        mine = slice(d["stage_index"] * layers,
                     (d["stage_index"] + 1) * layers)
        for reading in (d, d["after"]):
            for name, want in zip(("pool_k", "pool_v"), pool):
                assert reading[name].shape == want[mine].shape
                np.testing.assert_array_equal(
                    reading[name], want[mine],
                    err_msg=f"{name} of stage {d['stage_index']}, expert "
                            f"{d['expert_index']}")
    for name, want in zip(("gathered_k", "gathered_v"), pool):
        np.testing.assert_array_equal(lead[name], want)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both worlds' results, and what the tests hold them to."""
    from kvedge_torch.data.feeder import write_corpus

    tmp = tmp_path_factory.mktemp("axes")
    write_corpus(tmp / "corpus.kvfeed", np.random.default_rng(3)
                 .integers(0, 128, size=4000, dtype=np.int32))
    trees = {"top2": _tree(TOP2, 1), "staged": _tree(STAGED, 2),
             "staged_moe": _tree(STAGED_MOE, 3)}
    block = _block_inputs()
    two = [
        dict(toml=_toml(tmp, 2, "{ expert = 2 }", TOP2),
             params=trees["top2"], requests=ONE_ROW),
        dict(toml=_toml(tmp, 2, "{ stage = 2 }", STAGED),
             params=trees["staged"], requests=ONE_ROW),
        dict(toml=_toml(tmp, 2, "{ stage = 2 }", STAGED,
                        serving="contiguous"),
             params=trees["staged"], requests=CONTIGUOUS),
        dict(toml=_toml(tmp, 2, "{ expert = 2 }", TOP2,
                        kind="inference-probe"), kind="inference-probe"),
        dict(toml=_toml(tmp, 2, "{ stage = 2 }", STAGED,
                        kind="inference-probe"), kind="inference-probe"),
    ] + [dict(toml=_toml(tmp, 2, "{ expert = 2 }", TOP2), kind="moe-block",
              top_k=k, **block) for k in (1, 2)] + [
        dict(toml=_toml(tmp, 2, axes, model, extra=SPEC), params=trees[name],
             requests=REQUESTS[:2])
        for name, axes, model in SPEC_CASES]
    four = [
        dict(toml=_toml(tmp, 4, "{ stage = 2, expert = 2 }", STAGED_MOE),
             params=trees["staged_moe"], requests=ONE_ROW),
        dict(toml=_toml(tmp, 4, "{ data = 2, expert = 2 }", TRAINED,
                        kind="train"), kind="train"),
        dict(toml=_toml(tmp, 4, "{ data = 2, expert = 2 }", TRAINED),
             params=None, requests=SERVED, warnings_error=True),
    ]
    out = {"trees": trees, "block": block, "tmp": tmp}
    out["two"] = run_world("kvedge_torch.testing.slicecases:serve_cases", 2,
                           two, tmp_dir=str(tmp / "world2"), timeout_s=300)
    out["four"] = run_world("kvedge_torch.testing.slicecases:serve_cases",
                            4, four, tmp_dir=str(tmp / "world4"),
                            timeout_s=300)
    one = tmp / "one"
    out["single"] = {
        "top2": _one_process(one, TOP2, trees["top2"], ONE_ROW),
        "staged": _one_process(one, STAGED, trees["staged"], ONE_ROW),
        **{f"spec-{name}": _one_process(one, model, trees[name],
                                        REQUESTS[:2], extra=SPEC)
           for name, axes, model in SPEC_CASES},
        "contiguous": _one_process(one, STAGED, trees["staged"], CONTIGUOUS,
                                   serving="contiguous"),
        "staged_moe": _one_process(one, STAGED_MOE, trees["staged_moe"],
                                   ONE_ROW),
    }
    return out


def _case(ranks, i):
    return [r[i] for r in ranks]


def test_expert_axis_serves_paged_as_one_process(world):
    """{ expert = 2 }: 4 experts, top 2; each rank holds the whole
    pool."""
    tokens, pool = world["single"]["top2"]
    docs = _case(world["two"], 0)
    _check_serve(docs, "paged", tokens, world["trees"]["top2"],
                 _jax_config("{ expert = 2 }", TOP2), ONE_ROW)
    _check_pools(docs, pool)
    assert sorted(d["expert_index"] for d in docs) == [0, 1]
    assert "windowp" in docs[0]["slice_op_ms"]


def test_stage_axis_serves_paged_as_one_process(world):
    """{ stage = 2 }: 2 of the 4 layers a rank, the pool split with
    them."""
    tokens, pool = world["single"]["staged"]
    docs = _case(world["two"], 1)
    _check_serve(docs, "paged", tokens, world["trees"]["staged"],
                 _jax_config("{ stage = 2 }", STAGED), ONE_ROW)
    _check_pools(docs, pool)
    assert [d["pool_k"].shape[0] for d in docs] == [2, 2]
    assert "windowp" in docs[0]["slice_op_ms"]


@pytest.mark.parametrize("i,case", [(7, SPEC_CASES[0]), (8, SPEC_CASES[1])],
                         ids=["expert", "stage"])
def test_spec_windows_over_the_axis(world, i, case):
    """Spec windows (OP_SPECW and OP_SPECWS) over the axis: a greedy and
    a sampled request return one process's tokens, and leave its pool
    bit for bit."""
    name, axes, model = case
    tokens, pool = world["single"][f"spec-{name}"]
    docs = _case(world["two"], i)
    _check_serve(docs, "paged", tokens, world["trees"][name],
                 _jax_config(axes, model), REQUESTS[:2])
    _check_pools(docs, pool)
    assert {"specw", "specws"} & set(docs[0]["slice_op_ms"])


def test_stage_axis_serves_contiguous_as_one_process(world):
    docs = _case(world["two"], 2)
    _check_serve(docs, "contiguous", world["single"]["contiguous"][0],
                 world["trees"]["staged"],
                 _jax_config("{ stage = 2 }", STAGED), CONTIGUOUS)


@pytest.mark.parametrize("i,axes", [(3, "expert"), (4, "stage")])
def test_inference_probe_over_the_axis(world, i, axes):
    """The probe's cached decode on the rank's slices equals teacher
    forcing on every rank, with one process's checksum."""
    from kvedge_torch.runtime.probes import run_inference_probe

    docs = _case(world["two"], i)
    assert all(d["ok"] for d in docs), docs
    alone = run_inference_probe(RuntimeConfig(expected_platform="cpu"),
                                "cpu", "float32")
    assert alone.ok, alone.error
    assert {d["checksum"] for d in docs} == {alone.probe_checksum}


def _block_inputs():
    """One layer of a 4-expert block and 24 rows that route to every
    expert, from a numpy seed."""
    rng = np.random.default_rng(5)
    d, f, e = 32, 64, 4
    return dict(
        x=rng.standard_normal((24, d)).astype(np.float32),
        router=(rng.standard_normal((d, e)) * 2).astype(np.float32),
        w_up=(rng.standard_normal((e, d, f)) / d ** 0.5).astype(np.float32),
        w_down=(rng.standard_normal((e, f, d)) / f ** 0.5).astype(
            np.float32))


@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_block_on_the_ranks_experts_is_exact(world, top_k):
    """``moe_ffn_dropless`` on each rank's 2 experts (local gather,
    masked rows, one sum a choice) equals the whole block on one
    process bit for bit, and the rows reach both ranks' experts."""
    from kvedge_torch.models.moe import _route, moe_ffn_dropless

    block = world["block"]
    docs = _case(world["two"], 5 + top_k - 1)
    t = {k: torch.from_numpy(v) for k, v in block.items()}
    with torch.no_grad():
        want = moe_ffn_dropless(t["x"], t["router"], t["w_up"], t["w_down"],
                                top_k=top_k).numpy()
        _, idx, _ = _route(t["x"], t["router"], top_k)
    assert set(idx[:, 0].tolist()) == {0, 1, 2, 3}
    assert sorted(d["expert_index"] for d in docs) == [0, 1]
    for d in docs:
        np.testing.assert_array_equal(d["out"], want)


def test_stage_and_expert_axes_serve_paged_as_one_process(world):
    """{ stage = 2, expert = 2 }: the expert sums run inside each
    stage's layers, over that stage's expert group."""
    tokens, pool = world["single"]["staged_moe"]
    docs = _case(world["four"], 0)
    _check_serve(docs, "paged", tokens, world["trees"]["staged_moe"],
                 _jax_config("{ stage = 2, expert = 2 }", STAGED_MOE),
                 ONE_ROW)
    _check_pools(docs, pool)
    assert sorted((d["stage_index"], d["expert_index"]) for d in docs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_expert_mesh_train_then_serve_without_warning(world):
    """A checkpoint trained on { data = 2, expert = 2 } serves on that
    mesh under RuntimeWarning-as-error, restored at its step, with the
    teacher-forced argmax and the JAX package's tokens."""
    from kvedge_torch.runtime.train import restore_latest_params

    train = _case(world["four"], 1)
    assert all(d["ok"] for d in train), train
    docs = _case(world["four"], 2)
    assert all(d["ok"] for d in docs), docs
    assert docs[0]["restored_step"] == 2
    assert all(d["follower_error"] == "GenerateUnavailable"
               for d in docs[1:])
    cfg = RuntimeConfig.parse(_toml(world["tmp"], 1, "{ data = 1 }",
                                    TRAINED))
    tcfg = cfg.model_config("float32", "cpu")
    assert tcfg.expert_capacity_factor * tcfg.expert_top_k >= \
        tcfg.n_experts
    step, trained = restore_latest_params(cfg, tcfg)
    assert step == 2
    jcfg = _jax_config("{ expert = 2 }", TRAINED)
    weights = params_from_numpy(trained, tcfg, "cpu")
    for body, got in zip(SERVED, docs[0]["tokens"]):
        assert got == _jax_rows(trained, body, jcfg)
        seq = torch.tensor(body["tokens"])
        for _ in range(body["n_new"]):
            nxt = forward(weights, seq, tcfg)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
        assert got == seq.tolist()


@pytest.mark.parametrize("axes", [(("stage", 2),), (("expert", 2),),
                                  (("stage", 2), ("expert", 2))],
                         ids=["stage", "expert", "stage-expert"])
def test_rank_slices_are_the_reference_shards(axes):
    """Each rank's tensors from ``weights.sharded_params`` are the
    shards the JAX package places on the device at the rank's
    coordinates: whole layers over ``stage``, whole experts over
    ``expert``."""
    cfg = _config(STAGED_MOE)
    tree = _tree(STAGED_MOE, 4)
    n = int(np.prod([size for _, size in axes]))
    mesh = build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:n])
    placed = shard_params(mesh, {k: jnp.asarray(v) for k, v in tree.items()})
    names = tuple(name for name, _ in axes)
    for coords in np.ndindex(*mesh.devices.shape):
        device = mesh.devices[coords]
        ours = sharded_params(tree, cfg, "cpu", Mesh(
            names, tuple(size for _, size in axes), tuple(coords)))
        for key, arr in placed.items():
            shard = [s for s in arr.addressable_shards
                     if s.device == device][0]
            np.testing.assert_array_equal(ours[key].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{key} at {coords}")


def test_serving_collectives_are_the_identity_without_a_group():
    """NO_MESH and a mesh outside a world run no collective: each
    serving collective returns its input, the tensor itself."""
    from kvedge_torch.parallel.sharding import (
        from_last_stage,
        hand_off,
        sum_over_experts,
    )

    x = torch.arange(6.0).reshape(2, 3)
    for mesh in (NO_MESH, Mesh(("stage", "expert"), (2, 2), (1, 1))):
        assert sum_over_experts(x, mesh) is x
        assert hand_off(x, mesh, 0) is x
        assert from_last_stage(x, mesh) is x
