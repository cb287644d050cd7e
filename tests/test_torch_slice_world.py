"""The multi-process ``serve`` payload in gloo worlds of CPU ranks.

Worlds of 2 ranks (``model = 2``) and 4 (``data = 2, model = 2``) boot
``runtime/serve.run_serve_payload`` from one TOML on every rank
(``testing/world.run_world``, ``testing/slicecases.serve_cases``): the
paged backend (rank 0 serves over a ``SlicePagedKVCache``, the others
replay its op stream) and the contiguous leader-serves backend. Held
here, at fp32:

* the leader's greedy tokens equal the JAX package's ``generate`` on the
  same numpy weights, and every token (sampled and streamed too) the
  port's one-process serve;
* every follower's tables and lengths equal the leader's, a data
  replica's pools equal the leader's bit for bit, and the pool the
  leader gathers by a swap-out equals the one-process pool: bit for bit
  in layer 0, within 1e-5 past it (the model-sharded w_out and w_down
  products are summed over the ranks in another order than one
  process's matmul sums them);
* a follower answers ``/generate`` with ``GenerateUnavailable`` (503);
* ``inference-probe`` runs across the world, and a checkpoint a
  model-sharded ``train`` wrote on shared storage is served (the
  counterparts of ``tests/test_distributed.py``'s two-process serve
  cases).
"""

import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from kvedge_tpu.models import generate as jax_generate
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_torch.runtime.serve import run_serve_payload
from kvedge_torch.testing.world import run_world

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_sliceserve import JCFG, slice_tree  # noqa: E402

REQUESTS = [
    {"tokens": [[5, 9, 2, 7, 1]], "n_new": 8},
    {"tokens": [[1, 2, 3, 4]], "n_new": 6, "temperature": 0.8,
     "top_p": 0.9, "seed": 7},
    {"tokens": [[11, 12, 13, 14, 15, 16, 17, 18, 19]], "n_new": 5,
     "stream": True},
    {"tokens": [[11, 12, 13, 14, 15, 16, 17, 18, 19]], "n_new": 5},
    {"tokens": [[3, 1, 4], [2, 7, 1]], "n_new": 7},
]
GREEDY = [0, 2, 3, 4]
# The paged cases whose pool is compared submit one row at a time: two
# rows of one request admit concurrently, in either order.
ONE_ROW = REQUESTS[:4]


SPEC = "serving_speculative = 3\nserving_spec_window = 4\n"


def _toml(tmp_path, n, axes, kind="serve", serving="paged", extra=""):
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
        "n_layers = 2\nd_ff = 64\n"
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


def _one_process(tmp_path, serving, tree, bodies, extra=""):
    """``bodies`` through the port's one-process serve payload: each
    response's tokens and, paged, the pool afterwards."""
    cfg = RuntimeConfig.parse(_toml(tmp_path, 1, "{ data = 1 }",
                                    serving=serving, extra=extra))
    check, serve_fn = run_serve_payload(cfg, "cpu", "float32", params=tree)
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


def _jax_rows(tree, body):
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    out = jax_generate(jparams, jnp.asarray(body["tokens"], jnp.int32),
                       JCFG, n_new=body["n_new"])
    return np.asarray(out).tolist()


def _check_serve(ranks, i, backend, want, tree):
    """Case ``i`` of every rank: the backend, the followers' 503, and the
    leader's tokens against the one-process serve and the JAX package."""
    docs = [r[i] for r in ranks]
    assert all(d["ok"] for d in docs), docs
    assert docs[0]["backend"] == f"multihost-{backend}"
    for d in docs[1:]:
        assert d["backend"] == (f"multihost-{backend}-follower"
                                if backend == "paged"
                                else "multihost-follower")
        assert d["follower_error"] == "GenerateUnavailable"
    got = docs[0]["tokens"]
    assert got == want[:len(got)]
    for j in GREEDY:
        if j < len(got):
            assert got[j] == _jax_rows(tree, REQUESTS[j]), j
    return docs


def _check_pools(docs, pool):
    """Followers replay the leader's tables; a rank's pools hold its
    model coordinate's heads, the data replicas bit for bit alike; the
    gathered pool is the one-process pool."""
    lead = docs[0]
    for d in docs[1:]:
        np.testing.assert_array_equal(d["tables"], lead["tables"])
        np.testing.assert_array_equal(d["lengths"], lead["lengths"])
    for d in docs:
        if d["model_index"] == lead["model_index"]:
            np.testing.assert_array_equal(d["pool_k"], lead["pool_k"])
            np.testing.assert_array_equal(d["pool_v"], lead["pool_v"])
    heads = lead["pool_k"].shape[3]
    for name, want in zip(("gathered_k", "gathered_v"), pool):
        got = lead[name]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Each rank holds its K/tp heads: the leader's are the first.
    np.testing.assert_array_equal(lead["gathered_k"][..., :heads, :],
                                  lead["pool_k"])


@pytest.fixture(scope="module")
def tree():
    return slice_tree()


@pytest.fixture(scope="module")
def single(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    return {"paged": _one_process(tmp, "paged", tree, ONE_ROW),
            "contiguous": _one_process(tmp, "contiguous", tree,
                                       REQUESTS[:2]),
            "spec": _one_process(tmp, "paged", tree, REQUESTS[:2],
                                 extra=SPEC)}


def test_world_of_two_serves_as_one_process(tmp_path, tree, single):
    """model = 2: paged and contiguous serve with the given weights, the
    paged backend again with speculative spec windows (OP_SPECW and
    OP_SPECWS replayed across the world), the inference probe, then a
    model-sharded train run's checkpoint on shared storage served by
    both backends."""
    from kvedge_torch.data.feeder import write_corpus
    from kvedge_torch.runtime.train import restore_latest_params

    write_corpus(tmp_path / "corpus.kvfeed", np.random.default_rng(3)
                 .integers(0, 128, size=4000, dtype=np.int32))
    axes = "{ data = 1, model = 2 }"
    cases = [
        dict(toml=_toml(tmp_path, 2, axes), params=tree, requests=ONE_ROW),
        dict(toml=_toml(tmp_path, 2, axes, serving="contiguous"),
             params=tree, requests=REQUESTS[:2]),
        dict(toml=_toml(tmp_path, 2, axes, kind="inference-probe"),
             kind="inference-probe"),
        dict(toml=_toml(tmp_path, 2, axes, kind="train"), kind="train"),
        dict(toml=_toml(tmp_path, 2, axes), params=None,
             requests=[REQUESTS[0], REQUESTS[4]]),
        dict(toml=_toml(tmp_path, 2, axes, serving="contiguous"),
             params=None, requests=[REQUESTS[0]]),
        dict(toml=_toml(tmp_path, 2, axes, extra=SPEC), params=tree,
             requests=REQUESTS[:2]),
    ]
    ranks = run_world("kvedge_torch.testing.slicecases:serve_cases", 2,
                      cases, tmp_dir=str(tmp_path / "world"),
                      timeout_s=240)
    tokens, pool = single["paged"]
    docs = _check_serve(ranks, 0, "paged", tokens, tree)
    _check_pools(docs, pool)
    assert "windowp" in docs[0]["slice_op_ms"]
    _check_serve(ranks, 1, "contiguous", single["contiguous"][0], tree)
    assert all(r[2]["ok"] for r in ranks), [r[2] for r in ranks]
    assert all(r[3]["ok"] for r in ranks), [r[3] for r in ranks]

    cfg = RuntimeConfig.parse(_toml(tmp_path, 1, "{ data = 1 }"))
    step, trained = restore_latest_params(cfg, cfg.model_config("float32"))
    assert step == 2
    for i, bodies in ((4, [REQUESTS[0], REQUESTS[4]]), (5, [REQUESTS[0]])):
        docs = [r[i] for r in ranks]
        assert all(d["ok"] for d in docs), docs
        assert docs[0]["restored_step"] == 2
        assert docs[0]["tokens"] == [_jax_rows(trained, b) for b in bodies]
    docs = _check_serve(ranks, 6, "paged", single["spec"][0], tree)
    assert {"specw", "specws"} & set(docs[0]["slice_op_ms"])


def test_world_of_four_replicates_over_data(tmp_path, tree, single):
    """data = 2, model = 2: two model groups replay one op stream; the
    leader's tokens are one process's, and a data replica's pools are
    the leader's bit for bit."""
    axes = "{ data = 2, model = 2 }"
    cases = [
        dict(toml=_toml(tmp_path, 4, axes), params=tree, requests=ONE_ROW),
        dict(toml=_toml(tmp_path, 4, axes, serving="contiguous"),
             params=tree, requests=REQUESTS[:2]),
    ]
    ranks = run_world("kvedge_torch.testing.slicecases:serve_cases", 4,
                      cases, tmp_dir=str(tmp_path / "world"),
                      timeout_s=240)
    tokens, pool = single["paged"]
    docs = _check_serve(ranks, 0, "paged", tokens, tree)
    _check_pools(docs, pool)
    assert sorted(d["model_index"] for d in docs) == [0, 0, 1, 1]
    _check_serve(ranks, 1, "contiguous", single["contiguous"][0], tree)
