"""The port's contiguous speculative decoding and the speculation knobs.

* Against the JAX package's ``models/speculative.py`` on the same
  numpy-seeded weights: the batched ``_propose_ngram`` equals the
  reference's under ``vmap`` exactly (no match, length 2, a match whose
  continuation is clipped at the end of ctx, random contexts);
  ``generate_speculative`` gives identical tokens and an equal ``rate``
  for draft 1, 3, 4 and 8 at fp32 and bf16 (GQA) and at fp32 MHA, and
  equals the port's plain greedy ``generate``; a batch is refused with
  the reference's message; ``n_new = 1`` runs no verify pass (rate 0.0).
* ``torch.argmax`` picks the first maximum at a constructed tie, as
  ``jnp.argmax`` does (acceptance compares argmaxes).
* The three knobs (``serving_speculative``, ``serving_spec_window``,
  ``serving_spec_sampled_window``) parse and validate as the reference's
  (``tests/test_runtime_config.py``).
* The HTTP path: a per-request ``"speculative": K`` on the contiguous
  backend returns the plain request's tokens and ``accepted_per_step``
  (``tests/test_speculative.py``); the parser's refusals stay. The paged
  backend with a draft length ("auto" or K) runs the boot probe and
  prints its decision.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.speculative import _propose_ngram as jax_propose
from kvedge_tpu.models.speculative import (
    generate_speculative as jax_generate_speculative,
)
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.speculative import (
    _propose_ngram,
    generate_speculative,
)
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import (
    RuntimeConfig,
    RuntimeConfigError,
    _spec_draft_len,
)
from kvedge_torch.runtime.serve import ServeRuntime, boot_serve

torch.set_num_threads(2)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=64)
# A prompt with a repeated span, so drafts accept, and one without.
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 3, 1, 4, 1, 5, 9],
           [17, 2, 99, 40, 8])


def _models(n_kv_heads, dtype):
    jcfg = jtr.TransformerConfig(**DIMS, n_kv_heads=n_kv_heads, dtype=dtype,
                                 remat=False)
    tcfg = TransformerConfig(**DIMS, n_kv_heads=n_kv_heads, dtype=dtype)
    jparams = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    tree = {k: np.asarray(v.astype(jnp.float32)) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def _ctx_cases():
    rng = np.random.default_rng(8)
    s = 16
    cases = []
    # Random contexts over 4 ids: many bigram matches, every length.
    ctx = rng.integers(0, 4, (6, s))
    cases.append((ctx, np.array([2, 5, 9, 16, 12, 3])))
    # No match anywhere: distinct ids, so the last token repeats.
    cases.append((np.arange(2 * s).reshape(2, s), np.array([7, 16])))
    # The only match sits near the end: its continuation start p + 2
    # exceeds S - k and clips.
    ctx = np.arange(100, 100 + s)[None].repeat(2, axis=0)
    ctx[0, 12:14] = ctx[0, 14:16] = [1, 2]
    ctx[1, 0:2] = ctx[1, 4:6] = [5, 6]
    cases.append((ctx, np.array([16, 6])))
    return cases


@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_batched_proposer_matches_reference_vmap(k):
    """Exact: token ids, no tolerance."""
    for ctx, length in _ctx_cases():
        want = jax.vmap(lambda c, n: jax_propose(c, n, k))(
            jnp.asarray(ctx, jnp.int32), jnp.asarray(length, jnp.int32))
        got = _propose_ngram(torch.from_numpy(ctx).long(),
                             torch.from_numpy(length), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_proposer_drafts_the_continuation_and_clips():
    ctx, length = _ctx_cases()[2]
    got = _propose_ngram(torch.from_numpy(ctx).long(),
                         torch.from_numpy(length), 4).tolist()
    # Row 0's match at 12 continues from 14, clipped to S - k = 12.
    assert got[0] == ctx[0, 12:16].tolist()
    # Row 1's bigram (5, 6) first occurs at 0: the draft follows it.
    assert got[1] == ctx[1, 2:6].tolist()


@pytest.mark.parametrize("n_kv_heads,dtype,k", [
    (2, "float32", 1), (2, "float32", 3), (2, "float32", 4),
    (2, "float32", 8), (2, "bfloat16", 1), (2, "bfloat16", 3),
    (2, "bfloat16", 4), (2, "bfloat16", 8), (4, "float32", 4),
], ids=lambda v: str(v))
def test_generate_speculative_matches_reference(n_kv_heads, dtype, k):
    """Tokens identical (exact) and the fp32 rate equal (exact) to the
    JAX package's, on the same weights; and equal to plain greedy."""
    jcfg, tcfg, jparams, tparams = _models(n_kv_heads, dtype)
    for prompt in PROMPTS:
        want, want_rate = jax_generate_speculative(
            jparams, jnp.asarray([prompt], jnp.int32), jcfg, n_new=24,
            draft_len=k)
        got, rate = generate_speculative(tparams, [prompt], tcfg, 24,
                                         draft_len=k, device="cpu")
        assert got.tolist() == np.asarray(want).tolist()
        assert rate == float(want_rate)
        greedy = generate(tparams, [prompt], tcfg, 24, device="cpu")
        assert got.tolist() == greedy.tolist()
    # The repeated span's drafts accept: more than one token a pass.
    _, rate = generate_speculative(tparams, [PROMPTS[0]], tcfg, 24,
                                   draft_len=k, device="cpu")
    assert 1.0 <= rate <= k + 1


def test_generate_speculative_refuses_a_batch_and_runs_n_new_1():
    _, tcfg, _, tparams = _models(2, "float32")
    with pytest.raises(ValueError, match="single-sequence"):
        generate_speculative(tparams, [[1, 2], [3, 4]], tcfg, 4,
                             device="cpu")
    got, rate = generate_speculative(tparams, [PROMPTS[1]], tcfg, 1,
                                     device="cpu")
    assert rate == 0.0
    assert got.tolist() == generate(tparams, [PROMPTS[1]], tcfg, 1,
                                    device="cpu").tolist()


def test_argmax_picks_the_first_maximum_like_jax():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 1.0
    logits[1, [0, 9]] = 3.0
    logits[2, :] = -1.0
    got = torch.argmax(torch.from_numpy(logits), dim=-1).tolist()
    assert got == np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1)
                             ).tolist() == [2, 0, 0]


# ---- the knobs ------------------------------------------------------------

def test_serving_speculative_knobs_parse_and_validate():
    cfg = RuntimeConfig.parse(
        "[payload]\nserving = 'paged'\nserving_speculative = 4\n"
        "serving_spec_window = 8\nserving_spec_sampled_window = false\n")
    assert (cfg.serving_speculative, cfg.serving_spec_window,
            cfg.serving_spec_sampled_window) == (4, 8, False)
    default = RuntimeConfig.parse("")
    assert (default.serving_speculative, default.serving_spec_window,
            default.serving_spec_sampled_window) == (0, 0, True)
    auto = RuntimeConfig.parse("[payload]\nserving_speculative = 'auto'\n"
                               "serving_spec_window = 4\n")
    assert auto.serving_speculative == "auto"
    assert auto.serving_spec_window == 4
    # "auto" sizes the pools for draft 4; an explicit K for itself.
    assert [_spec_draft_len(c) for c in (auto, cfg, default)] == [4, 4, 0]
    assert RuntimeConfig.parse(
        "[payload]\nserving_speculative = 16\n").serving_speculative == 16
    for bad in ("serving_speculative = 'always'",
                "serving_speculative = -1",
                "serving_speculative = 17",
                "serving_spec_window = -1",
                "serving_spec_window = 65",
                # Windows without speculation have no drafts to run.
                "serving_spec_window = 4",
                "serving_spec_sampled_window = 'yes'"):
        with pytest.raises(RuntimeConfigError):
            RuntimeConfig.parse(f"[payload]\n{bad}\n")


# ---- the HTTP path --------------------------------------------------------

def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_speculative_request_flag(tmp_path):
    """The contiguous backend serves ``"speculative": K`` with the plain
    request's tokens and ``accepted_per_step``; invalid combinations are
    400s."""
    cfg = RuntimeConfig(preset="probe", n_layers=2, max_seq=32,
                        state_dir=str(tmp_path))
    rt = boot_serve(cfg, device="cpu", dtype="float32", seed=4,
                    host="127.0.0.1", port=0)
    try:
        url = f"http://127.0.0.1:{rt.port}/generate"
        body = {"tokens": [[3, 1, 4, 1, 3, 1]], "n_new": 8}
        code, plain = _post(url, body)
        assert code == 200
        code, spec = _post(url, dict(body, speculative=4))
        assert code == 200
        assert spec["tokens"] == plain["tokens"]
        assert spec["accepted_per_step"] >= 1.0
        assert "accepted_per_step" not in plain
        for bad in ({"speculative": 4, "temperature": 0.5},
                    {"speculative": 4, "tokens": [[1, 2], [3, 4]]},
                    {"speculative": 17}):
            code, doc = _post(url, dict(body, **bad))
            assert code == 400 and "speculative" in doc["error"], doc
    finally:
        rt.close()


@pytest.mark.parametrize("spec", ["auto", 3])
def test_paged_backend_runs_the_boot_probe(tmp_path, capsys, spec):
    """A draft length > 0 on the paged backend runs ``resolve_speculation``
    at boot and prints its decision; "auto" sizes the pools for draft 4
    and may turn speculation off, an explicit K keeps it. Tokens are
    greedy decode's either way."""
    cfg = RuntimeConfig(preset="probe", n_layers=2, max_seq=32,
                        payload_serving="paged", serving_slots=2,
                        serving_window=4, serving_speculative=spec,
                        serving_spec_window=2, state_dir=str(tmp_path))
    rt = ServeRuntime(cfg, device="cpu", dtype="float32", seed=4)
    try:
        assert "[kvedge-serve] speculative mode:" in capsys.readouterr().out
        decision = rt.spec_decision
        assert decision["draft_len"] == _spec_draft_len(cfg)
        assert rt.server.stats()["spec_decision"] == decision
        assert rt.server._cache.max_pages_per_seq == \
            -(-(32 + _spec_draft_len(cfg)) // 16)
        if spec == 3:
            assert rt.server._spec == 3
        else:
            assert (rt.server._spec == 0) == decision["windows_dominate"]
        prompt = [3, 1, 4, 1, 3, 1]
        doc = rt.serve_fn({"tokens": [prompt], "n_new": 8})
        assert doc["tokens"] == generate(rt.weights, [prompt], rt.tcfg, 8,
                                         device="cpu").tolist()
    finally:
        rt.close()
