"""The port's contiguous decode (``kvedge_torch/models/decode.py``).

* Against the JAX package's ``models/decode.py`` at fp32 on the same
  weights: ``prefill`` and ``decode_step`` logits within 1e-5 (sum order
  and last-ulp exp/tanh/rsqrt differences), ``generate``'s greedy tokens
  identical, and its sampled tokens identical at top_p < 1 (at top_p = 1
  the nucleus filter's tail depends on the last ulp of the running mass,
  ROADMAP Queue C).
* Inside the port: paged == contiguous on a ragged batch (the
  reference's ``tests/test_decode.py`` oracle): the same greedy tokens,
  logits within 1e-5; and the serve payload's contiguous backend returns
  the paged backend's tokens (``tests/test_serve.py``), with the
  reference's refusals for ``stream``, ``priority`` and ``deadline_ms``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import decode as jdecode
from kvedge_tpu.models import transformer as jtr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import (
    decode_step,
    generate,
    init_cache,
    prefill,
)
from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.models.transformer import forward
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.serve import ServeRuntime, row_key_data

torch.set_num_threads(2)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=64)


def _models(n_kv_heads=2):
    jcfg = jtr.TransformerConfig(**DIMS, n_kv_heads=n_kv_heads,
                                 dtype="float32", remat=False)
    tcfg = TransformerConfig(**DIMS, n_kv_heads=n_kv_heads, dtype="float32")
    jparams = jtr.init_params(jax.random.PRNGKey(2), jcfg)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def _prompt(batch, length, seed=6):
    return np.random.default_rng(seed).integers(0, 128, (batch, length))


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_prefill_and_decode_step_logits_match_reference(n_kv_heads):
    jcfg, tcfg, jparams, tparams = _models(n_kv_heads)
    prompt = _prompt(2, 7)
    jcache = jdecode.init_cache(jcfg, 2, max_seq=16)
    jlogits, jcache = jdecode.prefill(jparams, jnp.asarray(prompt, jnp.int32),
                                      jcache, jcfg)
    tcache = init_cache(tcfg, 2, max_seq=16, device="cpu")
    tlogits, tcache = prefill(tparams, torch.as_tensor(prompt), tcache, tcfg)
    assert tcache.length == 7
    for step in range(5):
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {step}")
        tok = np.array(jnp.argmax(jlogits, axis=-1))
        assert (tlogits.argmax(-1).numpy() == tok).all()
        jlogits, jcache = jdecode.decode_step(
            jparams, jcache, jnp.asarray(tok, jnp.int32), jcfg)
        tlogits, tcache = decode_step(tparams, tcache, torch.as_tensor(tok),
                                      tcfg)
    assert tcache.length == int(jcache.length) == 12
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               rtol=1e-5, atol=1e-5)


def test_generate_greedy_matches_reference_and_forward():
    jcfg, tcfg, jparams, tparams = _models()
    prompt = _prompt(3, 6)
    want = np.asarray(jdecode.generate(
        jparams, jnp.asarray(prompt, jnp.int32), jcfg, n_new=12))
    got = generate(tparams, prompt, tcfg, n_new=12, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (3, 18)
    np.testing.assert_array_equal(got.numpy(), want)
    # Each generated token is the naive forward's argmax.
    logits = forward(tparams, got, tcfg)
    assert (logits[:, 5:-1].argmax(-1) == got[:, 6:]).all()


@pytest.mark.parametrize("temperature,top_p", [(0.8, 0.9), (1.3, 0.7)])
def test_generate_sampled_matches_reference(temperature, top_p):
    jcfg, tcfg, jparams, tparams = _models()
    prompt = _prompt(3, 5, seed=8)
    keys = np.stack([row_key_data(17, r) for r in range(3)])
    want = np.asarray(jdecode.generate(
        jparams, jnp.asarray(prompt, jnp.int32), jcfg, n_new=16,
        sampling=(jnp.asarray(keys), jnp.float32(temperature),
                  jnp.float32(top_p)), sampled=True))
    got = generate(tparams, prompt, tcfg, n_new=16,
                   sampling=(keys, temperature, top_p), sampled=True,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_matches_contiguous_ragged_batch():
    """Two prompts of different lengths decoded together in the paged pool
    equal each decoded alone through the contiguous cache."""
    _, tcfg, _, tparams = _models()
    prompts = {0: _prompt(1, 7, seed=5)[0], 2: _prompt(1, 13, seed=6)[0]}
    paged = PagedKVCache(tcfg, slots=3, pages=16, page_size=4, device="cpu")
    contig, pend = {}, np.zeros(3, np.int64)
    for slot, prompt in prompts.items():
        paged.admit(slot, len(prompt))
        got = paged.prefill(tparams, slot, prompt)
        cache = init_cache(tcfg, 1, max_seq=32, device="cpu")
        want, cache = prefill(tparams, torch.as_tensor(prompt)[None], cache,
                              tcfg)
        np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"prefill {slot}")
        contig[slot] = (want, cache)
        pend[slot] = int(want[0].argmax())
    for step in range(6):
        got = paged.step(tparams, pend)
        for slot in prompts:
            logits, cache = contig[slot]
            tok = logits.argmax(-1)
            assert int(tok[0]) == pend[slot]
            logits, cache = decode_step(tparams, cache, tok, tcfg)
            contig[slot] = (logits, cache)
            np.testing.assert_allclose(
                got[slot].numpy(), logits[0].numpy(), rtol=1e-5, atol=1e-5,
                err_msg=f"step {step} slot {slot}")
        pend = np.where([s in prompts for s in range(3)],
                        got.argmax(-1).numpy(), 0)
    # A window of the paged cache continues the same tokens.
    window = paged.step_window(tparams, pend, 4).numpy()
    for slot in prompts:
        logits, cache = contig[slot]
        for i in range(4):
            tok = logits.argmax(-1)
            assert int(tok[0]) == (pend[slot] if i == 0
                                   else window[i - 1, slot])
            logits, cache = decode_step(tparams, cache, tok, tcfg)


def _runtime(tmp_path, serving):
    cfg = ServeConfig(preset="probe", n_layers=2, max_seq=64,
                      payload_serving=serving, serving_slots=2,
                      serving_prefill_chunk=4, serving_window=4,
                      state_dir=str(tmp_path))
    return ServeRuntime(cfg, device="cpu", dtype="float32", seed=5)


def test_serve_contiguous_backend_matches_paged(tmp_path):
    contiguous = _runtime(tmp_path, "")
    paged = _runtime(tmp_path, "paged")
    try:
        assert contiguous.server is None and paged.server is not None
        for req in ({"tokens": [[5, 9, 2, 7], [1, 1, 4, 3]], "n_new": 5},
                    {"tokens": [[600, 2]], "n_new": 9, "temperature": 0.9,
                     "top_p": 0.8, "seed": 3}):
            got = contiguous.serve_fn(req)
            want = paged.serve_fn(req)
            assert got["tokens"] == want["tokens"]
            assert got["restored_step"] == want["restored_step"] is None
        # A one-row greedy request with "speculative" decodes through
        # generate_speculative: the same tokens.
        req = {"tokens": [[5, 9, 2, 7, 5, 9]], "n_new": 7}
        spec = contiguous.serve_fn(dict(req, speculative=2))
        assert spec["tokens"] == paged.serve_fn(req)["tokens"]
        assert spec["accepted_per_step"] >= 1.0
        for bad, match in (({"stream": True}, "stream"),
                           ({"priority": "batch"}, "priority"),
                           ({"deadline_ms": 50}, "priority"),
                           ({"speculative": 2, "temperature": 0.5},
                            "speculative")):
            with pytest.raises(ValueError, match=match):
                contiguous.serve_fn({"tokens": [[1, 2]], "n_new": 2, **bad})
        assert contiguous.healthy
    finally:
        contiguous.close()
        paged.close()
    assert not contiguous.healthy
