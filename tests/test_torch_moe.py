"""The port's mixture-of-experts slice against the JAX reference.

The same numpy inputs, and the reference's own ``init_params`` tree
carried across with ``np.asarray``, go through ``kvedge_tpu`` and
``kvedge_torch``. Tolerances:

* module outputs (``moe_ffn``, ``moe_ffn_dropless``, ``routed_ffn_block``,
  ``_route``'s probabilities and gates, the aux loss) at fp32: rtol =
  atol = 1e-5; routing indices and the dropped rows exactly;
* logits after the layer stack (forward, paged and contiguous decode) at
  fp32: rtol = atol = 1e-4 (two layers of sums in other orders); the
  loss within 1e-5 and every gradient within 1e-4, as the dense
  training tests;
* greedy tokens identical at fp32, whatever the path;
* bf16: the paged cache's logits within 3e-2 of the reference's, and a
  greedy agreement floor of 90% of the tokens.

Inside the port, bit for bit: windowed decode == per-step decode, paged
greedy == contiguous greedy, and the server's tokens with the overlap on
== off == the prefix cache on == spec windows.
"""

import dataclasses
import json
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.config.runtime_config import RuntimeConfigError as JaxError
from kvedge_tpu.models import decode as jdecode
from kvedge_tpu.models import moe as jmoe
from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.runtime import workload as jwork
from kvedge_torch.data.feeder import write_corpus
from kvedge_torch.models import moe as tmoe
from kvedge_torch.models import training as ttrain
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import (
    decode_step,
    generate,
    init_cache,
    prefill,
)
from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import train as tpay
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig
from kvedge_torch.runtime.serve import boot_serve

torch.set_num_threads(2)

SHAPE = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64)
E = 4


def _cfgs(top_k=1, factor=None, dtype="float32", max_seq=128, **kw):
    """The reference's config and the port's; ``factor`` None is the
    drop-free capacity factor E / top_k (serving == training)."""
    moe = dict(n_experts=E, expert_top_k=top_k,
               expert_capacity_factor=factor or E / top_k)
    jcfg = jtr.TransformerConfig(**SHAPE, **moe, max_seq=max_seq,
                                 dtype=dtype, remat=False,
                                 paged_attention="gather", **kw)
    tcfg = TransformerConfig(**SHAPE, **moe, max_seq=max_seq, dtype=dtype,
                             **kw)
    return jcfg, tcfg


def _tree(jcfg, seed=0):
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def _weights(seed, n=40, d=32, f=64, router_scale=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * (router_scale or d ** -0.5)
              ).astype(np.float32)
    w_up = (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32)
    w_down = (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32)
    return x, router, w_up, w_down


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---- moe.py units --------------------------------------------------------


@pytest.mark.parametrize("n,e,factor", [
    (64, 4, 1.0), (64, 4, 1.25), (3, 8, 1.0), (10, 4, 1.25), (8, 2, 0.125),
    (4096, 8, 4.0), (8192, 8, 4.0), (7, 3, 1.5)])
def test_expert_capacity_matches_reference(n, e, factor):
    assert tmoe.expert_capacity(n, e, factor) == \
        jmoe.expert_capacity(n, e, factor)


@pytest.mark.parametrize("router", ["random", "zero"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_reference_ties_to_the_lower_index(top_k, router):
    x, r, _, _ = _weights(1)
    if router == "zero":
        r = np.zeros_like(r)  # every probability ties
    jp, ji, jg = jmoe._route(*_j(x, r), top_k)
    tp, ti, tg = tmoe._route(*_t(x, r), top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    if router == "zero":
        assert (ti.numpy() == np.arange(top_k)).all()
    assert tp.dtype == tg.dtype == torch.float32


@pytest.mark.parametrize("factor", [4.0, 1.0, 0.5], ids=["ample", "binding",
                                                         "tight"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_reference(top_k, factor):
    x, r, wu, wd = _weights(2)
    jout, jaux = jmoe.moe_ffn(*_j(x, r, wu, wd), capacity_factor=factor,
                              top_k=top_k)
    tout, taux = tmoe.moe_ffn(*_t(x, r, wu, wd), capacity_factor=factor,
                              top_k=top_k)
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    # The same rows are dropped whole (top-1) and none at ample capacity.
    dropped = np.abs(jout).sum(1) == 0
    assert ((tout.abs().sum(1) == 0).numpy() == dropped).all()
    if factor == 4.0 or top_k == 2 and factor == 1.0:
        assert not dropped.any()
    elif top_k == 1:
        assert dropped.any()


def test_moe_ffn_gives_first_choices_capacity_priority():
    """The reference's case: token 0 routes (e0, e1), token 1 (e1, e2),
    one slot an expert. Token 1's FIRST choice takes expert 1's slot and
    token 0's second choice is dropped."""
    x = np.eye(2, 4, dtype=np.float32)
    r = np.array([[5.0, 4.0, -9.0, -9.0], [-9.0, 5.0, 4.0, -9.0],
                  [0.0] * 4, [0.0] * 4], np.float32)
    wu = np.stack([np.full((4, 4), e + 1.0, np.float32) for e in range(4)])
    wd = np.ones((4, 4, 4), np.float32)
    jout, _ = jmoe.moe_ffn(*_j(x, r, wu, wd), capacity_factor=0.5, top_k=2)
    tout, _ = tmoe.moe_ffn(*_t(x, r, wu, wd), capacity_factor=0.5, top_k=2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    _, _, gates = tmoe._route(*_t(x, r), 2)
    f0 = 4.0 * float(ttr.gelu(torch.tensor(1.0)))
    np.testing.assert_allclose(tout[0].numpy(), float(gates[0, 0]) * f0,
                               rtol=1e-5)


def test_moe_ffn_gradients_match_reference():
    x, r, wu, wd = _weights(3)

    def jloss(*args):
        out, aux = jmoe.moe_ffn(*args, capacity_factor=1.0, top_k=2)
        return jnp.sum(out * out) + aux

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*_j(x, r, wu, wd))
    leaves = [t.requires_grad_(True) for t in _t(x, r, wu, wd)]
    out, aux = tmoe.moe_ffn(*leaves, capacity_factor=1.0, top_k=2)
    got = torch.autograd.grad(torch.sum(out * out) + aux, leaves)
    for name, g, w in zip(("x", "router", "w_up", "w_down"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_dropless_matches_reference(top_k):
    x, r, wu, wd = _weights(4)
    want = jmoe.moe_ffn_dropless(*_j(x, r, wu, wd), top_k=top_k)
    got = tmoe.moe_ffn_dropless(*_t(x, r, wu, wd), top_k=top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # Drop-free capacity: the training path computes the same function.
    train, _ = tmoe.moe_ffn(*_t(x, r, wu, wd), capacity_factor=E / top_k,
                            top_k=top_k)
    np.testing.assert_allclose(train.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tokens", [40, 64, 150, 160])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routed_ffn_block_matches_reference(top_k, tokens):
    x, r, wu, wd = _weights(5, n=tokens)
    x = x.reshape(2, tokens // 2, -1)
    want = jmoe.routed_ffn_block(*_j(x, r, wu, wd), top_k=top_k)
    got = tmoe.routed_ffn_block(*_t(x, r, wu, wd), top_k=top_k)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_serving_warns_when_training_capacity_can_bind():
    """The reference's risky, safe and top-2 configs."""
    risky = TransformerConfig(
        vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
        max_seq=16, n_experts=4, expert_capacity_factor=1.25)
    safe = dataclasses.replace(risky, expert_capacity_factor=4.0)
    top2 = dataclasses.replace(risky, expert_top_k=2,
                               expert_capacity_factor=2.0)
    with pytest.warns(RuntimeWarning, match="dropless serving") as caught:
        init_cache(risky, batch=2, device="cpu")
    with pytest.warns(RuntimeWarning, match="dropless serving") as theirs:
        jdecode.init_cache(jtr.TransformerConfig(**{
            f.name: getattr(risky, f.name) for f in dataclasses.fields(risky)
            if f.name in {g.name for g in dataclasses.fields(
                jtr.TransformerConfig)}}), batch=2)
    assert str(caught[0].message) == str(theirs[0].message)
    with pytest.warns(RuntimeWarning, match="dropless serving"):
        PagedKVCache(risky, slots=2, pages=8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for cfg in (safe, top2):
            init_cache(cfg, batch=2, device="cpu")
            PagedKVCache(cfg, slots=2, pages=8, device="cpu")


# ---- forward, loss and gradients ------------------------------------------


@pytest.mark.parametrize("factor", [None, 1.0], ids=["dropfree", "binding"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_forward_with_aux_matches_reference(top_k, factor):
    jcfg, tcfg = _cfgs(top_k, factor)
    jparams, tree = _tree(jcfg)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    tokens = np.random.default_rng(6).integers(0, 128, (2, 24))
    jlogits, jaux = jtr.forward_with_aux(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        logits, aux = ttr.forward_with_aux(tparams, torch.from_numpy(tokens),
                                           tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ttr.forward(tparams, torch.from_numpy(tokens), tcfg).numpy(),
        logits.numpy())


@pytest.mark.parametrize("attention,top_k,fused", [
    ("naive", 1, False), ("flash", 2, False), ("naive", 2, True)])
def test_loss_and_every_gradient_match_reference(attention, top_k, fused):
    jcfg, tcfg = _cfgs(top_k, 1.0, attention=attention, fused_xent=fused)
    jparams, tree = _tree(jcfg, seed=1)
    tparams = ttrain.master_params(tree, tcfg, "cpu")
    assert tparams["router"].dtype == torch.float32
    batch = np.random.default_rng(7).integers(
        0, 128, (2, 33)).astype(np.int32)
    want_loss, want = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(batch), jcfg)
    keys = sorted(tparams)
    loss = ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg)
    grads = torch.autograd.grad(loss, [tparams[k] for k in keys])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    assert set(keys) == set(want)
    for key, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_aux_weight_enters_the_loss_as_the_reference_adds_it():
    jcfg, tcfg = _cfgs(2, 1.0)
    _, tree = _tree(jcfg, seed=2)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    batch = torch.from_numpy(np.random.default_rng(8).integers(0, 128, (2, 17)))
    with torch.no_grad():
        loss = ttr.loss_fn(tparams, batch, tcfg)
        plain = ttr.loss_fn(tparams, batch,
                            dataclasses.replace(tcfg, moe_aux_weight=0.0))
        _, aux = ttr.forward_with_aux(tparams, batch[:, :-1], tcfg)
    assert torch.equal(loss, plain + tcfg.moe_aux_weight * aux)


# ---- serving -------------------------------------------------------------


def _prompts(lengths=(11, 3, 7), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n).tolist() for n in lengths]


def _drive(cache, params, prompts, *, jax_side, chunk=4, steps=3, window=4):
    """admit -> chunked prefill -> single steps -> one window; returns
    (logit rows, token rows) as numpy."""
    asarr = ((lambda x: jnp.asarray(x, jnp.int32)) if jax_side
             else (lambda x: x))
    logits = []
    pend = np.zeros(len(prompts), np.int64)
    for s, p in enumerate(prompts):
        cache.admit(s, len(p))
        for off in range(0, len(p), chunk):
            last = cache.prefill_chunk(params, s, asarr(p[off:off + chunk]),
                                       off)
        last = np.asarray(last, np.float32) if jax_side else \
            last.float().numpy()
        logits.append(last[None])
        pend[s] = int(np.argmax(last))
    for _ in range(steps):
        out = cache.step(params, asarr(pend))
        out = np.asarray(out, np.float32) if jax_side else out.float().numpy()
        logits.append(out)
        pend = out.argmax(-1)
    win = cache.step_window(params, asarr(pend), window)
    return np.concatenate(logits), np.asarray(win)


@pytest.mark.parametrize("top_k", [1, 2])
def test_paged_cache_matches_reference(top_k):
    jcfg, tcfg = _cfgs(top_k)
    jparams, tree = _tree(jcfg, seed=3)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    jc = JaxCache(jcfg, slots=3, pages=24, page_size=4)
    tc = PagedKVCache(tcfg, slots=3, pages=24, page_size=4, device="cpu")
    jl, jt = _drive(jc, jparams, _prompts(), jax_side=True)
    tl, tt = _drive(tc, tparams, _prompts(), jax_side=False)
    print(f"max abs logit err {np.abs(tl - jl).max():.3e}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt, jt)


def test_paged_cache_bf16_matches_reference_at_a_stated_tolerance():
    jcfg, tcfg = _cfgs(2, dtype="bfloat16")
    jparams, tree = _tree(jcfg, seed=3)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    assert tparams["router"].dtype == torch.float32
    assert tparams["w_up_experts"].dtype == torch.bfloat16
    jc = JaxCache(jcfg, slots=3, pages=24, page_size=4)
    tc = PagedKVCache(tcfg, slots=3, pages=24, page_size=4, device="cpu")
    jl, jt = _drive(jc, jparams, _prompts(), jax_side=True)
    tl, tt = _drive(tc, tparams, _prompts(), jax_side=False)
    print(f"bf16 max abs logit err {np.abs(tl - jl).max():.3e}, tokens "
          f"{(tt == jt).mean():.3f}")
    np.testing.assert_allclose(tl, jl, rtol=3e-2, atol=3e-2)
    assert (tt == jt).mean() >= 0.9


@pytest.mark.parametrize("top_k", [1, 2])
def test_paged_equals_contiguous_and_the_reference(top_k):
    jcfg, tcfg = _cfgs(top_k)
    jparams, tree = _tree(jcfg, seed=4)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    prompt = _prompts((8,))[0]
    paged = PagedKVCache(tcfg, slots=2, pages=8, page_size=8, device="cpu")
    paged.admit(0, 8)
    got = paged.prefill(tparams, 0, prompt)
    cache = init_cache(tcfg, batch=1, max_seq=32, device="cpu")
    logits, cache = prefill(tparams, torch.tensor([prompt]), cache, tcfg)
    jcache = jdecode.init_cache(jcfg, batch=1, max_seq=32)
    jlogits, jcache = jdecode.prefill(jparams, jnp.asarray([prompt]), jcache,
                                      jcfg)
    for step in range(4):
        np.testing.assert_allclose(got.numpy(), logits[0].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(step))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4, err_msg=str(step))
        tok = torch.argmax(logits, -1)
        assert int(tok[0]) == int(jnp.argmax(jlogits[0]))
        got = paged.step(tparams, torch.stack([tok[0], torch.tensor(0)]))[0]
        logits, cache = decode_step(tparams, cache, tok, tcfg)
        jlogits, jcache = jdecode.decode_step(
            jparams, jcache, jnp.asarray(tok.numpy(), jnp.int32), jcfg)


@pytest.mark.parametrize("top_k,prompt_len", [(1, 8), (2, 8), (2, 96)])
def test_generate_equals_forward_argmax_and_reference(top_k, prompt_len):
    """Drop-free capacity: cached dropless decode equals the capacity
    forward's argmax; a 96-token prompt prefills past the 64-token
    gather limit (the chunked path)."""
    jcfg, tcfg = _cfgs(top_k)
    jparams, tree = _tree(jcfg, seed=5)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    prompt = np.random.default_rng(9).integers(0, 128, (2, prompt_len))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        out = generate(tparams, prompt, tcfg, n_new=6, device="cpu")
    assert out.shape == (2, prompt_len + 6)
    logits = ttr.forward(tparams, out[:, :-1], tcfg)
    np.testing.assert_array_equal(
        torch.argmax(logits[:, prompt_len - 1:], -1).numpy(),
        out[:, prompt_len:].numpy())
    want = jdecode.generate(jparams, jnp.asarray(prompt, jnp.int32), jcfg,
                            n_new=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _greedy(cfg, params, prompts, n_new, window):
    cache = PagedKVCache(cfg, slots=len(prompts), pages=60, page_size=4,
                         device="cpu")
    pend = []
    for s, p in enumerate(prompts):
        cache.admit(s, len(p))
        pend.append(int(torch.argmax(cache.prefill(params, s, p))))
    out = [[t] for t in pend]
    toks = torch.tensor(pend)
    left = n_new - 1
    while left:
        w = min(window, left)
        if w == 1:
            toks = cache.step_tokens(params, toks)
            rows = toks[None]
        else:
            rows = cache.step_window(params, toks, w)
            toks = rows[-1]
        for s in range(len(prompts)):
            out[s] += rows[:, s].tolist()
        left -= w
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_decode_equals_per_step_bitwise(dtype):
    _, tcfg = _cfgs(2, dtype=dtype)
    tparams = params_from_numpy(ttr.init_params(6, tcfg), tcfg, "cpu")
    prompts = _prompts((11, 70, 7))
    assert _greedy(tcfg, tparams, prompts, 12, 1) == \
        _greedy(tcfg, tparams, prompts, 12, 4)


# (prompt, n_new, sampling (seed, row, temperature, top_p) or None)
REQUESTS = [
    (list(range(5, 16)), 9, None),
    ([100, 3], 6, None),
    ([1, 2, 3, 4, 5, 6] * 2, 12, (11, 0, 0.8, 0.9)),
    ([9] * 9, 7, None),
    ([42] * 15, 5, (3, 0, 0.5, 0.7)),
]


def _sampling(s, jax_side):
    from kvedge_torch.runtime.serve import row_key_data

    if s is None:
        return None
    seed, row, t, p = s
    if jax_side:
        return (jax.random.fold_in(jax.random.PRNGKey(seed), row),
                jnp.float32(t), jnp.float32(p))
    return (row_key_data(seed, row), t, p)


def _serially(server, jax_side, requests=REQUESTS):
    return [server.submit(p, n, sampling=_sampling(s, jax_side))
            for p, n, s in requests]


@pytest.fixture(scope="module")
def served():
    """The reference server's tokens for REQUESTS (fp32, top-2, a
    repeated prompt so the prefix cache hits), and the weights."""
    jcfg, tcfg = _cfgs(2, max_seq=64)
    jparams, tree = _tree(jcfg, seed=7)
    jserver = JaxServer(jparams, jcfg, slots=2, pages=48, page_size=4,
                        prefill_chunk=4, prefix_cache=False, overlap="off",
                        window=4)
    try:
        want = _serially(jserver, True)
    finally:
        jserver.close()
    return tcfg, params_from_numpy(tree, tcfg, "cpu"), want


@pytest.mark.parametrize("variant", [
    dict(overlap="off"), dict(overlap="on"),
    dict(overlap="on", prefix_cache=True),
    dict(overlap="on", speculative=3, spec_window=4)],
    ids=["overlap_off", "overlap_on", "prefix_cache", "spec_windows"])
def test_server_tokens_match_reference_server(served, variant):
    tcfg, tparams, want = served
    kw = dict(prefix_cache=False)
    kw.update(variant)
    server = PagedGenerationServer(tparams, tcfg, slots=2, pages=48,
                                   page_size=4, prefill_chunk=4, window=4,
                                   device="cpu", **kw)
    try:
        got = _serially(server, False) + _serially(server, False)
        stats = server.stats()
    finally:
        server.close()
    assert got == want + want
    if variant.get("prefix_cache"):
        assert stats["prefix_hits"] > 0
    if variant.get("spec_window"):
        assert stats["spec_windows_total"] > 0


def test_int8_server_matches_reference_int8_server():
    jcfg, tcfg = _cfgs(1, max_seq=64)
    jparams, tree = _tree(jcfg, seed=8)
    greedy = [r for r in REQUESTS if r[2] is None]
    jserver = JaxServer(jparams, jcfg, slots=2, pages=48, page_size=4,
                        prefill_chunk=4, prefix_cache=False, overlap="off",
                        window=4, kv_dtype="int8")
    try:
        want = _serially(jserver, True, greedy)
    finally:
        jserver.close()
    server = PagedGenerationServer(params_from_numpy(tree, tcfg, "cpu"),
                                   tcfg, slots=2, pages=48, page_size=4,
                                   prefill_chunk=4, window=4,
                                   prefix_cache=False, kv_dtype="int8",
                                   device="cpu")
    try:
        got = _serially(server, False, greedy)
    finally:
        server.close()
    assert got == want


# ---- runtime ---------------------------------------------------------------


GRID = [
    "experts = 8\n", "experts = 8\nexpert_top_k = 2\n",
    "experts = 4\nexpert_top_k = 1\nexpert_capacity_factor = 1.25\n",
    "experts = 4\nexpert_capacity_factor = 2\n",
    "experts = 2\nexpert_top_k = 2\nexpert_capacity_factor = 0.5\n", "",
]


@pytest.mark.parametrize("model", GRID)
def test_model_config_derives_the_moe_fields_as_the_reference(model):
    text = f'[model]\npreset = "probe"\n{model}'
    ours = ServeConfig.parse(text).model_config()
    theirs, _ = jwork.derive_model_config(JaxConfig.parse(text), seq=128)
    for name in ("n_experts", "expert_top_k", "expert_capacity_factor",
                 "param_count"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("model,derive", [
    ("experts = -1\n", False), ("expert_top_k = 3\n", False),
    ("expert_capacity_factor = -1.0\n", False),
    ("expert_top_k = 2\n", True), ("expert_capacity_factor = 2.0\n", True),
    ("experts = 1\nexpert_top_k = 2\n", True)])
def test_moe_refusals_carry_the_reference_messages(model, derive):
    text = f"[model]\n{model}"
    if derive:
        with pytest.raises(ValueError) as theirs:
            jwork.derive_model_config(JaxConfig.parse(text), seq=128)
        with pytest.raises(RuntimeConfigError) as ours:
            ServeConfig.parse(text).model_config()
    else:
        with pytest.raises(JaxError) as theirs:
            JaxConfig.parse(text)
        with pytest.raises(RuntimeConfigError) as ours:
            ServeConfig.parse(text)
    assert str(ours.value) == str(theirs.value)


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_generate_route_matches_the_reference_serve_payload(tmp_path):
    """Both payloads' serve paths on one MoE tree at fp32: the reference's
    ``_build_serve`` (what ``run_serve_payload`` runs once it has params)
    and the port's ``ServeRuntime`` behind ``POST /generate``."""
    text = ('[model]\npreset = "probe"\nn_layers = 2\nexperts = 4\n'
            'expert_top_k = 2\n[payload]\nserving = "paged"\n'
            'serving_slots = 2\nserving_prefill_chunk = 8\n'
            'serving_window = 4\nserving_prefix_cache = false\n')
    jcfg_rt = dataclasses.replace(JaxConfig.parse(text),
                                  state_dir=str(tmp_path / "jax"),
                                  train_seq=64, expected_platform="cpu")
    jcfg, _ = jwork.train_model_config(jcfg_rt)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    check, serve_fn = jwork._build_serve(
        jcfg_rt, jwork.run_device_check(jcfg_rt), jcfg, jparams, None)
    assert check.ok, check.error
    body = {"tokens": [[1, 2, 3, 9, 9], [400, 5, 6, 7, 8]], "n_new": 6}
    try:
        want = serve_fn(dict(body))
    finally:
        serve_fn.close()
    cfg = dataclasses.replace(ServeConfig.parse(text), max_seq=64,
                              state_dir=str(tmp_path / "port"))
    rt = boot_serve(cfg, device="cpu", dtype="float32",
                    params={k: np.asarray(v) for k, v in jparams.items()},
                    host="127.0.0.1", port=0)
    try:
        assert rt.tcfg.n_experts == 4 and rt.tcfg.expert_top_k == 2
        got = _post(f"http://127.0.0.1:{rt.port}/generate", body)
    finally:
        rt.close()
    assert got["tokens"] == want["tokens"]


def test_train_checkpoint_resume_then_serve_matches_teacher_forcing(tmp_path):
    corpus = tmp_path / "corpus.kvfeed"
    rng = np.random.default_rng(13)
    write_corpus(str(corpus), rng.integers(0, 512, 4000, dtype=np.int32))
    text = ('[model]\npreset = "probe"\nn_layers = 2\nexperts = 4\n'
            'expert_top_k = 2\n'
            f'[runtime]\nstate_dir = "{tmp_path / "state"}"\n'
            f'[payload]\nkind = "train"\ncorpus = "{corpus}"\nseq = 32\n'
            'batch = 4\nsteps = 2\ncheckpoint_every = 2\n'
            'attention = "flash"\n')
    cfg = ServeConfig.parse(text)
    first = tpay.run_train_payload(cfg, device="cpu", dtype="float32")
    assert first.ok, first.error
    assert first.step == 2 and first.resumed_from is None
    again = tpay.run_train_payload(dataclasses.replace(cfg, train_steps=3),
                                   device="cpu", dtype="float32")
    assert again.ok and again.resumed_from == 2 and again.step == 3
    tcfg = cfg.model_config("float32")
    step, tree = tpay.restore_latest_params(cfg, tcfg)
    assert step == 3 and tree["w_up_experts"].shape == (2, 4, 128, 512)
    serve_cfg = dataclasses.replace(cfg, payload="serve",
                                    payload_serving="paged")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        rt = boot_serve(serve_cfg, device="cpu", dtype="float32",
                        host="127.0.0.1", port=0)
    try:
        got = _post(f"http://127.0.0.1:{rt.port}/generate",
                    {"tokens": [[3, 1, 4]], "n_new": 3})
    finally:
        rt.close()
    assert got["restored_step"] == 3
    params = params_from_numpy(tree, tcfg, "cpu")
    so_far = torch.tensor([[3, 1, 4]])
    for _ in range(3):
        nxt = torch.argmax(ttr.forward(params, so_far, tcfg)[:, -1], -1)
        so_far = torch.cat([so_far, nxt[:, None]], dim=1)
    assert got["tokens"] == so_far.tolist()
