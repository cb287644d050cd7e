"""The port's paged KV cache against the JAX reference, and the port's own
exactness invariants.

* Port ``PagedKVCache`` vs JAX ``PagedKVCache`` through the same admit ->
  chunked prefill -> step -> window sequence on the same weights: fp32
  logits within rtol=atol=1e-4 (sum order and last-ulp exp/tanh/rsqrt
  differences) and identical greedy tokens.
* Inside the port, bit for bit: a window of W greedy steps equals W
  single steps, and paged greedy decode equals the naive ``forward``'s
  argmax over the whole sequence (fp32).
* An int8 pool against the reference's int8 pool, at the bf16 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedCacheError, PagedKVCache
from kvedge_torch.models.transformer import forward
from kvedge_torch.models.weights import params_from_numpy

torch.set_num_threads(2)


def _setup(n_kv_heads=2, dtype="float32", max_seq=64):
    jcfg = jtr.TransformerConfig(
        vocab=128, d_model=64, n_heads=4, n_kv_heads=n_kv_heads, n_layers=2,
        d_ff=128, max_seq=max_seq, dtype=dtype, remat=False,
        paged_attention="gather")
    tcfg = TransformerConfig(
        vocab=128, d_model=64, n_heads=4, n_kv_heads=n_kv_heads, n_layers=2,
        d_ff=128, max_seq=max_seq, dtype=dtype)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 128, n).tolist() for n in (11, 3, 7)]


def _drive(cache, params, prompts, *, jax_side, chunk=4, steps=3, window=4):
    """admit -> chunked prefill -> single steps (one slot sitting out the
    first) -> one window; returns (logit rows, token rows) as numpy."""
    asarr = ((lambda x: jnp.asarray(x, jnp.int32)) if jax_side
             else (lambda x: x))
    logits, tokens = [], []
    pend = np.zeros(len(prompts), np.int64)
    for s, p in enumerate(prompts):
        cache.admit(s, len(p))
        for off in range(0, len(p), chunk):
            last = cache.prefill_chunk(params, s, asarr(p[off:off + chunk]),
                                       off)
        last = np.asarray(last, np.float32) if jax_side else last.numpy()
        logits.append(last)
        pend[s] = int(np.argmax(last))
    for i in range(steps):
        active = np.ones(len(prompts), bool)
        if i == 0:
            active[1] = False  # a half-prefilled-style bystander
        out = cache.step(params, asarr(pend), active=active)
        out = np.asarray(out, np.float32) if jax_side else out.numpy()
        logits.append(out[active])
        pend = np.where(active, out.argmax(-1), pend)
    win = cache.step_window(params, asarr(pend), window,
                            active=np.ones(len(prompts), bool))
    tokens.append(np.asarray(win))
    return np.concatenate([x.reshape(-1, x.shape[-1]) for x in logits]), \
        np.concatenate(tokens)


@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_cache_matches_reference_fp32(n_kv_heads, page_size):
    jcfg, tcfg, jparams, tparams = _setup(n_kv_heads)
    jc = JaxCache(jcfg, slots=3, pages=24, page_size=page_size)
    tc = PagedKVCache(tcfg, slots=3, pages=24, page_size=page_size)
    jl, jt = _drive(jc, jparams, _prompts(), jax_side=True)
    tl, tt = _drive(tc, tparams, _prompts(), jax_side=False)
    print(f"max abs logit err {np.abs(tl - jl).max():.3e}")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt, jt)
    assert tc._host_lengths == list(jc._host_lengths)


def test_int8_pool_matches_reference_at_bf16_tolerance():
    jcfg, tcfg, jparams, tparams = _setup(2)
    jc = JaxCache(jcfg, slots=3, pages=24, page_size=4, kv_dtype="int8")
    tc = PagedKVCache(tcfg, slots=3, pages=24, page_size=4, kv_dtype="int8")
    assert tc.state.pool_k.dtype == torch.int8
    jl, _ = _drive(jc, jparams, _prompts(), jax_side=True, window=2)
    tl, _ = _drive(tc, tparams, _prompts(), jax_side=False, window=2)
    print(f"int8 max abs logit err {np.abs(tl - jl).max():.3e}")
    np.testing.assert_allclose(tl, jl, rtol=3e-2, atol=3e-2)


def _greedy(cfg, params, prompts, n_new, window):
    cache = PagedKVCache(cfg, slots=len(prompts), pages=40, page_size=4)
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
    _, tcfg, _, tparams = _setup(2, dtype)
    prompts = _prompts()
    assert _greedy(tcfg, tparams, prompts, 12, 1) == \
        _greedy(tcfg, tparams, prompts, 12, 4)


def test_paged_decode_equals_forward_argmax_fp32():
    _, tcfg, _, tparams = _setup(2)
    prompts = _prompts()
    got = _greedy(tcfg, tparams, prompts, 10, 4)
    for p, gen in zip(prompts, got):
        seq = torch.tensor([p + gen])
        want = forward(tparams, seq, tcfg)[0, len(p) - 1:-1].argmax(-1)
        assert gen == want.tolist()


def test_host_bookkeeping_and_errors():
    _, tcfg, _, tparams = _setup(2)
    cache = PagedKVCache(tcfg, slots=2, pages=5, page_size=4)
    cache.admit(0, 9)  # 3 pages
    assert cache.free_pages() == 2 and cache.slot_pages(0) == [0, 1, 2]
    assert cache.grow_to(0, 3) is False  # 9 + 3 fits in 3 pages
    assert cache.grow_to(0, 4) is True
    with pytest.raises(PagedCacheError):
        cache.admit(0, 1)
    with pytest.raises(PagedCacheError, match="exhausted"):
        cache.admit(1, 9)
    acct = cache.page_accounting()
    assert acct["free"] + acct["live"] == acct["pages_total"]
    assert acct["free_dup"] == acct["free_live"] == acct["owned_dup"] == 0
    cache.release(0)
    assert cache.free_pages() == 5 and not cache.is_admitted(0)
    with pytest.raises(PagedCacheError):
        cache.release(0)
    with pytest.raises(ValueError):
        PagedKVCache(dataclasses.replace(tcfg), slots=1, pages=1,
                     kv_dtype="fp8")


def test_inactive_rows_write_nothing():
    """A slot marked inactive (its chunked prefill still landing) keeps
    its pages untouched, and an empty slot never writes page 0."""
    _, tcfg, _, tparams = _setup(2)
    cache = PagedKVCache(tcfg, slots=3, pages=12, page_size=4)
    cache.admit(1, 5)
    cache.prefill(tparams, 1, [1, 2, 3, 4, 5])
    cache.admit(2, 6)  # admitted, not prefilled, not active
    before = cache.state.pool_k.clone()
    cache.step(tparams, [0, 7, 0], active=[False, True, False])
    changed = (cache.state.pool_k != before).any(dim=(0, 2, 3, 4))
    # Only slot 1's page holding position 5 changed.
    assert changed.nonzero().flatten().tolist() == [cache.slot_pages(1)[1]]
