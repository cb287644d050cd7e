"""Page sharing in the port's paged KV cache, against the JAX reference.

* One sequence of host operations (admit with shared pages, registry
  pins, a copy on write, a swap out and back in, a grow that needs the
  owner's pressure relief, releases) through both packages'
  ``PagedKVCache``: the same block tables, reference counts, free list,
  ``page_accounting`` and ``occupancy`` after every step, because both
  keep the reference's free-list discipline.
* After the same fp32 prefill the port's swapped-out pages, its pools
  there and ``read_pages`` (also after ``write_pages``) equal the
  reference's within 1e-5; ``quiescent`` and ``rows_in_use`` agree.
* Inside the port, bit for bit: a swap round trip at bf16 and at int8
  (scale slabs included) and a copy on write; a snapshot of the wrong
  length is refused, and the sink page is never handed out or copied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedCacheError, PagedKVCache
from kvedge_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

PAGES, PAGE, SLOTS = 10, 4, 3


def _models(dtype="float32"):
    kw = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=64, max_seq=64, dtype=dtype)
    jcfg = jtr.TransformerConfig(**kw, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**kw)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _host_state(cache):
    return {
        "tables": [list(r) for r in cache._host_tables],
        "lengths": list(cache._host_lengths),
        "refs": list(cache._refs),
        "free": list(cache._free),
        "pages_of": {s: list(p) for s, p in cache._pages_of.items()},
        "accounting": cache.page_accounting(),
        "occupancy": cache.occupancy(),
    }


def _pool(cache, jax_side):
    st = cache.state
    if jax_side:
        return [np.asarray(st.pool_k, np.float32),
                np.asarray(st.pool_v, np.float32)]
    return [st.pool_k.float().numpy(), st.pool_v.float().numpy()]


def _as_np(arrays, jax_side):
    if jax_side:
        return [np.asarray(a, np.float32) for a in arrays]
    return [a.float().numpy() for a in arrays]


def _sequence(cache, params, jax_side):
    """The operation sequence; yields (label, host state) after each step
    and collects the swapped-out pages."""
    rng = np.random.default_rng(3)
    prompt0 = rng.integers(0, 128, 9).tolist()
    prompt1 = prompt0[:8] + [7, 7]
    tok = ((lambda x: jnp.asarray(x, jnp.int32)) if jax_side
           else (lambda x: x))
    pins = []

    def relief(needed):
        # The server's registry: drop the pins, then report.
        cache.release_pages(pins)
        pins.clear()
        return cache.free_pages() >= needed

    cache.pressure_relief = relief
    out = {"states": [], "swaps": []}

    def note(label):
        out["states"].append((label, _host_state(cache)))

    cache.admit(0, len(prompt0))
    cache.prefill_chunk(params, 0, tok(prompt0), 0)
    note("admit 0")
    pins.extend(cache.slot_pages(0)[:2])
    cache.retain_pages(pins)
    note("pin two pages")
    cache.admit(1, len(prompt1), tuple(cache.slot_pages(0)[:2]))
    note("admit 1 on the shared pages")
    out["cow"] = cache.cow_page(1, 1)
    assert cache.cow_page(1, 2) is None  # a private page: no copy
    note("cow")
    cache.prefill_chunk(params, 1, tok(prompt1[5:]), 5)
    note("suffix prefill")
    out["swaps"].append(_as_np(cache.swapout_pages(cache.slot_pages(0)),
                               jax_side))
    cache.release(0)
    note("release 0")
    cache.admit(2, 16)
    note("admit 2")
    assert cache.grow_to(2, 12) is True  # runs the free list dry: relief
    note("grow under pressure")
    saved = cache.swapout_pages(cache.slot_pages(1))
    out["swaps"].append(_as_np(saved, jax_side))
    length = cache.slot_length(1)
    cache.release(1)
    note("swap out 1")
    cache.admit(1, length)
    cache.swapin_pages(cache.slot_pages(1), saved)
    note("swap in 1")
    out["pool"] = _pool(cache, jax_side)
    out["slot1_pages"] = cache.slot_pages(1)
    out["read"] = [np.asarray(x, np.float32)
                   for x in cache.read_pages(cache.slot_pages(1))]
    # The persistence pair: unquantized K/V into a page, read back.
    vals = np.random.default_rng(8).normal(
        size=(2, 2, 1, PAGE, 2, 8)).astype(np.float32)
    target = cache.slot_pages(2)[-1:]
    cache.write_pages(target, vals[0], vals[1])
    out["written"] = [np.asarray(x, np.float32)
                      for x in cache.read_pages(target)]
    out["shape"] = (cache.quiescent(), cache.rows_in_use())
    for slot in (1, 2):
        cache.release(slot)
    note("release all")
    return out


def test_same_operations_give_the_same_books_and_pages():
    jcfg, tcfg, jparams, tparams = _models()
    jout = _sequence(JaxCache(jcfg, slots=SLOTS, pages=PAGES, page_size=PAGE),
                     jparams, True)
    tout = _sequence(PagedKVCache(tcfg, slots=SLOTS, pages=PAGES,
                                  page_size=PAGE, device="cpu"),
                     tparams, False)
    for (label, want), (_, got) in zip(jout["states"], tout["states"]):
        assert got == want, label
    assert tout["cow"] == jout["cow"] is not None
    assert tout["states"][-1][1]["free"] and \
        sorted(tout["states"][-1][1]["free"]) == list(range(PAGES))
    for got, want in zip(tout["swaps"], jout["swaps"]):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    for key in ("read", "written"):
        for g, w in zip(tout[key], jout[key]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert tout["shape"] == jout["shape"] == (True, 3)
    # The resumed slot's pages hold the same K/V in both packages.
    ids = tout["slot1_pages"]
    for g, w in zip(tout["pool"], jout["pool"]):
        np.testing.assert_allclose(g[:, ids], w[:, ids], rtol=1e-5,
                                   atol=1e-5)


def _filled(dtype, kv_dtype):
    _, tcfg, _, tparams = _models(dtype)
    cache = PagedKVCache(tcfg, slots=2, pages=8, page_size=PAGE,
                         kv_dtype=kv_dtype, device="cpu")
    prompt = np.random.default_rng(4).integers(0, 128, 10).tolist()
    cache.admit(0, len(prompt))
    cache.prefill_chunk(tparams, 0, prompt, 0)
    return cache


@pytest.mark.parametrize("dtype,kv_dtype", [("bfloat16", ""),
                                            ("float32", "int8")],
                         ids=["bf16", "int8"])
def test_swap_round_trip_is_byte_exact(dtype, kv_dtype):
    cache = _filled(dtype, kv_dtype)
    ids = cache.slot_pages(0)
    before = [t[:, ids].clone() for t in cache._slabs()]
    saved = cache.swapout_pages(ids)
    assert len(saved) == (4 if kv_dtype else 2)
    assert [a.dtype for a in saved] == [t.dtype for t in before]
    if kv_dtype:
        assert saved[0].dtype == torch.int8 and saved[2].dtype == torch.float32
    else:
        assert saved[0].dtype == torch.bfloat16
    length = cache.slot_length(0)
    cache.release(0)
    cache.admit(1, 3)  # takes the freed pages, so the bytes must move
    cache.prefill_chunk(_models(dtype)[3], 1, [1, 2, 3], 0)
    cache.admit(0, length)
    new_ids = cache.slot_pages(0)
    assert new_ids != ids
    cache.swapin_pages(new_ids, saved)
    for t, b in zip(cache._slabs(), before):
        assert torch.equal(t[:, new_ids], b)
    with pytest.raises(PagedCacheError, match="swap snapshot carries"):
        cache.swapin_pages(new_ids, saved[:1])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_cow_copies_every_slab_and_leaves_the_source(kv_dtype):
    cache = _filled("float32", kv_dtype)
    src = cache.slot_pages(0)[1]
    cache.retain_pages([src])  # a registry pin makes it shared
    before = [t[:, src].clone() for t in cache._slabs()]
    dst = cache.cow_page(0, 1)
    assert dst is not None and dst != src
    assert cache.page_refcount(src) == 1 and cache.page_refcount(dst) == 1
    assert cache.slot_pages(0)[1] == dst
    assert cache.state.tables[0, 1].item() == dst
    for t, b in zip(cache._slabs(), before):
        assert torch.equal(t[:, dst], b) and torch.equal(t[:, src], b)


def test_the_sink_is_never_handed_out():
    _, tcfg, _, _ = _models()
    cache = PagedKVCache(tcfg, slots=2, pages=6, page_size=PAGE, device="cpu")
    sink = cache.state.sink
    assert sink == 6 and sink not in cache._free
    cache.admit(0, 10)  # 3 pages
    pinned = [cache.allocate_pinned_page() for _ in range(2)]
    cache.admit(1, 1)
    taken = cache.slot_pages(0) + pinned + cache.slot_pages(1)
    assert sorted(taken) == list(range(6)) and sink not in taken
    with pytest.raises(PagedCacheError, match="exhausted"):
        cache.allocate_pinned_page()
    with pytest.raises(PagedCacheError, match="exhausted"):
        cache.grow_to(1, 8)  # no pressure relief installed
    for op in (lambda: cache.swapout_pages([sink]),
               lambda: cache.snapshot_pages([0, sink]),
               lambda: cache.write_pages([sink], np.zeros(1), np.zeros(1))):
        with pytest.raises(PagedCacheError, match="outside"):
            op()
    with pytest.raises(PagedCacheError, match="over-released"):
        cache.release_pages(pinned + pinned)
    acct = cache.page_accounting()
    assert acct["neg_refs"] == 1  # the over-release above shows up
