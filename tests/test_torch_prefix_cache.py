"""The port's prefix cache against the JAX reference's.

The cases mirror the reference's own (``tests/test_prefix_cache.py``) at
its small shapes (vocab 128, d_model 32, 4 heads, 2 kv heads, 2 layers,
max_seq 64, page 4), at fp32 on both sides: on the same request
sequences the port's server returns the JAX server's tokens and the same
``prefix_*`` counters. Inside the port, the cache on returns the tokens
of the cache off bit for bit, and the books (leases, reservations, the
host tier's bytes, the pool) settle.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")
STEM = [3, 1, 4, 1, 5, 9, 2, 6]  # two full pages at page_size=4
COUNTERS = ("prefix_entries", "prefix_hits", "prefix_lookups",
            "prefix_tokens_saved", "prefix_cow_copies",
            "prefix_host_entries", "prefix_host_bytes", "prefix_demotions",
            "prefix_promotions", "prefix_evictions", "prefix_bytes_saved")


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _sampling(k, jax_side):
    if k is None:
        return None
    key = jax.random.PRNGKey(k)
    if jax_side:
        return key, jnp.float32(0.8), jnp.float32(0.9)
    return np.asarray(key, np.uint32), 0.8, 0.9


def _both(models, kw, drive):
    """Run ``drive(server, jax_side)`` on a JAX and a port server built
    with the same ``kw``; returns (jax result, port result)."""
    jcfg, tcfg, jparams, tparams = models
    out = []
    for jax_side in (True, False):
        server = (JaxServer(jparams, jcfg, **kw) if jax_side else
                  PagedGenerationServer(tparams, tcfg, device="cpu", **kw))
        try:
            out.append(drive(server, jax_side))
        finally:
            server.close()
    return out


def _counters(server):
    st = server.stats()
    return {k: st[k] for k in COUNTERS}


def _generate(models, prompt, n_new):
    _, tcfg, _, tparams = models
    return generate(tparams, [prompt], tcfg, n_new,
                    device="cpu")[0].tolist()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cow_divergence_matches_reference_and_cache_off(models, sampled):
    """A probe diverging INSIDE a cached entry's last page admits through
    ``cow_page``, with the overlap pipeline and spec windows on."""
    warm = STEM + [5, 3]
    probe = STEM + [5, 8, 9]  # shares 1 token of warm's third page
    kw = dict(slots=3, pages=48, page_size=4, window=4, overlap="on",
              speculative=2, spec_window=2)

    def drive(server, jax_side):
        got = [server.submit(warm, n_new=6,
                             sampling=_sampling(1 if sampled else None,
                                                jax_side)),
               server.submit(probe, n_new=6,
                             sampling=_sampling(2 if sampled else None,
                                                jax_side))]
        return got, _counters(server)

    (jtok, jst), (ttok, tst) = _both(models, dict(kw, prefix_cache=True),
                                     drive)
    assert ttok == jtok
    assert tst == jst
    assert tst["prefix_cow_copies"] == 1 and tst["prefix_hits"] == 1
    assert tst["prefix_tokens_saved"] == 9
    _, tcfg, _, tparams = models
    off = PagedGenerationServer(tparams, tcfg, device="cpu",
                                prefix_cache=False, **kw)
    try:
        assert drive(off, False)[0] == ttok
        assert off.stats()["prefix_cow_copies"] == 0
    finally:
        off.close()


def test_multi_turn_followup_reuses_generated_pages(models):
    def drive(server, jax_side):
        g1 = server.submit(STEM, n_new=8)
        entries = server.stats()["prefix_entries"]
        p2 = g1 + [7, 7]
        g2 = server.submit(p2, n_new=4)
        return [g1, g2], entries, _counters(server)

    (jtok, jent, jst), (ttok, tent, tst) = _both(
        models, dict(slots=2, pages=48, page_size=4, window=4), drive)
    assert ttok == jtok and tst == jst
    # 8 + 8 - 1 = 15 committed tokens -> 3 full pages registered, and the
    # follow-up hits on all of them.
    assert tent == jent == 3
    assert tst["prefix_tokens_saved"] == 12
    assert ttok[0] == _generate(models, STEM, 8)
    assert ttok[1] == _generate(models, ttok[1][:18], 4)


def test_host_tier_demote_then_promote(models):
    pb = [7, 7, 2, 9, 1, 1, 8, 4, 6, 2, 5, 5]
    pc = STEM + [0, 0]

    def drive(server, jax_side):
        got = [server.submit(STEM, n_new=4), server.submit(pb, n_new=8)]
        mid = _counters(server)
        got.append(server.submit(pc, n_new=4))
        return got, mid, _counters(server)

    (jtok, jmid, jst), (ttok, tmid, tst) = _both(
        models, dict(prefix_cache=True, prefix_host_mb=64, slots=1, pages=6,
                     page_size=4, window=4), drive)
    assert ttok == jtok
    assert tmid == jmid and tst == jst
    assert tmid["prefix_demotions"] >= 2
    assert tmid["prefix_evictions"]["admission"] >= 2
    assert tst["prefix_promotions"] == 1 and tst["prefix_hits"] == 1
    assert tst["prefix_tokens_saved"] == 8
    for prompt, n_new, got in ((STEM, 4, ttok[0]), (pb, 8, ttok[1]),
                               (pc, 4, ttok[2])):
        assert got == _generate(models, prompt, n_new)


def test_host_budget_bills_drops_and_lru(models):
    """Oversize records drop ("host_over"); admitting a record over the
    budget evicts host-LRU entries ("host_lru") until the bytes fit."""
    s2 = [2, 7, 1, 8, 2, 8, 1, 8]

    def drive(server, jax_side):
        server.submit(STEM + [5], n_new=4)
        server.submit(s2 + [6], n_new=4)
        with server._lock:
            pb = server._page_bytes_locked()
            server._prefix_host_budget = pb
            order = sorted(server._prefix_entry_nodes,
                           key=lambda n: len(server._node_tokens(n)),
                           reverse=True)
            for node in order:
                server._evict_prefix_node(node, "pressure")
        return pb, _counters(server)

    (jpb, jst), (tpb, tst) = _both(
        models, dict(prefix_cache=True, prefix_host_mb=64, slots=2,
                     pages=32, page_size=4, window=4), drive)
    assert tpb == jpb and tst == jst
    assert tst["prefix_evictions"]["host_over"] == 4
    assert tst["prefix_evictions"]["host_lru"] == 1
    assert tst["prefix_evictions"]["pressure"] == 6
    assert tst["prefix_host_entries"] == 1
    assert tst["prefix_host_bytes"] == tpb
    assert tst["prefix_entries"] == 0


def _stream_in_background(server, prompt, n_new):
    got, errs, done = [], [], threading.Event()

    def consume():
        try:
            for tok in server.submit_stream(prompt, n_new):
                got.append(tok)
        except Exception as e:
            errs.append(e)
        finally:
            done.set()

    threading.Thread(target=consume, daemon=True).start()
    return got, done, errs


def _wait_stats(server, pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        st = server.stats()
        if pred(st):
            return st
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_lease_outlives_registry_eviction(models, overlap):
    """Evicting every registry entry under two live sharers frees none of
    their pages (their tables hold them); both finish with the tokens of
    ``generate`` and the books settle to an all-free pool."""
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, prefix_cache=True, slots=3,
                                   pages=48, page_size=4, window=2,
                                   overlap=overlap, device="cpu")
    try:
        server.submit(STEM + [5], n_new=4)
        pa, pb = STEM + [7, 2], STEM + [8, 3]
        ga, da, ea = _stream_in_background(server, pa, 24)
        gb, db, eb = _stream_in_background(server, pb, 24)
        _wait_stats(server, lambda st: st["active"] == 2
                    and st["prefix_hits"] >= 2)
        with server._lock:
            assert server._lease
            for node in list(server._prefix_entry_nodes):
                server._evict_prefix_node(node, "pressure")
            assert not server._prefix_entry_nodes
        assert da.wait(60) and db.wait(60)
        assert not ea and not eb
        assert ga == _generate(models, pa, 24)[len(pa):]
        assert gb == _generate(models, pb, 24)[len(pb):]
        st = server.stats()
        assert st["reserved_pages"] == 0
        with server._lock:
            assert not server._lease
            for node in list(server._prefix_entry_nodes):
                server._evict_prefix_node(node, "pressure")
            assert server._cache.free_pages() == st["pages_total"]
            assert server._cache.page_accounting()["live"] == 0
    finally:
        server.close()


def test_shed_prices_shared_pages_as_resident(models):
    def drive(server, jax_side):
        server.submit(STEM + [5], n_new=4)
        probe = STEM + [5, 9]  # 2 full shared pages + 1 COW page
        with server._lock:
            _, shared, stok, _ = server._prefix_lookup(probe)
            solo = server._admission_price_locked(4, shared, stok)
            full = tuple(shared[:2])
            server._lease_take_locked(full)
            try:
                price = server._admission_price_locked(4, shared, stok)
                sheds = (server._page_shed_locked("batch", 4) is not None,
                         server._page_shed_locked("batch", price) is not None,
                         server._page_shed_locked("interactive", 4))
            finally:
                server._lease_drop_locked(full)
            return stok, len(shared), solo, price, sheds, server._reserved

    jout, tout = _both(models, dict(prefix_cache=True, slots=2, pages=8,
                                    page_size=4, window=4,
                                    page_low_watermark=0.5), drive)
    assert tout == jout
    assert tout == (9, 3, 4, 2, (True, False, None), 0)


def test_cache_off_keeps_baseline_semantics(models):
    def drive(server, jax_side):
        a = server.submit(STEM + [5], n_new=6)
        b = server.submit(STEM + [5], n_new=6)
        with server._lock:
            leases = dict(server._lease)
        return [a, b], _counters(server), leases

    (jtok, jst, jl), (ttok, tst, tl) = _both(
        models, dict(prefix_cache=False, slots=2, pages=16, page_size=4,
                     window=4), drive)
    assert ttok == jtok and tst == jst and tl == jl == {}
    assert ttok[0] == ttok[1] == _generate(models, STEM + [5], 6)
    assert tst["prefix_entries"] == tst["prefix_hits"] == 0
    assert tst["prefix_lookups"] == 2


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_cache_on_equals_cache_off_on_a_shared_prefix_burst(models, overlap):
    """Concurrent requests over one system prompt, some diverging inside
    its last partial page, sampled and greedy, with a multi-turn
    follow-up: the cache on returns the cache off's tokens."""
    _, tcfg, _, tparams = models
    system = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]  # 2.75 pages
    rng = np.random.default_rng(9)
    reqs = [(system + rng.integers(0, 128, n).tolist(), 8, s)
            for n, s in ((5, None), (9, 3), (2, None), (13, 4))]
    reqs += [(system[:10] + [99, 98], 6, None), (system[:9] + [1], 7, 5)]
    got = {}
    for cache in (True, False):
        server = PagedGenerationServer(tparams, tcfg, prefix_cache=cache,
                                       slots=3, pages=40, page_size=4,
                                       window=4, prefill_chunk=4,
                                       overlap=overlap, device="cpu")
        try:
            first = server.submit(system, n_new=5)
            out = [None] * len(reqs)

            def one(i, server=server, out=out):
                prompt, n_new, s = reqs[i]
                out[i] = server.submit(prompt, n_new,
                                       sampling=_sampling(s, False))

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            follow = server.submit(first + [42, 43], n_new=6)
            st = server.stats()
            got[cache] = ([first] + out + [follow], st)
        finally:
            server.close()
    assert got[True][0] == got[False][0]
    on = got[True][1]
    assert on["prefix_hits"] >= len(reqs) and on["prefix_cow_copies"] >= 1
    assert on["reserved_pages"] == got[False][1]["reserved_pages"] == 0
    assert got[False][1]["prefix_hits"] == 0


@pytest.mark.parametrize("kw,pages", [(dict(overlap="off"), 15),
                                      (dict(speculative=2, spec_window=2),
                                       17)],
                         ids=["serial", "spec-windows"])
def test_mid_decode_grow_reclaims_registry_pins(models, kw, pages):
    """Registry pins sit outside every reservation: a finished request's
    pages stay pinned, a later co-tenant takes the free pages its budget
    covers, and the long request's next grow (a plain window or a spec
    window's worst-case caps) finds the free list short and evicts the
    pins through pressure relief instead of failing. The pool is the
    long request's budget plus the short one's."""
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, prefix_cache=True, slots=2,
                                   pages=pages, page_size=4, window=2,
                                   device="cpu", **kw)
    try:
        long_prompt = [5, 6, 7, 8]
        got, done, errs = _stream_in_background(server, long_prompt, 40)
        _wait_stats(server, lambda st: st["active"] == 1)
        short = server.submit(STEM + [9, 9, 9, 9], n_new=4)
        third = server.submit([1, 2, 3], n_new=13)
        assert done.wait(60) and not errs
        st = server.stats()
        assert st["prefix_evictions"]["pressure"] >= 1
        assert short == _generate(models, STEM + [9, 9, 9, 9], 4)
        assert third == _generate(models, [1, 2, 3], 13)
        assert got == _generate(models, long_prompt, 40)[4:]
        assert st["reserved_pages"] == 0
        assert st["page_accounting"]["neg_refs"] == 0
    finally:
        server.close()


def test_promotion_whose_record_its_own_sweep_drops_falls_back(models):
    """Promoting a host-tier entry first evicts colder pool entries, whose
    demotions may push the very record being promoted out of the host
    budget (host LRU). The admission then falls back to no match and
    prefills in full, with the tokens of ``generate``, and the books
    stay whole."""
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, prefix_cache=True,
                                   prefix_host_mb=64, slots=1, pages=5,
                                   page_size=4, window=4, device="cpu")
    try:
        with server._lock:
            page_bytes = server._page_bytes_locked()
            server._prefix_host_budget = 3 * page_bytes
        server.submit(STEM, n_new=4)  # pins 2 entries (1 and 2 pages)
        pb = [7, 7, 2, 9, 1, 1, 8, 4, 6, 2, 5, 5]
        server.submit(pb, n_new=8)  # evicts them to the host tier
        mid = server.stats()
        assert mid["prefix_host_entries"] == 2
        pc = STEM + [0, 0]
        assert server.submit(pc, n_new=4) == _generate(models, pc, 4)
        st = server.stats()
        assert st["prefix_promotions"] == 0
        assert st["prefix_hits"] == mid["prefix_hits"]
        assert st["prefix_evictions"]["host_lru"] > \
            mid["prefix_evictions"]["host_lru"]
        assert st["prefix_host_bytes"] <= 3 * page_bytes
        assert st["reserved_pages"] == 0
        acct = st["page_accounting"]
        assert acct["neg_refs"] == acct["free_live"] == acct["free_dup"] == 0
    finally:
        server.close()
