"""The port's paged speculative decoding: verify passes and spec windows.

* Against the JAX package at fp32 on the same weights, after the same
  prefills: ``PagedKVCache.step_spec`` gives the reference's emitted
  tokens and accepted counts exactly (drafts that accept fully, in part
  and not at all; a sampled row; an inactive one), its ``logits0``
  within 1e-5 (sum order and last-ulp exp differences), host lengths
  equal, pools within 1e-5; ``spec_window_caps`` equals the reference's
  (called unbound: it reads nothing of ``self``); two spec windows,
  greedy and sampled, the second on the device carry, give the
  reference's emitted, counts and pending exactly, host lengths equal
  and pools within 1e-5.
* Inside the port: windowed spec == per-pass spec == plain greedy, with
  the overlap on and off, and every greedy request equals ``generate``;
  a sampled co-tenant's tokens are bit-identical with speculation on and
  off; slack pages are reserved for greedy requests only; the fallback
  counters move as the reference's (``tests/test_spec_window.py``);
  ``resolve_speculation`` falls back under injected timings
  (``tests/test_serving.py``); no live verify write ever lands past the
  pages its row holds (the page column clamp of ``_scatter_token`` is
  never reached).
* On the card (``cuda`` marker): replayed spec-window graphs equal the
  same windows run eagerly bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

from kvedge_torch.models import kvcache as kvc
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate
from kvedge_torch.models.kvcache import (
    PagedCacheError,
    PagedKVCache,
    run_spec_window,
)
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.serve import row_key_data

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.models import transformer as jtr
    from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jtr = JaxCache = None

torch.set_num_threads(2)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq=64)
K = 3
PROMPTS = {0: [5, 9, 2, 5, 9, 2, 5], 1: [7, 7, 7, 7, 7, 1, 2], 2: [1] * 11,
           3: [3, 1, 4, 1, 5]}
TEMPS = np.array([1.0, 0.8, 1.0, 1.3], np.float32)
TOP_PS = np.array([1.0, 0.9, 1.0, 0.7], np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**DIMS, dtype="float32", remat=False,
                                 paged_attention="gather")
    tcfg = TransformerConfig(**DIMS, dtype="float32")
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def _fill(cache, params, jax_side, prompts=PROMPTS):
    """Admit and prefill every slot; the pending tokens."""
    pend = np.zeros(len(prompts), np.int64)
    for slot, prompt in prompts.items():
        cache.admit(slot, len(prompt))
        arg = jnp.asarray(prompt, jnp.int32) if jax_side else prompt
        logits = cache.prefill(params, slot, arg)
        pend[slot] = (int(np.argmax(np.asarray(logits))) if jax_side
                      else int(logits.argmax()))
    return pend


def _assert_same_state(tc, jc):
    assert tc._host_lengths == list(jc._host_lengths)
    for mine, ref in ((tc.state.pool_k, jc.state.pool_k),
                      (tc.state.pool_v, jc.state.pool_v)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_step_spec_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    jc = JaxCache(jcfg, slots=4, pages=40, page_size=4)
    tc = PagedKVCache(tcfg, slots=4, pages=40, page_size=4, device="cpu")
    pend = _fill(jc, jparams, True)
    assert (_fill(tc, tparams, False) == pend).all()
    # Row 0 drafts its true greedy continuation (accepts K), row 1 one
    # right token then a wrong one, row 2 is sampled (acceptance 0),
    # row 3 sits out.
    greedy = {s: generate(tparams, [p], tcfg, K + 2,
                          device="cpu")[0, len(p):].tolist()
              for s, p in PROMPTS.items()}
    tokens = np.zeros((4, K + 1), np.int32)
    tokens[:, 0] = pend
    tokens[0, 1:] = greedy[0][1:K + 1]
    tokens[1, 1:] = [greedy[1][1], (greedy[1][2] + 1) % 128, 0]
    tokens[2, 1:] = greedy[2][1:K + 1]
    active = np.array([True, True, True, False])
    spec_mask = np.array([True, True, False, True])
    for _ in range(2):  # the second pass from where the first left off
        je, ja, jl = jc.step_spec(jparams, jnp.asarray(tokens), active,
                                  spec_mask)
        te, ta, tl = tc.step_spec(tparams, tokens, active, spec_mask)
        np.testing.assert_array_equal(te, np.asarray(je))
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        _assert_same_state(tc, jc)
        tokens[:, 0] = te[np.arange(4), ta]
    assert ta.tolist() != [0, 0, 0, 0] or ja.tolist() == [0, 0, 0, 0]


def test_first_pass_accepts_as_drafted(models):
    """Leading agreement: K for the true continuation, 1 after one right
    draft, 0 for a sampled row whatever it drafted."""
    _, tcfg, _, tparams = models
    tc = PagedKVCache(tcfg, slots=4, pages=40, page_size=4, device="cpu")
    pend = _fill(tc, tparams, False)
    greedy = {s: generate(tparams, [p], tcfg, K + 2,
                          device="cpu")[0, len(p):].tolist()
              for s, p in PROMPTS.items()}
    tokens = np.zeros((4, K + 1), np.int64)
    tokens[:, 0] = pend
    for s in range(4):
        tokens[s, 1:] = greedy[s][1:K + 1]
    tokens[1, 2] = (tokens[1, 2] + 1) % 128
    emitted, accepted, _ = tc.step_spec(
        tparams, tokens, np.ones(4, bool), np.array([1, 1, 0, 1], bool))
    assert accepted.tolist() == [K, 1, 0, K]
    # Emitted: the accepted drafts, then the bonus token.
    assert emitted[0].tolist() == greedy[0][1:K + 2]
    assert emitted[1, :2].tolist() == greedy[1][1:3]


@pytest.mark.parametrize("n_passes,k_len", [(1, 1), (4, 3), (8, 4)])
def test_spec_window_caps_match_reference(n_passes, k_len):
    budgets = np.array([0, 1, 2, 5, 9, 40, -3])
    smask = np.array([False, True, False, True, True, False, True])
    for mask in (None, smask):
        want = JaxCache.spec_window_caps(None, n_passes, k_len, budgets,
                                         mask)
        got = PagedKVCache.spec_window_caps(n_passes, k_len, budgets, mask)
        np.testing.assert_array_equal(got, np.asarray(want))


def _spec_dispatch(cache, params, pend, ctx, ctx_len, budgets, sampling,
                   jax_side):
    first = pend is not None
    tokens = (jnp.asarray(pend, jnp.int32) if jax_side else pend) \
        if first else None
    if sampling is not None and jax_side:
        sampling = (jnp.asarray(sampling[0]),) + tuple(sampling[1:])
    return cache.dispatch_spec_window(
        params, tokens, 4, K, budgets, ctx=ctx if first else None,
        ctx_len=ctx_len if first else None, sampling=sampling)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_windows_match_reference(models, sampled):
    jcfg, tcfg, jparams, tparams = models
    jc = JaxCache(jcfg, slots=4, pages=60, page_size=4)
    tc = PagedKVCache(tcfg, slots=4, pages=60, page_size=4, device="cpu")
    pend = _fill(jc, jparams, True)
    assert (_fill(tc, tparams, False) == pend).all()
    s_ctx = DIMS["max_seq"] + K + 2
    ctx = np.zeros((4, s_ctx), np.int32)
    ctx_len = np.zeros(4, np.int32)
    for slot, prompt in PROMPTS.items():
        seq = prompt + [int(pend[slot])]
        ctx[slot, :len(seq)] = seq
        ctx_len[slot] = len(seq)
    budgets = np.array([9, 5, 0, 12])  # slot 2 sits the windows out
    sampling = None
    if sampled:
        key_data = np.stack([row_key_data(11, s) for s in range(4)])
        sampling = (key_data, np.array([3, 5, 2, 9]), TEMPS, TOP_PS,
                    np.array([False, True, False, True]))
    for first in (True, False):
        p = pend if first else None
        want = jc.harvest_spec_window(_spec_dispatch(
            jc, jparams, p, ctx, ctx_len, budgets, sampling, True))
        handle = _spec_dispatch(tc, tparams, p, ctx, ctx_len, budgets,
                                sampling, False)
        got = tc.harvest_spec_window(handle)
        for mine, ref in zip(got, want):
            np.testing.assert_array_equal(mine, np.asarray(ref))
        _assert_same_state(tc, jc)
        assert got[1].sum(axis=0)[2] == 0
        if sampled:
            # The next window's key schedule: base + this window's caps.
            sampling = (sampling[0], sampling[1] + handle.caps) + \
                sampling[2:]
    assert not tc.spec_pending()


def test_spec_carry_needs_a_window_in_flight(models):
    _, tcfg, _, tparams = models
    cache = PagedKVCache(tcfg, slots=2, pages=16, page_size=4, device="cpu")
    with pytest.raises(PagedCacheError, match="carry"):
        cache.dispatch_spec_window(tparams, None, 2, K, np.array([3, 0]))
    with pytest.raises(PagedCacheError, match="drafting context"):
        cache.dispatch_spec_window(tparams, np.zeros(2, np.int64), 2, K,
                                   np.array([3, 0]))
    cache.drop_carry()


def test_windowed_spec_equals_per_pass_spec_equals_greedy(models):
    """Eager spec windows (the function the card's graphs capture) and
    per-pass verifies over the same cache state, one slot each: the
    emitted stream is plain greedy decode's."""
    _, tcfg, _, tparams = models
    prompts = {0: [3, 1, 4, 1, 5, 3, 1, 4], 1: [8, 8, 2]}
    n_new = 20
    want = {s: generate(tparams, [p], tcfg, n_new + 1,
                        device="cpu")[0, len(p):].tolist()
            for s, p in prompts.items()}
    # Windows: 3 windows of 3 passes, the later two on the carry.
    cache = PagedKVCache(tcfg, slots=2, pages=40, page_size=4, device="cpu")
    pend = _fill(cache, tparams, False, prompts)
    s_ctx = DIMS["max_seq"] + K + 2
    ctx = np.zeros((2, s_ctx), np.int64)
    ctx_len = np.zeros(2, np.int64)
    streams = {s: [] for s in prompts}
    for slot, prompt in prompts.items():
        ctx[slot, :len(prompt) + 1] = prompt + [int(pend[slot])]
        ctx_len[slot] = len(prompt) + 1
    budgets = np.array([n_new, n_new])
    handles = []
    for i in range(3):
        handles.append(cache.dispatch_spec_window(
            tparams, pend if i == 0 else None, 3, K, budgets - 0,
            ctx=ctx, ctx_len=ctx_len))
    nxt = pend.copy()
    for handle in handles:
        emitted, counts, pending = cache.harvest_spec_window(handle)
        for slot in prompts:
            for p in range(3):
                c = counts[p, slot]
                if c:
                    streams[slot] += [int(nxt[slot])] + \
                        emitted[p, slot, :c - 1].tolist()
                    nxt[slot] = emitted[p, slot, c - 1]
        budgets = budgets - counts.sum(axis=0)
    for slot in prompts:
        got = streams[slot]
        assert got[:n_new] == want[slot][:len(got[:n_new])]
        assert len(got) >= 9  # at least one token a pass ran
    # Per-pass: drafts from the host, one verify at a time.
    cache = PagedKVCache(tcfg, slots=2, pages=40, page_size=4, device="cpu")
    pend = _fill(cache, tparams, False, prompts)
    seqs = {s: list(p) + [int(pend[s])] for s, p in prompts.items()}
    for _ in range(6):
        tokens = np.zeros((2, K + 1), np.int64)
        for slot, seq in seqs.items():
            tokens[slot, 0] = seq[-1]
            tokens[slot, 1:] = PagedGenerationServer._draft(
                type("R", (), {"prompt": seq[:-1], "generated": [],
                               "next_token": seq[-1]}), K)
        emitted, accepted, _ = cache.step_spec(tparams, tokens,
                                               np.ones(2, bool),
                                               np.ones(2, bool))
        for slot in seqs:
            seqs[slot] += emitted[slot, :accepted[slot] + 1].tolist()
    for slot, prompt in prompts.items():
        got = seqs[slot][len(prompt):len(prompt) + n_new]
        assert len(got) >= 7  # at least one token a pass
        assert got == want[slot][:len(got)]


# ---- the server -----------------------------------------------------------

REQUESTS = [([5, 9, 2], 17, None), ([7, 7, 7, 7, 7, 1, 4], 9, None),
            ([3, 1, 4, 1, 5, 3, 1, 4, 1, 5], 23, None),
            ([1, 2, 3, 4], 12, (7, 0, 0.8, 0.9)),
            ([9, 8], 20, (3, 1, 1.2, 1.0))]


def _sampling(s):
    return None if s is None else (row_key_data(s[0], s[1]), s[2], s[3])


def _burst(server, requests=REQUESTS):
    out = [None] * len(requests)

    def one(i):
        prompt, n_new, s = requests[i]
        out[i] = server.submit(prompt, n_new, sampling=_sampling(s))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


@pytest.fixture(scope="module")
def plain_burst(models):
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=3, pages=64,
                                   page_size=4, window=4, device="cpu")
    try:
        return _burst(server)
    finally:
        server.close()


@pytest.mark.parametrize("kw", [
    dict(speculative=3),
    dict(speculative=3, overlap="off"),
    dict(speculative=3, spec_window=4),
    dict(speculative=3, spec_window=4, overlap="off"),
    dict(speculative=3, spec_window=4, spec_sampled_window=False),
    dict(speculative=1, spec_window=1),
    dict(speculative=8, spec_window=2),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_server_tokens_do_not_depend_on_speculation(models, plain_burst, kw):
    """Every request's tokens, greedy and sampled co-tenants alike, are
    bit-identical with speculation on and off; greedy ones are
    ``generate``'s."""
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=3, pages=64,
                                   page_size=4, window=4, prefix_cache=False,
                                   device="cpu", **kw)
    try:
        got = _burst(server)
        stats = server.stats()
    finally:
        server.close()
    assert got == plain_burst
    for (prompt, n_new, s), row in zip(REQUESTS, got):
        if s is None:
            assert row == generate(tparams, [prompt], tcfg, n_new,
                                   device="cpu")[0].tolist()
    acct = stats["page_accounting"]
    assert acct["free"] == acct["pages_total"]
    assert stats["spec_passes"] > 0 and stats["spec_emitted_per_pass"] >= 1
    fallbacks = stats["spec_window_fallbacks"]
    ran = stats.get("spec_windows_total", 0)
    if not kw.get("spec_window"):
        assert ran == 0
    elif kw.get("overlap") == "off":
        assert ran == 0 and fallbacks["overlap_off"] > 0
    elif kw.get("spec_sampled_window") is False:
        # Windows run at all-greedy boundaries, the per-pass path
        # (counted) at mixed ones; which occur depends on timing.
        assert ran + fallbacks["sampled"] > 0
    else:
        assert ran > 0 and sum(fallbacks.values()) == 0


def test_sampled_window_knob_off_falls_back_counted(models):
    """A sampled co-tenant with ``spec_sampled_window=False`` sends the
    batch to the per-pass path, counted under "sampled"; with the knob on
    the windows keep it and the counter stays 0. Tokens are equal."""
    _, tcfg, _, tparams = models
    sampling = _sampling((7, 0, 0.8, 0.9))
    out = {}
    for knob in (True, False):
        server = PagedGenerationServer(tparams, tcfg, slots=2, pages=32,
                                       page_size=4, window=2, speculative=3,
                                       spec_window=4,
                                       spec_sampled_window=knob,
                                       device="cpu")
        try:
            # Co-residency: the sampled request is mid-stream before the
            # greedy one arrives.
            stream = server.submit_stream([1, 2, 3, 4], 40,
                                          sampling=sampling)
            first = next(stream)
            got_g = server.submit([5, 9, 2, 7], 9)
            got_s = [first] + list(stream)
            stats = server.stats()
        finally:
            server.close()
        out[knob] = (got_g, got_s)
        assert stats["spec_window_sampled"] == int(knob)
        if knob:
            assert stats["spec_windows_total"] >= 1
            assert stats["spec_window_fallbacks"]["sampled"] == 0
        else:
            assert stats["spec_window_fallbacks"]["sampled"] >= 1
    assert out[True] == out[False]
    assert out[True][0] == generate(tparams, [[5, 9, 2, 7]], tcfg, 9,
                                    device="cpu")[0].tolist()


def test_slack_is_reserved_for_greedy_requests_only(models):
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=2, pages=40,
                                   page_size=4, speculative=3, device="cpu")
    try:
        # 61 + 3 slack = 64 positions: 16 pages; sampled: ceil(61 / 4).
        assert server._pages_needed(61, True) == 16
        assert server._pages_needed(61, False) == 16
        assert server._pages_needed(60, True) == 16
        assert server._pages_needed(60, False) == 15
        # The table widens by the slack: a full-length greedy request
        # (prompt + n_new == max_seq) still admits.
        assert server._cache.max_pages_per_seq == -(-(64 + 3) // 4)
        prompt = list(range(1, 33))
        got = server.submit(prompt, 32)
        assert got == generate(tparams, [prompt], tcfg, 32,
                               device="cpu")[0].tolist()
        stream = server.submit_stream(
            [5, 6], 30, sampling=_sampling((1, 0, 0.9, 0.9)))
        assert stream._req.pages_reserved == -(-32 // 4)
        list(stream)
    finally:
        server.close()
    plain = PagedGenerationServer(tparams, tcfg, slots=2, pages=40,
                                  page_size=4, device="cpu")
    try:
        assert plain._pages_needed(60, True) == 15
        assert plain._cache.max_pages_per_seq == 16
    finally:
        plain.close()


def test_spec_off_fallback_when_speculation_turns_off_mid_pipeline(models):
    """Speculation disabled with a spec window in flight: the pipeline
    collapses to a boundary (counted "spec_off") and the rest of the
    request rides plain windows, with the same tokens."""
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=1, pages=32,
                                   page_size=4, window=4, speculative=2,
                                   spec_window=2, device="cpu")
    prompt = [3, 1, 4, 1, 5]
    try:
        stream = server.submit_stream(prompt, 40)
        got = [next(stream)]
        server.disable_speculation("test")
        got += list(stream)
        stats = server.stats()
    finally:
        server.close()
    assert prompt + got == generate(tparams, [prompt], tcfg, 40,
                                    device="cpu")[0].tolist()
    assert stats["spec_decision"]["mode"] == "windowed (test)"
    assert "spec_draft_len" not in stats  # speculation is off
    assert stats["spec_window_fallbacks"]["spec_off"] <= 1


def test_resolve_speculation_auto_fallback_and_override(models):
    """When windows beat speculation's best case, "auto" turns it off and
    an explicit K keeps it; both expose the decision in ``stats()``. A
    measured probe runs on the live cache and leaves it empty."""
    _, tcfg, _, tparams = models

    def spec_server(**kw):
        return PagedGenerationServer(tparams, tcfg, slots=2, pages=48,
                                     page_size=4, speculative=4,
                                     device="cpu", **kw)

    slow_spec = {"verify_s": 0.1, "window_s": 0.1, "probed_window": 64}
    server = spec_server()
    try:
        decision = server.resolve_speculation(auto=True, timings=slow_spec)
        assert decision["windows_dominate"] is True
        assert decision["mode"] == "windowed (auto fallback)"
        assert server._spec == 0
        assert server.stats()["spec_decision"]["mode"] == \
            "windowed (auto fallback)"
        assert server.submit([5, 1, 5, 1], 6) == generate(
            tparams, [[5, 1, 5, 1]], tcfg, 6, device="cpu")[0].tolist()
    finally:
        server.close()
    server = spec_server()
    try:
        decision = server.resolve_speculation(auto=False, timings=slow_spec)
        assert decision["mode"] == "speculative (operator override)"
        assert server._spec == 4
        stats = server.stats()
        assert stats["spec_decision"]["windows_dominate"] is True
        assert stats["spec_draft_len"] == 4
    finally:
        server.close()
    fast_spec = {"verify_s": 0.001, "window_s": 10.0, "probed_window": 64,
                 "spec_window_s": 0.002}
    server = spec_server(spec_window=4)
    try:
        decision = server.resolve_speculation(auto=True, timings=fast_spec)
        assert decision["mode"] == "speculative" and server._spec == 4
        assert decision["sampled_window_pays"] is True
        # The measured probe: admits and releases slot 0 around each run.
        measured = server.resolve_speculation(auto=False)
        assert measured["verify_ms"] > 0 and measured["window_ms"] > 0
        assert measured["spec_window_ms"] > 0
        acct = server.stats()["page_accounting"]
        assert acct["free"] == acct["pages_total"]
        assert not server._cache.spec_pending()
    finally:
        server.close()
    with pytest.raises(ValueError, match="spec_window needs"):
        PagedGenerationServer(tparams, tcfg, slots=1, pages=8, page_size=4,
                              spec_window=2, device="cpu")


def test_no_live_write_reaches_past_the_rows_pages(models, monkeypatch):
    """Every live K/V write of a verify pass lands inside the pages its
    row holds: the page column clamp of ``_scatter_token`` would
    otherwise drop it silently into the row's own last page. Checked on
    every scatter of a speculative burst (windows and per-pass, greedy
    and sampled, full-length requests); the check itself fires on a
    write past the pages."""
    _, tcfg, _, tparams = models
    holder = {}
    real = kvc._scatter_token
    seen = {"live": 0}

    def checked(pool, scales, tables, lengths, kv_new, live):
        cache = holder.get("cache")
        if cache is not None and pool.shape[0] - 1 == cache.num_pages:
            held = np.array([len(cache._pages_of.get(b, ()))
                             for b in range(cache.slots)])
            pos = lengths.long().numpy()
            rows = live.numpy()
            seen["live"] += int(rows.sum())
            over = rows & (pos >= held * cache.page_size)
            assert not over.any(), (pos, held, rows)
        return real(pool, scales, tables, lengths, kv_new, live)

    monkeypatch.setattr(kvc, "_scatter_token", checked)
    requests = [(list(range(1, 40)), 25, None), ([7, 7, 7, 7], 60, None),
                ([3, 1, 4, 1, 5, 3, 1, 4], 56, None),
                ([9, 8], 62, (3, 1, 1.2, 1.0))]
    for kw in (dict(spec_window=3), dict(overlap="off")):
        server = PagedGenerationServer(tparams, tcfg, slots=3, pages=64,
                                       page_size=4, window=4, speculative=4,
                                       device="cpu", **kw)
        holder["cache"] = server._cache
        try:
            got = _burst(server, requests)
        finally:
            server.close()
            holder.clear()
        for (prompt, n_new, s), row in zip(requests, got):
            assert len(row) == len(prompt) + n_new
    assert seen["live"] > 0
    # The check can fail: a live write one position past a row's pages.
    cache = PagedKVCache(tcfg, slots=1, pages=4, page_size=4, device="cpu")
    cache.admit(0, 3)
    holder["cache"] = cache
    with pytest.raises(AssertionError):
        kvc._scatter_token(cache.state.pool_k_full[0], None,
                           cache.state.tables,
                           torch.tensor([4], dtype=torch.int32),
                           torch.zeros(1, 2, 16),
                           torch.tensor([True]))


# ---- on the card: a replayed spec graph equals the eager window -----------


class EagerSpecCache(PagedKVCache):
    """The same cache with its spec seam running eagerly: the yardstick
    the graph replays are held to."""

    def _run_device_spec_window(self, params, n_passes, k_len, sampled):
        return run_spec_window(params, self.state, self.cfg, self._spec_in,
                               n_passes, k_len, sampled)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: spec windows replay captured CUDA "
                    "graphs there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graph_spec_window_equals_eager(cuda_device, dtype):
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=128, dtype=dtype)
    params = params_from_numpy(ttr.init_params(4, cfg), cfg, cuda_device)
    s_ctx = cfg.max_seq + K + 2
    key_data = np.stack([row_key_data(11, s) for s in range(4)])
    runs = []
    for cls in (PagedKVCache, EagerSpecCache):
        cache = cls(cfg, slots=4, pages=64, page_size=16,
                    device=cuda_device)
        pend = _fill(cache, params, False)
        ctx = np.zeros((4, s_ctx), np.int64)
        ctx_len = np.zeros(4, np.int64)
        for slot, prompt in PROMPTS.items():
            seq = prompt + [int(pend[slot])]
            ctx[slot, :len(seq)] = seq
            ctx_len[slot] = len(seq)
        outs = []
        for sampled in (False, True):
            sampling = None
            if sampled:
                sampling = (key_data, np.array([1, 4, 2, 9]), TEMPS, TOP_PS,
                            np.array([False, True, False, True]))
            for n in (1, 4):
                budgets = np.array([n * 2, n, 0, 3 * n])
                first = cache.dispatch_spec_window(
                    params, pend, n, K, budgets, ctx=ctx, ctx_len=ctx_len,
                    sampling=sampling)
                second = cache.dispatch_spec_window(
                    params, None, n, K, budgets, sampling=sampling)
                outs += list(cache.harvest_spec_window(first))
                outs += list(cache.harvest_spec_window(second))
                pend = outs[-1].astype(np.int64)
                cache.drop_carry()
                ctx_len = cache._spec_in.ctx_len.cpu().numpy().copy()
                ctx = cache._spec_in.ctx[:, :s_ctx].cpu().numpy().copy()
        runs.append((cache, outs))
    (graph, g_out), (eager, e_out) = runs
    for a, b in zip(g_out, e_out):
        np.testing.assert_array_equal(a, b)
    assert graph._host_lengths == eager._host_lengths
    assert torch.equal(graph.state.lengths, eager.state.lengths)
    assert torch.equal(graph.state.pool_k, eager.state.pool_k)
    assert torch.equal(graph.state.pool_v, eager.state.pool_v)
    assert graph.graph_stats()["spec_graphs"] == 4
