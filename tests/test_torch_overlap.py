"""The port's capped decode windows and overlap pipeline.

* Against the JAX package, at fp32 on the same weights: the port's capped
  greedy and sampled windows (``dispatch_window`` /
  ``dispatch_window_sampled`` + ``harvest_window``) give the reference's
  ``[W + 2, slots]`` blocks EXACTLY (tokens, ``fin``, ``stop_at``), for
  caps {0, 1, 3, W}, one inactive slot, a stop token that hits
  mid-window and sampled rows at top_p < 1; then a second window on the
  device carry. Host lengths are equal and the pools within 1e-5.
* Ports of the reference's ``tests/test_overlap.py``: mid-window cancel,
  a capped window freezes finished rows, the pipeline carry equals one
  serial window, the carry needs a window in flight, overlap "off"
  reports serial, the knob validates.
* The server's tokens do not depend on the overlap: "on" == "off" ==
  the reference server's, over a concurrent greedy, sampled and stop
  burst.
* On the card (``cuda`` marker): a replayed window graph equals the same
  window run eagerly bit for bit (tokens, ``[fin, stop_at]``, lengths,
  pools) at bf16 and fp32, greedy and sampled.
"""

import threading
import time

import numpy as np
import pytest
import torch

from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import (
    PagedCacheError,
    PagedKVCache,
    run_window,
)
from kvedge_torch.models.serving import PagedGenerationServer, RequestCancelled
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.models import transformer as ttr
from kvedge_torch.ops import paged_attention as tpa
from kvedge_torch.runtime.serve import row_key_data

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.models import generate as jax_generate
    from kvedge_tpu.models import transformer as jtr
    from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
    from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jax_generate = jtr = JaxCache = JaxServer = None

torch.set_num_threads(2)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq=64)
W = 6
PROMPTS = {0: [5, 9, 2], 1: [7, 7, 7, 7, 7, 1, 2], 2: [1] * 11,
           3: [3, 1, 4, 1, 5], 4: [9, 8]}
CAPS = np.array([0, 1, 3, W, W], np.int64)
ACTIVE = np.array([True, True, True, True, False])  # slot 4 sits out
SAMPLED = np.array([False, True, False, True, False])
TEMPS = np.array([1.0, 0.8, 1.0, 1.3, 1.0], np.float32)
TOP_PS = np.array([1.0, 0.9, 1.0, 0.7, 1.0], np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**DIMS, dtype="float32", remat=False,
                                 paged_attention="gather")
    tcfg = TransformerConfig(**DIMS, dtype="float32")
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def _fill(cache, params, jax_side):
    """Admit and prefill every slot of PROMPTS; the pending tokens."""
    pend = np.zeros(len(PROMPTS), np.int64)
    for slot, prompt in PROMPTS.items():
        cache.admit(slot, len(prompt))
        arg = jnp.asarray(prompt, jnp.int32) if jax_side else prompt
        logits = cache.prefill(params, slot, arg)
        pend[slot] = (int(np.argmax(np.asarray(logits))) if jax_side
                      else int(logits.argmax()))
    return pend


def _sampling():
    key_data = np.stack([row_key_data(11, s) for s in range(len(PROMPTS))])
    base = np.array([3, 5, 2, 9, 1], np.int64)
    return key_data, base


def _dispatch(cache, params, pend, sampled, stops, jax_side):
    tokens = None if pend is None else (
        jnp.asarray(pend, jnp.int32) if jax_side else pend)
    kw = dict(steps_left=CAPS, stop_tokens=stops)
    if not sampled:
        return cache.dispatch_window(params, tokens, W, active=ACTIVE, **kw)
    key_data, base = _sampling()
    if pend is None:
        base = base + W  # the second window's key schedule
    return cache.dispatch_window_sampled(
        params, tokens, W, ACTIVE, key_data, base, TEMPS, TOP_PS, SAMPLED,
        **kw)


def _stop_for_slot3(jcfg, jparams, sampled):
    """The token slot 3 produces at step 2 of the first window: a stop
    there hits mid-window."""
    jc = JaxCache(jcfg, slots=5, pages=40, page_size=4)
    pend = _fill(jc, jparams, True)
    block = np.asarray(jc.harvest_window(_dispatch(
        jc, jparams, pend, sampled, None, True)))
    return int(block[2, 3])


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_capped_windows_match_reference_blocks(models, sampled):
    jcfg, tcfg, jparams, tparams = models
    stops = np.full(5, -1, np.int64)
    stops[3] = _stop_for_slot3(jcfg, jparams, sampled)
    jc = JaxCache(jcfg, slots=5, pages=40, page_size=4)
    tc = PagedKVCache(tcfg, slots=5, pages=40, page_size=4, device="cpu")
    jpend = _fill(jc, jparams, True)
    tpend = _fill(tc, tparams, False)
    assert (jpend == tpend).all()
    blocks = []
    for pend in (tpend, None):  # an explicit window, then the carry
        want = np.asarray(jc.harvest_window(_dispatch(
            jc, jparams, pend, sampled, stops, True)))
        got = tc.harvest_window(_dispatch(tc, tparams, pend, sampled,
                                          stops, False))
        assert got.shape == (W + 2, 5)
        np.testing.assert_array_equal(got, want)
        assert tc._host_lengths == list(jc._host_lengths)
        for mine, ref in ((tc.state.pool_k, jc.state.pool_k),
                          (tc.state.pool_v, jc.state.pool_v)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
        blocks.append(got)
    # The first block's bookkeeping: slot 3's stop hit mid-window, the
    # capped rows froze (cap 0 included), the inactive slot reports 0.
    fin, stop_at = blocks[0][W], blocks[0][W + 1]
    assert 1 <= stop_at[3] <= 3 and fin[3] == 2
    assert fin[:3].tolist() == [1, 1, 1] and fin[4] == stop_at[4] == 0


def _port_cache(tcfg, tparams, slots=3, prompts=None):
    prompts = prompts or {0: [5, 9, 2], 2: [7, 7, 7, 7, 7]}
    cache = PagedKVCache(tcfg, slots=slots, pages=24, page_size=4,
                         device="cpu")
    pend = np.zeros((slots,), np.int64)
    for slot, prompt in prompts.items():
        cache.admit(slot, len(prompt))
        pend[slot] = int(torch.argmax(cache.prefill(tparams, slot, prompt)))
    return cache, pend


def test_capped_window_freezes_finished_rows(models):
    """Per-slot caps: a row past its cap re-emits its last token, stops
    advancing its length and writes no KV; the live prefix equals an
    uncapped window's."""
    _, tcfg, _, tparams = models
    n = 7
    cache_u, pend = _port_cache(tcfg, tparams)
    full = cache_u.step_window(tparams, pend, n).numpy()
    cache_c, pend = _port_cache(tcfg, tparams)
    caps = np.array([3, 0, 7])
    capped = cache_c.harvest_window(cache_c.dispatch_window(
        tparams, pend, n, steps_left=caps))
    cache_c.drop_carry()
    assert capped.shape[0] == n + 2
    assert capped[:3, 0].tolist() == full[:3, 0].tolist()
    assert capped[:n, 2].tolist() == full[:, 2].tolist()
    assert all(int(t) == int(capped[2, 0]) for t in capped[3:n, 0])
    assert capped[n].tolist() == [1, 0, 1]
    assert capped[n + 1].tolist() == [0, 0, 0]
    assert (cache_c._host_lengths[0]
            == cache_u._host_lengths[0] - (n - 3))
    assert cache_c._host_lengths[2] == cache_u._host_lengths[2]
    assert cache_c._host_lengths[1] == 0
    # The device lengths advanced by the caps too.
    assert torch.equal(cache_c.state.lengths,
                       torch.tensor(cache_c._host_lengths, dtype=torch.int32))


def test_pipeline_carry_matches_serial_window(models):
    """Two pipelined windows, the second on the device carry before the
    first is harvested, equal one serial window of the combined length."""
    _, tcfg, _, tparams = models
    prompts = {0: [3, 1, 4, 1, 5]}
    active = np.array([True, False])
    cache_s, pend = _port_cache(tcfg, tparams, 2, prompts)
    serial = cache_s.step_window(tparams, pend, 8, active=active).numpy()
    cache_p, pend = _port_cache(tcfg, tparams, 2, prompts)
    h1 = cache_p.dispatch_window(tparams, pend, 4, active=active)
    h2 = cache_p.dispatch_window(tparams, None, 4, active=active)
    got = np.concatenate([cache_p.harvest_window(h1)[:4],
                          cache_p.harvest_window(h2)[:4]])
    cache_p.drop_carry()
    assert got[:, 0].tolist() == serial[:, 0].tolist()
    assert cache_p._host_lengths == cache_s._host_lengths


def test_carry_requires_a_window_in_flight(models):
    _, tcfg, _, tparams = models
    cache = PagedKVCache(tcfg, slots=2, pages=16, page_size=4, device="cpu")
    with pytest.raises(PagedCacheError):
        cache.dispatch_window(tparams, None, 4)
    cache.drop_carry()  # idempotent on an empty pipeline


def _jax_reference(jparams, jcfg, prompt, n_new):
    out = jax_generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                       n_new=n_new)
    return [int(t) for t in np.asarray(out)[0]]


def test_mid_window_cancellation_under_overlap(models):
    """A cancel landing while a window is in flight frees the slot at the
    next boundary; the co-tenant that takes the freed capacity decodes
    unperturbed."""
    jcfg, tcfg, jparams, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=1, pages=8,
                                   overlap="on", device="cpu")
    try:
        src = server.submit_stream([1, 2, 3], n_new=60)
        next(src)  # pipelined windows are in flight now
        src.cancel()
        deadline = time.monotonic() + 30
        while server.stats()["active"] and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = server.stats()
        assert stats["active"] == 0 and stats["reserved_pages"] == 0
        got = server.submit([4, 5], n_new=3, timeout=5.0)
        assert got == _jax_reference(jparams, jcfg, [4, 5], 3)
        with pytest.raises(RequestCancelled):
            list(src)
    finally:
        server.close()


def test_overlap_off_reports_serial(models):
    _, tcfg, _, tparams = models
    for overlap, on in (("off", 0), ("on", 1), ("auto", 1)):
        server = PagedGenerationServer(tparams, tcfg, slots=2, pages=16,
                                       overlap=overlap, device="cpu")
        try:
            server.submit([5, 9, 2], n_new=20)
            stats = server.stats()
            assert stats["overlap"] == on
            assert (stats["overlap_windows"] > 0) == bool(on)
            assert (stats["overlap_depth1_windows"] > 0) == bool(on)
        finally:
            server.close()


def test_overlap_knob_validates(models):
    _, tcfg, _, _ = models
    with pytest.raises(ValueError):
        PagedGenerationServer({}, tcfg, overlap="sometimes", device="cpu")


# (prompt, n_new, sampling (seed, row, temperature, top_p) or None,
#  stop: the index into the unstopped generation whose token stops it)
BURST = [
    ([5, 9, 2, 77, 3, 1, 8, 40, 41, 6, 7], 19, None, None),
    ([100, 3], 14, None, 5),
    ([1, 2, 3, 4, 5, 6], 22, (11, 0, 0.8, 0.9), None),
    ([9, 9, 9, 9, 9, 9, 9, 9, 9], 17, (11, 1, 1.3, 0.8), 7),
    ([42] * 15, 9, (3, 0, 0.5, 0.7), None),
    ([17, 4], 25, None, None),
]


def _burst(submit):
    out = [None] * len(BURST)

    def one(i):
        out[i] = submit(i)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(BURST))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_server_tokens_do_not_depend_on_the_overlap(models):
    jcfg, tcfg, jparams, tparams = models

    def sampling_of(s, jax_side):
        if s is None:
            return None
        seed, row, t, p = s
        if jax_side:
            return (jax.random.fold_in(jax.random.PRNGKey(seed), row),
                    jnp.float32(t), jnp.float32(p))
        return (row_key_data(seed, row), t, p)

    # The stop tokens come from each request's unstopped generation.
    solo = PagedGenerationServer(tparams, tcfg, slots=2, pages=48,
                                 page_size=4, overlap="off", device="cpu")
    try:
        stops, lengths = [], []
        for prompt, n_new, s, at in BURST:
            gen = solo.submit(prompt, n_new,
                              sampling=sampling_of(s, False))[len(prompt):]
            stops.append(None if at is None else gen[at])
            # A stop ends the row at its first occurrence, stop included.
            lengths.append(len(prompt) + (
                n_new if at is None else gen.index(gen[at]) + 1))
    finally:
        solo.close()

    jserver = JaxServer(jparams, jcfg, slots=3, pages=48, page_size=4,
                        prefill_chunk=4, prefix_cache=False, overlap="off",
                        window=4)
    try:
        want = _burst(lambda i: jserver.submit(
            BURST[i][0], BURST[i][1], sampling=sampling_of(BURST[i][2], True),
            stop_token=stops[i]))
    finally:
        jserver.close()
    got = {}
    for overlap in ("on", "off"):
        server = PagedGenerationServer(tparams, tcfg, slots=3, pages=48,
                                       page_size=4, prefill_chunk=4,
                                       window=4, overlap=overlap,
                                       prefix_cache=False, device="cpu")
        try:
            got[overlap] = _burst(lambda i: server.submit(
                BURST[i][0], BURST[i][1],
                sampling=sampling_of(BURST[i][2], False),
                stop_token=stops[i]))
            stats = server.stats()
            assert stats["stop_finishes"] == sum(
                at is not None for *_, at in BURST)
            acct = stats["page_accounting"]
            assert acct["free"] == acct["pages_total"]
        finally:
            server.close()
    assert got["on"] == got["off"] == want
    assert [len(row) for row in want] == lengths


# ---- on the card: a replayed graph equals the eager window ----------------


class EagerCache(PagedKVCache):
    """The same cache with its device seam running the window eagerly:
    the yardstick the graph replays are held to."""

    def _run_device_window(self, params, n_steps, sampled):
        return run_window(params, self.state, self.cfg, self._in, n_steps,
                          sampled)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode windows replay captured CUDA "
                    "graphs there, and B1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graph_window_equals_eager_window(cuda_device, dtype):
    # d_head 64: the width B1 is built for.
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=128, dtype=dtype)
    params = params_from_numpy(ttr.init_params(4, cfg), cfg, cuda_device)
    caches = []
    for cls in (PagedKVCache, EagerCache):
        cache = cls(cfg, slots=5, pages=40, page_size=16, device=cuda_device)
        pend = _fill(cache, params, False)
        caches.append((cache, pend))
    key_data, base = _sampling()
    before = tpa.paged_decode_attention.launches
    for sampled in (False, True):
        for n in (1, 4, 8):
            blocks, stops = [], np.full(5, -1, np.int64)
            stops[3] = 7
            for cache, pend in caches:
                caps = np.minimum(CAPS, n)
                if sampled:
                    h = cache.dispatch_window_sampled(
                        params, pend, n, ACTIVE, key_data, base, TEMPS,
                        TOP_PS, SAMPLED, steps_left=caps, stop_tokens=stops)
                else:
                    h = cache.dispatch_window(params, pend, n,
                                              active=ACTIVE, steps_left=caps,
                                              stop_tokens=stops)
                blocks.append(cache.harvest_window(h))
            graph, eager = (c for c, _ in caches)
            np.testing.assert_array_equal(blocks[0], blocks[1])
            assert graph._host_lengths == eager._host_lengths
            assert torch.equal(graph.state.lengths, eager.state.lengths)
            assert torch.equal(graph.state.pool_k, eager.state.pool_k)
            assert torch.equal(graph.state.pool_v, eager.state.pool_v)
            caches = [(cache, block[n - 1].astype(np.int64))
                      for (cache, _), block in zip(caches, blocks)]
    stats = caches[0][0].graph_stats()
    assert stats["graphs"] == 6
    assert stats["b1_launches_per_replay"]["greedy/8"] == cfg.n_layers * 8
    assert tpa.paged_decode_attention.launches > before
