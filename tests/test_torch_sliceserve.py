"""The slice cache (``kvedge_torch/runtime/sliceserve.py``) in one process.

The cases of ``tests/test_sliceserve.py`` on the port: with no world the
control plane's broadcast is a copy, so the leader path (every device
seam broadcasting its op before running it, the coalesced OP_MULTI
frames, the deadline runner) runs in process against the plain cache and
server, and a recorded op stream replays through the real follower loop
on a second cache. Tokens are held at fp32 to the JAX package's
``generate`` on the same numpy weights (through the weight bridge) and
to the port's plain server. Worlds of 2 and 4 gloo ranks are
``tests/test_torch_slice_world.py``.
"""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import generate as jax_generate
from kvedge_tpu.models import transformer as jtr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import (
    PagedCacheError,
    PagedKVCache,
    _use_paged_kernel,
)
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.transformer import init_params
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.parallel.mesh import Mesh
from kvedge_torch.runtime.failures import OpBudgets, SliceFollowerLost
from kvedge_torch.runtime.serve import row_key_data
from kvedge_torch.runtime.sliceserve import (
    _OP_NAMES,
    OP_MULTI,
    SlicePagedKVCache,
    follow_paged,
)

torch.set_num_threads(2)

CFG = TransformerConfig(vocab=128, d_model=32, n_heads=4, n_kv_heads=2,
                        n_layers=2, d_ff=64, max_seq=64, dtype="float32")
JCFG = jtr.TransformerConfig(vocab=128, d_model=32, n_heads=4, n_kv_heads=2,
                             n_layers=2, d_ff=64, max_seq=64,
                             dtype="float32", remat=False,
                             paged_attention="gather")


def slice_tree(seed: int = 0) -> dict:
    """The numpy init, its embedding and projections scaled up so a tiny
    model's greedy tokens vary (the plain init repeats one token)."""
    tree = init_params(seed, CFG)
    tree["embedding"] = tree["embedding"] * np.float32(10)
    for key in ("w_qkv", "w_out", "w_up", "w_down"):
        tree[key] = tree[key] * np.float32(4)
    return tree


@pytest.fixture(scope="module")
def tree():
    return slice_tree()


@pytest.fixture(scope="module")
def params(tree):
    return params_from_numpy(tree, CFG, "cpu")


@pytest.fixture(scope="module")
def reference(tree):
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    memo = {}

    def want(prompt, n_new):
        key = (tuple(prompt), n_new)
        if key not in memo:
            out = jax_generate(jparams, jnp.asarray([prompt], jnp.int32),
                               JCFG, n_new=n_new)
            memo[key] = [int(t) for t in np.asarray(out)[0]]
        return memo[key]

    return want


def _slice(**kw) -> SlicePagedKVCache:
    kw.setdefault("page_size", 16)
    kw.setdefault("slots", 3)
    kw.setdefault("pages", 24)
    spec = kw.pop("speculative", 0)
    kw.setdefault("max_pages_per_seq",
                  -(-(CFG.max_seq + spec) // kw["page_size"]))
    return SlicePagedKVCache(CFG, device="cpu", **kw)


def _slice_server(params, *, cache_kw=None, **kw):
    cache_kw = dict(cache_kw or {})
    cache_kw.setdefault("speculative", kw.get("speculative", 0))
    return PagedGenerationServer(params, CFG, cache=_slice(**cache_kw), **kw)


def _plain_server(params, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("pages", 24)
    return PagedGenerationServer(params, CFG, device="cpu", **kw)


def _sampling(seed, row=0, t=0.8, p=0.9):
    return (row_key_data(seed, row), t, p)


def _record(cache):
    """Record every broadcast the cache's control plane returns."""
    log = []
    orig = cache._bcast

    def recording(tree):
        out = orig(tree)
        log.append(out)
        return out

    cache._bcast = recording
    return log


def _replay(log, params, **kw) -> SlicePagedKVCache:
    """A second cache replaying ``log`` through the follower loop."""
    follower = _slice(**kw)
    it = iter(log)
    follower._bcast = lambda tree: next(it)
    follow_paged(follower, params)
    assert next(it, None) is None  # the whole stream was consumed
    return follower


def _kinds(log, cache) -> set:
    """The op kinds a recorded stream carried, the ops inside OP_MULTI
    frames included (carved by the cache's shape table)."""
    kinds = set()
    items = iter(log)
    for item in items:
        if not (isinstance(item, np.ndarray) and item.shape == (4,)
                and item.dtype == np.int64 and 0 <= item[0] < 15):
            continue
        kinds.add(_OP_NAMES[int(item[0])])
        if int(item[0]) != OP_MULTI:
            continue
        frame, off = next(items), 0
        for _ in range(int(item[1])):
            sub = [int(v) for v in np.frombuffer(frame.data, np.int64,
                                                 count=4, offset=off)]
            kinds.add(_OP_NAMES[sub[0]])
            off += 32 + sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                            for shape, dtype in cache._multi_templates(*sub))
    return kinds


def test_slice_cache_matches_plain_cache_step_and_window(params):
    """Chunked prefill, single steps and a window: the slice cache's
    tokens are the plain cache's."""
    prompt = [3, 1, 4, 1, 5, 9, 2]
    seqs = []
    for cache in (PagedKVCache(CFG, slots=2, pages=16, page_size=4,
                               device="cpu"),
                  _slice(slots=2, pages=16, page_size=4)):
        cache.admit(0, len(prompt))
        for off in range(0, len(prompt), 3):
            logits = cache.prefill_chunk(params, 0, prompt[off:off + 3], off)
        tok = int(torch.argmax(logits))
        toks = [tok]
        active = np.array([True, False])
        for _ in range(3):
            tok = int(torch.argmax(cache.step(params, [tok, 0],
                                              active=active)[0]))
            toks.append(tok)
        window = cache.step_window(params, [tok, 0], 4, active=active)
        toks.extend(int(t) for t in window[:, 0])
        seqs.append(toks)
    assert seqs[0] == seqs[1]


def test_slice_server_greedy_matches_generate(params, reference):
    server = _slice_server(params)
    try:
        prompt = [5, 9, 2, 7, 1]
        assert server.submit(prompt, n_new=6) == reference(prompt, 6)
    finally:
        server.close()


def test_slice_server_concurrent_requests_each_match(params, reference):
    """Concurrent ragged requests ride one batched pool through the
    broadcast seams and each equals its own decode."""
    server = _slice_server(params, window=4)
    requests = [([5, 9, 2], 8), ([1, 1, 4, 3, 7, 7], 4), ([100, 50], 12)]
    results, errors = {}, []

    def worker(i, prompt, n_new):
        try:
            results[i] = server.submit(prompt, n_new)
        except Exception as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i, p, n))
                   for i, (p, n) in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        for i, (prompt, n_new) in enumerate(requests):
            assert results[i] == reference(prompt, n_new), i
    finally:
        server.close()


def test_slice_server_sampled_and_streamed_match_plain_server(params):
    """Sampling is leader-local: a sampled and a streamed request through
    the slice server equal the plain server's."""
    prompt = [9, 8, 7, 6]
    plain = _plain_server(params, slots=2, pages=16)
    try:
        want_sampled = plain.submit(prompt, 5, sampling=_sampling(7))
        want_streamed = list(plain.submit_stream(prompt, 5))
    finally:
        plain.close()
    server = _slice_server(params, cache_kw=dict(slots=2, pages=16))
    try:
        assert server.submit(prompt, 5, sampling=_sampling(7)) == \
            want_sampled
        assert list(server.submit_stream(prompt, 5)) == want_streamed
    finally:
        server.close()


def test_sharded_pool_holds_the_rank_heads_and_refuses_uneven_axis():
    """Under a ``model`` axis of 2 the pools hold this rank's K/2 K/V heads
    (the int8 scales too); an axis the heads do not divide is refused,
    where the reference replicates the pool."""
    two = Mesh(("data", "model"), (1, 2), (0, 1))
    cache = PagedKVCache(CFG, slots=2, pages=8, page_size=4, kv_dtype="int8",
                         device="cpu", mesh=two)
    assert cache.state.pool_k.shape == (2, 8, 4, CFG.kv_heads // 2,
                                        CFG.d_head)
    assert cache.state.scale_v.shape == (2, 8, 4, CFG.kv_heads // 2)
    three = Mesh(("model",), (3,), (0,))
    with pytest.raises(ValueError, match="must divide by the 'model' axis"):
        _slice(slots=2, pages=8, page_size=4, mesh=three)


def test_hard_close_mid_request_and_double_close_do_not_hang(params):
    """STOP rides the server's close under its lock: a hard close racing
    a request must not let the request's teardown broadcast after STOP,
    and a second close sends no second STOP."""
    server = _slice_server(params, cache_kw=dict(slots=2, pages=16),
                           window=1)
    errors = []

    def worker():
        try:
            server.submit([1, 2, 3], n_new=40)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    while server.stats()["in_flight"] == 0 and t.is_alive():
        time.sleep(0.001)
    server.close()
    server.close()
    t.join(timeout=60)
    assert not t.is_alive()
    assert server._cache._stopped


def test_slice_server_speculative_matches_reference(params, reference):
    """Verify passes broadcast as OP_SPEC; tokens equal the decode and
    drafts are accepted."""
    server = _slice_server(params, speculative=4, overlap="off",
                           cache_kw=dict(slots=2, pages=40, page_size=4))
    try:
        prompt = [5, 9, 2, 5, 9, 2, 5, 9]
        assert server.submit(prompt, n_new=12) == reference(prompt, 12)
        stats = server.stats()
        assert stats["spec_passes"] > 0
        assert stats["spec_emitted_per_pass"] > 1.0
    finally:
        server.close()


def test_slice_server_spec_window_matches_reference(params, reference):
    """Spec windows broadcast as OP_SPECW (first with the drafting
    context, then on every rank's carry); tokens equal the decode."""
    server = _slice_server(params, speculative=3, spec_window=4,
                           overlap="on",
                           cache_kw=dict(slots=2, pages=40, page_size=4))
    try:
        prompt = [5, 9, 2, 5, 9, 2, 5, 9]
        assert server.submit(prompt, n_new=12) == reference(prompt, 12)
        stats = server.stats()
        assert stats["spec_windows_total"] >= 1
        assert stats["spec_window_emitted_tokens"]["count"] >= 1
    finally:
        server.close()


def test_slice_server_prefix_sharing_stays_exact(params, reference):
    """The prefix registry (leader host state) composes with the slice: a
    repeated prompt reuses pinned pages (a COW of its partial page rides
    the op stream) and decodes the same tokens."""
    server = _slice_server(params, cache_kw=dict(page_size=4))
    try:
        prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19]
        first = server.submit(prompt, n_new=4)
        again = server.submit(prompt, n_new=4)
        assert first == again == reference(prompt, 4)
        assert server.stats()["prefix_hits"] >= 1
    finally:
        server.close()


def test_slice_cache_refuses_prefix_persistence():
    """A leader-only device read would be a collective the followers never
    join: the refusal lives with the API."""
    cache = _slice(slots=2, pages=16, page_size=4)
    for call in (lambda: cache.read_pages([0]),
                 lambda: cache.snapshot_pages([0]),
                 lambda: cache.write_pages([0], None, None)):
        with pytest.raises(PagedCacheError, match="not supported"):
            call()


def test_slice_cache_keeps_paged_kernel_resolution():
    """Where the reference pins its slice to the gather path (a Pallas
    kernel has no partitioning rule), the port's slice keeps
    ``_use_paged_kernel``'s resolution: B1 runs per rank on its local
    heads on the card; the CPU takes the plain version."""
    for mode in ("auto", "kernel", "gather"):
        cfg = dataclasses.replace(CFG, paged_attention=mode)
        cache = SlicePagedKVCache(cfg, slots=2, pages=8, page_size=4,
                                  device="cpu")
        assert cache.cfg.paged_attention == mode
        assert _use_paged_kernel(cache.cfg, cache.device) == (mode ==
                                                              "kernel")
        assert _use_paged_kernel(cache.cfg, torch.device("cuda")) == (
            mode != "gather")


def test_slice_stop_after_dead_stream_is_bounded():
    """stop() sends nothing into a dead stream: once the watchdog latched
    a timeout, close() returns at once."""
    cache = _slice(slots=2, pages=16, page_size=4,
                   op_budgets=OpBudgets(steady_s=0.5, compile_s=0.5))
    release = threading.Event()
    orig = cache._bcast

    def wedged(tree):
        release.wait(30)
        raise RuntimeError("wedged bcast released")

    cache._bcast = wedged
    cache.admit(0, 4)  # queues the table sync
    try:
        with pytest.raises(SliceFollowerLost):
            cache._flush_ops()
        assert cache._ops.dead is not None
        cache._bcast = orig
        start = time.monotonic()
        cache.stop()
        assert time.monotonic() - start < 5.0
    finally:
        release.set()


def test_slice_pipelined_windows_replay_matches_plain(params):
    """Two pipelined windows, the second on the device carry before the
    first is harvested: the slice cache's tokens are the plain cache's."""
    prompt = [3, 1, 4, 1, 5, 9, 2]
    seqs = []
    for cache in (PagedKVCache(CFG, slots=2, pages=16, page_size=4,
                               device="cpu"),
                  _slice(slots=2, pages=16, page_size=4)):
        cache.admit(0, len(prompt))
        logits = cache.prefill(params, 0, prompt)
        pend = np.zeros((2,), np.int64)
        pend[0] = int(torch.argmax(logits))
        active = np.array([True, False])
        h1 = cache.dispatch_window(params, pend, 4, active=active)
        h2 = cache.dispatch_window(params, None, 4, active=active)
        toks = np.concatenate([cache.harvest_window(h1)[:4],
                               cache.harvest_window(h2)[:4]])
        cache.drop_carry()
        assert cache._carry is None
        seqs.append(toks[:, 0].tolist())
    assert seqs[0] == seqs[1]


def test_slice_overlap_server_greedy_and_sampled_match_plain(params,
                                                             reference):
    """The pipelined loop over the slice (OP_WINDOWP / OP_WSAMPLEP in
    steady state) serves the plain pipelined server's tokens."""
    prompt_g, prompt_s = [5, 9, 2, 7, 1], [1, 2, 3, 4]
    results = []
    for server in (_plain_server(params, overlap="on", window=4),
                   _slice_server(params, overlap="on", window=4)):
        try:
            results.append((server.submit(prompt_g, n_new=12),
                            server.submit(prompt_s, n_new=18,
                                          sampling=_sampling(3))))
        finally:
            server.close()
    assert results[0] == results[1]
    assert results[0][0] == reference(prompt_g, 12)


def test_slice_multi_frame_follower_replay_matches_leader(params):
    """A page boundary queues the table sync, and the window dispatch a
    moment later flushes both as ONE OP_MULTI frame. The leader's
    recorded stream, replayed through the real follower loop on a second
    cache, reproduces the leader's carry and pools bit for bit. The
    stream drives every op kind the port's leader sends: syncs, a
    prefill, a step, a verify pass, greedy and sampled windows and spec
    windows, a swap-out and a swap-in, and a COW page copy."""
    leader = _slice(slots=2, pages=16, page_size=4)
    log = _record(leader)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    leader.admit(0, len(prompt))
    logits = leader.prefill(params, 0, prompt)
    pend = np.zeros((2,), np.int64)
    pend[0] = int(torch.argmax(logits))
    active = np.array([True, False])
    step = leader.step(params, pend, active=active)
    pend[0] = int(torch.argmax(step[0]))
    h1 = leader.dispatch_window(params, pend, 4, active=active)
    h2 = leader.dispatch_window(params, None, 4, active=active)
    want = leader.harvest_window(h2)
    leader.harvest_window(h1)
    pend[0] = int(want[3, 0])
    leader.drop_carry()
    samp = (np.stack([row_key_data(5, 0), row_key_data(5, 1)]),
            np.array([9, 0]), np.array([0.8, 1.0], np.float32),
            np.array([0.9, 1.0], np.float32), np.array([True, False]))
    hs = leader.dispatch_window_sampled(params, pend, 3, active, *samp)
    pend[0] = int(leader.harvest_window(hs)[2, 0])
    leader.drop_carry()
    drafts = np.zeros((2, 3), np.int64)
    drafts[0] = [pend[0], 1, 5]
    leader.step_spec(params, drafts, active, np.array([True, False]))
    ctx = np.zeros((2, 24), np.int64)
    n = leader.slot_length(0)
    ctx[0, :3] = prompt[:3]
    budgets = np.array([4, 0])
    hw = leader.dispatch_spec_window(params, pend, 2, 2, budgets,
                                     active=active, ctx=ctx,
                                     ctx_len=np.array([3, 0]))
    leader.harvest_spec_window(hw)
    hw = leader.dispatch_spec_window(params, None, 2, 2, budgets,
                                     active=active, sampling=samp)
    leader.harvest_spec_window(hw)
    leader.drop_carry()
    # A COW (slot 1 admitted on slot 0's pages) and a swap round trip.
    shared = tuple(leader.slot_pages(0)[:2])
    leader.admit(1, 6, shared)
    leader.cow_page(1, 1)
    snap = leader.swapout_pages(leader.slot_pages(1))
    leader.swapin_pages(leader.slot_pages(1), snap)
    leader.release(1)
    assert n > 0
    leader._flush_ops()
    carry = leader._carry
    leader.stop()
    kinds = _kinds(log, leader)
    assert kinds >= {"sync", "prefill", "step", "windowp", "wsamplep",
                     "spec", "specw", "specws", "swapout", "swapin", "cowp",
                     "multi", "stop"}, kinds
    assert leader.coalesced_flushes >= 1
    assert leader.coalesced_ops >= 2 * leader.coalesced_flushes
    assert any(isinstance(t, np.ndarray) and t.shape == (4,)
               and int(t[0]) == OP_MULTI for t in log)

    follower = _replay(log, params, slots=2, pages=16, page_size=4)
    assert carry is None and follower._carry is not None
    for name in ("pool_k_full", "pool_v_full"):
        assert torch.equal(getattr(follower.state, name),
                           getattr(leader.state, name)), name
    assert torch.equal(follower._tables_full, leader._tables_full)
    assert torch.equal(follower._lengths_full, leader._lengths_full)
    assert torch.equal(follower._spec_in.ctx, leader._spec_in.ctx)
    toks, _ = follower._carry
    assert toks.shape[1] == 2


def test_slice_server_sampled_spec_window_matches_plain(params, reference):
    """OP_SPECWS: a mixed greedy and sampled batch stays on the windowed
    spec path, and both streams equal the plain server's."""
    prompt_g, prompt_s = [5, 9, 2, 5, 9, 2, 5, 9], [1, 2, 3, 4]
    results = []
    kw = dict(speculative=3, spec_window=4, overlap="on")
    for server in (_plain_server(params, slots=2, pages=40, page_size=4,
                                 **kw),
                   _slice_server(params, cache_kw=dict(
                       slots=2, pages=40, page_size=4), **kw)):
        try:
            results.append((server.submit(prompt_g, n_new=12),
                            server.submit(prompt_s, n_new=10,
                                          sampling=_sampling(11))))
            assert server.stats()["spec_windows_total"] >= 1
        finally:
            server.close()
    assert results[0] == results[1]
    assert results[0][0] == reference(prompt_g, 12)
