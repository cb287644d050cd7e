"""The port's bucketed device batch and HBM-budgeted pool against the JAX
reference's.

The cases mirror the reference's capacity tests (``tests/test_capacity.py``)
at its small shapes (vocab 128, d_model 32, 4 heads, 2 kv heads, 2 layers,
max_seq 64, page 4), at fp32 on both sides: the ladder and its errors,
bucketing off pinned to slots, steps up and down, bucketed == pinned
tokens with the overlap on and off and with spec windows, preempt/resume
across a step, each against the JAX server on the same traffic; then the
pool's dimensions against the JAX package's functions over a grid of
budgets, dtypes and ``kv_dtype``, and the new knobs against its parser.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.config.runtime_config import RuntimeConfigError as JaxError
from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.kvcache import PagedCacheError as JaxCacheError
from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.runtime import workload as jwork
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedCacheError, PagedKVCache
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import serve as tserve
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _caches(slots, pages, min_bucket):
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    return (JaxCache(jcfg, slots=slots, pages=pages, page_size=4,
                     min_bucket=min_bucket),
            PagedKVCache(TransformerConfig(**KW), slots=slots, pages=pages,
                         page_size=4, min_bucket=min_bucket, device="cpu"))


def _server(models, jax_side, **kw):
    jcfg, tcfg, jparams, tparams = models
    if jax_side:
        return JaxServer(jparams, jcfg, **kw)
    return PagedGenerationServer(tparams, tcfg, device="cpu", **kw)


def _run_concurrent(server, requests, **submit_kw):
    """``requests`` = [(prompt, n_new)], one thread each; {i: tokens}."""
    out, errors = {}, []

    def worker(i, prompt, n_new):
        try:
            out[i] = server.submit(prompt, n_new, timeout=300, **submit_kw)
        except Exception as e:  # collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, p, n))
               for i, (p, n) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return out


# ---- the ladder ----------------------------------------------------------


def test_bucket_ladder_and_validation_match_the_reference():
    jc, tc = _caches(6, 24, 2)
    for cache, err in ((jc, JaxCacheError), (tc, PagedCacheError)):
        assert cache.bucket == 2 and cache.min_bucket == 2
        assert [cache.bucket_for(n) for n in range(7)] == \
            [2, 2, 2, 4, 4, 6, 6]
        cache.set_bucket(4)
        assert cache.bucket == 4
        for bad in (3, 8):
            with pytest.raises(err, match="ladder"):
                cache.set_bucket(bad)
        with pytest.raises(err, match="outside the current"):
            cache.admit(5, 4)
        cache.admit(3, 4)
        with pytest.raises(err, match="admitted"):
            cache.set_bucket(2)
        cache.release(3)
        cache.set_bucket(2)
        assert cache.bucket == 2
        assert cache.occupancy()["bucket"] == 2
    with pytest.raises(ValueError, match="min_bucket"):
        PagedKVCache(TransformerConfig(**KW), slots=2, pages=8,
                     min_bucket=-1, device="cpu")
    # min_bucket above slots clamps to slots, as the reference's.
    big = PagedKVCache(TransformerConfig(**KW), slots=3, pages=8,
                       min_bucket=8, device="cpu")
    assert big.min_bucket == 3 and big.bucket == 3


def test_bucketing_disabled_pins_to_slots():
    jc, tc = _caches(4, 16, 0)
    for cache, err in ((jc, JaxCacheError), (tc, PagedCacheError)):
        assert cache.min_bucket == 0 and cache.bucket == 4
        assert cache.bucket_for(1) == 4
        with pytest.raises(err, match="disabled"):
            cache.set_bucket(2)
    assert tc.occupancy()["bucket"] == 4


def test_device_rows_are_views_of_the_full_tensors():
    """The state's tables and lengths are the bucket's rows of
    ``[slots]`` tensors: a resize changes the views, not the storage, and
    the host books stay slots-sized; the JAX cache's arrays have the same
    bucket-sized shapes."""
    jc, tc = _caches(8, 32, 2)
    ptr = tc.state.tables.data_ptr()
    for b in (2, 4, 8, 2):
        jc.set_bucket(b)
        tc.set_bucket(b)
        assert tuple(tc.state.tables.shape) == tuple(jc.state.tables.shape)
        assert tuple(tc.state.lengths.shape) == (b,)
        assert tc.state.tables.data_ptr() == ptr
        assert len(tc._host_lengths) == 8
        assert tc.state.pool_k.shape[1] == 32
    tc.admit(1, 5)
    jc.admit(1, 5)
    np.testing.assert_array_equal(tc.state.tables.numpy(),
                                  np.asarray(jc.state.tables))
    np.testing.assert_array_equal(tc.state.lengths.numpy(),
                                  np.asarray(jc.state.lengths))


def test_spec_pending_blocks_resize(models):
    """An unharvested spec window pins the bucket, in both caches."""
    _, _, jparams, tparams = models
    jc, tc = _caches(4, 24, 2)
    prompt = [5, 9, 2]
    for cache, params, err in ((jc, jparams, JaxCacheError),
                               (tc, tparams, PagedCacheError)):
        cache.admit(0, len(prompt))
        logits = cache.prefill(params, 0, np.asarray(prompt, np.int32))
        pend = np.zeros((2,) if cache is jc else (4,), np.int32)
        pend[0] = int(np.argmax(np.asarray(logits)))
        s_ctx = KW["max_seq"] + 8
        ctx = np.zeros((len(pend), s_ctx), np.int32)
        seq = prompt + [int(pend[0])]
        ctx[0, :len(seq)] = seq
        ctx_len = np.zeros((len(pend),), np.int32)
        ctx_len[0] = len(seq)
        budgets = np.zeros((len(pend),), np.int32)
        budgets[0] = 10
        handle = cache.dispatch_spec_window(params, pend, 2, 3, budgets,
                                            ctx=ctx, ctx_len=ctx_len)
        assert cache.spec_pending()
        with pytest.raises(err, match="spec"):
            cache.set_bucket(4)
        cache.harvest_spec_window(handle)
        assert not cache.spec_pending()
        cache.set_bucket(4)
        assert cache.bucket == 4


def test_bucketed_prefill_and_windows_equal_pinned_rows():
    """The same operations through a cache at bucket 2 and one pinned to
    4 slots: the prefill logits, the window's rows and the pools are the
    same bit for bit (the outputs carry the bucket's rows)."""
    cfg = TransformerConfig(**KW)
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in
         jtr.init_params(jax.random.PRNGKey(3), jcfg).items()}, cfg, "cpu")
    outs = []
    for min_bucket in (0, 2):
        cache = PagedKVCache(cfg, slots=4, pages=24, page_size=4,
                             min_bucket=min_bucket, device="cpu")
        assert cache.bucket == (4 if not min_bucket else 2)
        pend = np.zeros((4,), np.int64)
        logits = []
        for slot, prompt in enumerate(([5, 9, 2, 7, 1], [3, 3])):
            cache.admit(slot, len(prompt))
            logits.append(cache.prefill(params, slot, prompt))
            pend[slot] = int(torch.argmax(logits[-1]))
        active = np.array([True, True, False, False])
        block = cache.harvest_window(cache.dispatch_window(
            params, pend, 4, active=active,
            steps_left=np.array([4, 2, 0, 0])))
        outs.append((logits, block[:, :2], cache.state.pool_k.clone(),
                     cache._host_lengths[:]))
        assert block.shape[1] == cache.bucket
    (l0, b0, p0, h0), (l1, b1, p1, h1) = outs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    np.testing.assert_array_equal(b0, b1)
    assert torch.equal(p0, p1) and h0 == h1


# ---- the server: steps and bit-identity ----------------------------------


def test_bucket_steps_down_when_load_drains(models):
    requests = [([5, 9, 2], 6), ([1, 4], 6), ([7], 6), ([9, 9, 9], 6)]
    got = []
    for jax_side in (True, False):
        server = _server(models, jax_side, slots=4, pages=32, page_size=4,
                         window=2, min_bucket=1, prefix_cache=False)
        try:
            burst = _run_concurrent(server, requests)
            solo = server.submit([3, 1, 4], n_new=8)
            deadline = time.monotonic() + 30
            while server._cache.bucket > 1:
                if time.monotonic() > deadline:
                    raise AssertionError("bucket never stepped down")
                time.sleep(0.01)
            got.append((burst, solo))
        finally:
            server.close()
    assert got[1] == got[0]


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_bucketed_tokens_match_pinned_and_reference(models, overlap):
    """The same requests through a bucketed port server (stepping 1 -> 2
    -> 4 under load), a pinned one and a bucketed JAX server: identical
    tokens; the port counts its bucket steps."""
    requests = [([5, 9, 2], 8), ([1, 1, 4, 3, 7, 7], 4), ([100, 50], 12),
                ([42], 9)]
    outs = {}
    for jax_side, min_bucket in ((False, 0), (False, 1), (True, 1)):
        server = _server(models, jax_side, slots=4, pages=32, page_size=4,
                         min_bucket=min_bucket, overlap=overlap,
                         prefix_cache=False)
        try:
            outs[(jax_side, min_bucket)] = _run_concurrent(server, requests)
            if not jax_side:
                st = server.stats()
                assert st["bucket_min"] == min_bucket
                if min_bucket:
                    assert st["bucket_steps_up"] >= 1
                else:
                    assert st["bucket_steps_up"] == 0
                    assert st["bucket"] == 4
        finally:
            server.close()
    assert outs[(False, 1)] == outs[(False, 0)] == outs[(True, 1)]


def test_bucketed_spec_window_overlap_matches_reference(models):
    """Spec windows + the overlap pipeline + bucket steps (a spec window
    in flight blocks the resize until its harvest): the port's tokens
    equal the JAX server's and the pinned port server's."""
    requests = [([5, 9, 2], 10), ([1, 1, 4, 3], 8), ([100, 50], 12)]
    outs = {}
    for jax_side, min_bucket in ((True, 1), (False, 1), (False, 0)):
        server = _server(models, jax_side, slots=4, pages=32, page_size=4,
                         min_bucket=min_bucket, overlap="on", speculative=2,
                         spec_window=2, prefix_cache=False)
        try:
            first = server.submit(requests[0][0], requests[0][1])
            outs[(jax_side, min_bucket)] = (
                first, _run_concurrent(server, requests))
            if not jax_side:
                assert server.stats()["spec_windows_total"] > 0
        finally:
            server.close()
    assert outs[(False, 1)] == outs[(True, 1)] == outs[(False, 0)]


def test_preempt_resume_across_bucket_steps(models):
    """A batch victim swapped out at bucket 2 resumes after the bucket
    stepped (resume steps it back up first): the tokens equal the JAX
    server's on the same traffic and an uncontended run's."""
    victim_prompt = [9, 8, 7]
    got = []
    for jax_side in (True, False):
        server = _server(models, jax_side, slots=2, pages=24, page_size=4,
                         window=4, min_bucket=1, sched_policy="strict",
                         sched_swap_budget_mb=64, prefix_cache=False)
        try:
            victims = [server.submit_stream(victim_prompt, n_new=40,
                                            priority="batch")
                       for _ in range(2)]
            firsts = [next(v) for v in victims]
            got_i = server.submit([40, 41, 42], n_new=6,
                                  priority="interactive")
            got_v = [victim_prompt + [f] + list(v)
                     for f, v in zip(firsts, victims)]
            st = server.stats()
            assert st["sched_preemptions_total"] >= 1
            assert st["sched_swap_bytes_host"] == 0
            got.append((got_i, got_v))
        finally:
            server.close()
    assert got[1] == got[0]
    _, tcfg, _, tparams = models
    from kvedge_torch.models.decode import generate
    want = generate(tparams, [victim_prompt], tcfg, 40,
                    device="cpu")[0].tolist()
    assert got[1][1] == [want, want]


def test_admission_steps_the_bucket_and_reports_it(models):
    """An admission onto a free slot above the bucket steps it up
    (directly when nothing is in flight); the refusal text names the
    bucket, as the reference's does."""
    server = _server(models, False, slots=4, pages=32, page_size=4,
                     min_bucket=1, prefix_cache=False, overlap="off")
    try:
        stream = server.submit_stream([1, 2, 3], n_new=30)
        next(stream)
        assert server._cache.bucket == 1
        server.submit([4, 5], n_new=3)
        assert server.stats()["bucket_steps_up"] >= 1
        with server._work:
            assert "bucket" in server._capacity_text_locked()
        list(stream)
    finally:
        server.close()


# ---- the HBM-budgeted pool -----------------------------------------------


def _pair(payload: dict, dtype: str):
    """The port's and the JAX package's config and model for one
    ``[payload]`` table (the port model at ``dtype``; the JAX model
    likewise, as its serve payload builds it)."""
    lines = "".join(f"{k} = {v!r}\n".replace("'", '"')
                    for k, v in payload.items())
    doc = "[payload]\nserving = \"paged\"\nseq = 64\n" + lines
    ours, theirs = ServeConfig.parse(doc), JaxConfig.parse(doc)
    tcfg = TransformerConfig(**dict(KW, dtype=dtype))
    jcfg = jtr.TransformerConfig(**dict(KW, dtype=dtype))
    return ours, theirs, tcfg, jcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("budget", [0, 1, 2, 5])
def test_pool_dims_equal_the_reference(dtype, kv_dtype, spec, budget):
    payload = dict(serving_slots=8, serving_page_size=4,
                   serving_kv_dtype=kv_dtype, serving_speculative=spec,
                   serving_hbm_budget_mb=budget)
    ours, theirs, tcfg, jcfg = _pair(payload, dtype)
    assert (tserve._serving_page_bytes(ours, tcfg)
            == jwork._serving_page_bytes(theirs, jcfg))
    try:
        want = jwork._serving_pool_dims(theirs, jcfg)
    except jwork.MeshConfigError as e:
        with pytest.raises(RuntimeConfigError, match="worst-case request"):
            tserve._serving_pool_dims(ours, tcfg)
        assert "worst-case request" in str(e)
        return
    assert tserve._serving_pool_dims(ours, tcfg) == want
    assert (tserve._serve_max_rows(ours, tcfg)
            == jwork._serve_max_rows(theirs, jcfg))


def test_pool_bytes_are_what_the_cache_allocates():
    """The budget's page price is the P pages' bytes of the cache's pools
    (the sink page is the one past the budget)."""
    for kv_dtype in ("", "int8"):
        ours, _, tcfg, _ = _pair(dict(serving_page_size=4,
                                      serving_kv_dtype=kv_dtype), "bfloat16")
        cache = PagedKVCache(tcfg, slots=2, pages=10, page_size=4,
                             kv_dtype=kv_dtype, device="cpu")
        st = cache.state
        held = sum(t.nbytes for t in (st.pool_k, st.pool_v, st.scale_k,
                                      st.scale_v) if t is not None)
        assert held == 10 * tserve._serving_page_bytes(ours, tcfg)


def test_too_small_budget_fails_loudly():
    ours, theirs, tcfg, jcfg = _pair(dict(serving_slots=4,
                                          serving_page_size=4,
                                          serving_hbm_budget_mb=1), "float32")
    # A larger model, so that 1 MiB cannot hold one worst-case request.
    tcfg = TransformerConfig(**dict(KW, n_layers=64, d_model=256,
                                    n_heads=4, n_kv_heads=4))
    jcfg = jtr.TransformerConfig(**dict(KW, n_layers=64, d_model=256,
                                        n_heads=4, n_kv_heads=4))
    with pytest.raises(jwork.MeshConfigError, match="worst-case request"):
        jwork._serving_pool_dims(theirs, jcfg)
    with pytest.raises(RuntimeConfigError, match="worst-case request"):
        tserve._serving_pool_dims(ours, tcfg)


# ---- the knobs -----------------------------------------------------------


@pytest.mark.parametrize("text", [
    "serving_min_bucket = 4\n",
    "serving_min_bucket = 0\n",
    "serving_hbm_budget_mb = 64\n",
    "serving_prefix_persist = false\n",
    "serving_prefix_persist = true\n",
    "",
])
def test_capacity_knobs_parse_as_the_reference(text):
    doc = "[payload]\nserving = 'paged'\n" + text
    ours, theirs = ServeConfig.parse(doc), JaxConfig.parse(doc)
    for name in ("serving_min_bucket", "serving_hbm_budget_mb",
                 "serving_prefix_persist", "serving_pages"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("text,match", [
    ("serving_min_bucket = -1\n", "serving_min_bucket"),
    ("serving_hbm_budget_mb = -2\n", "serving_hbm_budget_mb"),
    ("serving_hbm_budget_mb = 64\nserving_pages = 32\n",
     "mutually exclusive"),
    ("serving_prefix_persist = 1\n", "serving_prefix_persist"),
])
def test_capacity_knobs_fail_as_the_reference(text, match):
    doc = "[payload]\n" + text
    with pytest.raises(JaxError, match=match):
        JaxConfig.parse(doc)
    with pytest.raises(RuntimeConfigError, match=match):
        ServeConfig.parse(doc)


def test_serve_runtime_runs_the_budgeted_bucketed_pool(tmp_path):
    """The serve payload sizes its pool from the budget and runs the
    bucket ladder from ``serving_min_bucket``."""
    cfg = ServeConfig(preset="probe", n_layers=1, max_seq=64,
                      payload_serving="paged", serving_slots=4,
                      serving_page_size=16, serving_hbm_budget_mb=1,
                      serving_min_bucket=1, state_dir=str(tmp_path))
    rt = tserve.ServeRuntime(cfg, device="cpu", dtype="float32", seed=3)
    try:
        _, pages, _, mpps = tserve._serving_pool_dims(cfg, rt.tcfg)
        assert rt.server._cache.num_pages == pages
        assert pages == 2**20 // tserve._serving_page_bytes(cfg, rt.tcfg)
        assert rt.max_rows == 4 * max(1, min(4, pages // mpps))
        assert rt.server._cache.bucket == 1
        doc = rt.serve_fn({"tokens": [[1, 2, 3], [4, 5, 6]], "n_new": 4})
        assert [len(r) for r in doc["tokens"]] == [7, 7]
    finally:
        rt.close()
