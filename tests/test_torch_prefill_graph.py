"""The prefill chunk as a device-input body (``kvcache.run_prefill``).

On the card every prefill chunk replays a captured CUDA graph of
``run_prefill`` over ``PrefillInputs`` (tokens, slot and offset written in
place), keyed by (bucket, chunk length). Here, on the CPU, it runs
eagerly; what these tests hold:

* the device-input body equals the pre-graph prefill, whose slot and
  offset were Python ints indexing the table row on the host (its code
  is kept below as the oracle), bit for bit at fp32 and bf16 and int8
  (pools and scale slabs too), for chunks at offsets on and off the
  64-grid;
* both equal the JAX package's ``PagedKVCache.prefill_chunk`` on the same
  numpy weights: logits within rtol=atol=1e-4 at fp32 (sum order, and an
  int8 pool's rows quantized across a rounding boundary) and 3e-2 at
  bf16, as ``tests/test_torch_kvcache.py`` holds them; pools within 1e-5
  at fp32, at bf16 within a relative Frobenius error of 1e-2 per layer
  (a layer's K/V inherit the rounding of every layer below), int8 pools
  within one quantization step and their scales within 1e-5;
* the server's device-time counters and the bucket's rows;
* on the card (``cuda`` marker): the replayed graph equals the eager
  body bit for bit, and two threads prefilling chunks of one length
  into two slots each get their own logits.
"""

import threading

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.models import transformer as jtr
    from kvedge_tpu.models.kvcache import PagedKVCache as JaxCache
except ImportError:  # the card's machine: only the cuda legs run there
    jax = jnp = jtr = JaxCache = None

from kvedge_torch.models import kvcache as kvc
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.kvcache import PagedKVCache, PrefillInputs
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.ops.paged_attention import gather_attention, gather_pages

torch.set_num_threads(2)

DIMS = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=128, max_seq=256)
PAGE = 16
# (slot, offset, length): a 64-token chunk on the grid, its remainder,
# and a suffix chunk starting off the grid (a prefix-cache hit's).
CHUNKS = ((1, 0, 64), (1, 64, 13), (2, 0, 37), (2, 37, 20))
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _old_int_slot_prefill(params, state, tokens, slot: int, cfg, offset: int):
    """The prefill as the port ran it before its graphs: ``slot`` and
    ``offset`` Python ints, the table row taken by host indexing."""
    x = params["embedding"][tokens][None]
    positions = offset + torch.arange(tokens.shape[0])
    for layer, lp in enumerate(zip(*(p for p in
                                     ttr.stacked_layer_params(params, cfg)))):
        w_qkv, w_out, w_up, w_down, ln_attn, ln_mlp = lp
        pool_k, pool_v = state.pool_k_full[layer], state.pool_v_full[layer]
        sk = (None if state.scale_k_full is None
              else state.scale_k_full[layer])
        sv = (None if state.scale_v_full is None
              else state.scale_v_full[layer])
        q, k, v = ttr.split_qkv(cfg, ttr._rmsnorm(x, ln_attn) @ w_qkv)
        q, k = ttr._rotary(q, positions), ttr._rotary(k, positions)
        tables = state.tables[slot][None]
        page_idx = tables[0, positions // PAGE].long()
        kvc._write_rows(pool_k, sk, page_idx, positions % PAGE, k[0])
        kvc._write_rows(pool_v, sv, page_idx, positions % PAGE, v[0])
        att = gather_attention(q, gather_pages(pool_k, sk, tables, x.dtype),
                               gather_pages(pool_v, sv, tables, x.dtype),
                               positions[None])
        x = x + att.reshape(1, tokens.shape[0], -1) @ w_out
        x = ttr.mlp(x, w_up, w_down, ln_mlp)
    x = ttr._rmsnorm(x, params["ln_final"])
    return ttr.tied_readout(x[:, -1], params["embedding"])[0]


def _prompts(rng, cfg):
    return {1: rng.integers(0, cfg.vocab, 77).tolist(),
            2: rng.integers(0, cfg.vocab, 57).tolist()}


def _cache(cfg, kv_dtype, device="cpu", cls=PagedKVCache):
    cache = cls(cfg, slots=4, pages=40, page_size=PAGE, kv_dtype=kv_dtype,
                device=device)
    cache.admit(0, 5)  # slot 0 holds pages the others must not touch
    cache.admit(1, 77)
    cache.admit(2, 57)
    return cache


def _pools(cache):
    st = cache.state
    return [t for t in (st.pool_k, st.pool_v, st.scale_k, st.scale_v)
            if t is not None]


@pytest.mark.parametrize("dtype,kv_dtype", [("float32", ""),
                                            ("bfloat16", ""),
                                            ("float32", "int8")],
                         ids=["fp32", "bf16", "int8"])
def test_device_input_body_equals_int_slot_path_and_reference(dtype,
                                                              kv_dtype):
    cfg = TransformerConfig(**DIMS, dtype=dtype)
    tree = ttr.init_params(7, cfg)
    params = params_from_numpy(tree, cfg, "cpu")
    prompts = _prompts(np.random.default_rng(5), cfg)
    body, old = _cache(cfg, kv_dtype), _cache(cfg, kv_dtype)
    jcfg = jtr.TransformerConfig(**DIMS, dtype=dtype, remat=False,
                                 paged_attention="gather")
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jc = JaxCache(jcfg, slots=4, pages=40, page_size=PAGE,
                  kv_dtype=kv_dtype)
    for slot, n in ((0, 5), (1, 77), (2, 57)):
        jc.admit(slot, n)
    for slot, off, n in CHUNKS:
        ids = prompts[slot][off:off + n]
        got = kvc.run_prefill(params, body.state, cfg, PrefillInputs(
            tokens=torch.tensor(ids), slot=torch.tensor(slot),
            offset=torch.tensor(off)))
        want = _old_int_slot_prefill(params, old.state, torch.tensor(ids),
                                     slot, cfg, off)
        assert torch.equal(got, want), (slot, off, n)
        for a, b in zip(_pools(body), _pools(old)):
            assert torch.equal(a, b)
        ref = np.asarray(jc.prefill_chunk(jparams, slot,
                                          jnp.asarray(ids, jnp.int32), off),
                         np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=LOGIT_TOL[dtype],
                                   atol=LOGIT_TOL[dtype])
    jst = jc.state
    if kv_dtype == "int8":
        # One int8 step of the row's scale apart at most.
        for mine, theirs in ((body.state.pool_k, jst.pool_k),
                             (body.state.pool_v, jst.pool_v)):
            gap = np.abs(mine.float().numpy() - np.asarray(theirs, np.float32))
            assert gap.max() <= 1
        np.testing.assert_allclose(body.state.scale_k.numpy(),
                                   np.asarray(jst.scale_k), rtol=1e-5,
                                   atol=1e-7)
    else:
        for mine, theirs in ((body.state.pool_k, jst.pool_k),
                             (body.state.pool_v, jst.pool_v)):
            a = mine.float().numpy()
            b = np.asarray(theirs, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
                continue
            for layer in range(cfg.n_layers):
                err = np.linalg.norm(a[layer] - b[layer])
                assert err <= 1e-2 * np.linalg.norm(b[layer]), layer


def test_prefill_chunk_keeps_its_checks_and_runs_the_body():
    """``prefill_chunk`` on the CPU runs the same body eagerly, refuses a
    chunk past the admitted length, and records no device time."""
    cfg = TransformerConfig(**DIMS, dtype="float32")
    params = params_from_numpy(ttr.init_params(7, cfg), cfg, "cpu")
    prompts = _prompts(np.random.default_rng(5), cfg)
    a, b = _cache(cfg, ""), _cache(cfg, "")
    for slot, off, n in CHUNKS:
        ids = prompts[slot][off:off + n]
        got = a.prefill_chunk(params, slot, ids, off)
        want = kvc.run_prefill(params, b.state, cfg, PrefillInputs(
            torch.tensor(ids), torch.tensor(slot), torch.tensor(off)))
        assert torch.equal(got, want)
    with pytest.raises(kvc.PagedCacheError, match="exceeds"):
        a.prefill_chunk(params, 2, [1, 2, 3], 56)
    assert a.device_seconds() == {"decode": 0.0, "prefill": 0.0}
    assert a.graph_stats()["prefill_graphs"] == 0


def test_server_reports_device_seconds_and_prefills_at_the_bucket():
    """The server's stats carry ``prefill_device_s`` / ``decode_device_s``
    (0 on the CPU, where nothing replays) beside the host spans, and a
    bucketed server prefills through the bucket's table rows with the
    tokens of a pinned one."""
    cfg = TransformerConfig(**dict(DIMS, max_seq=128), dtype="float32")
    params = params_from_numpy(ttr.init_params(3, cfg), cfg, "cpu")
    prompt = list(range(40))
    got = []
    for min_bucket in (0, 1):
        server = PagedGenerationServer(params, cfg, slots=4, pages=40,
                                       page_size=PAGE, prefill_chunk=16,
                                       min_bucket=min_bucket,
                                       prefix_cache=False, device="cpu")
        try:
            got.append(server.submit(prompt, n_new=6))
            st = server.stats()
            assert st["prefill_s"] > 0 and st["prefill_device_s"] == 0.0
            assert st["decode_device_s"] == 0.0
        finally:
            server.close()
    assert got[0] == got[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: prefill chunks replay captured CUDA "
                    "graphs there")
    return torch.device("cuda")


class EagerCache(PagedKVCache):
    """The eager prefill on the card: the same body, no graph."""

    def prefill_chunk(self, params, slot, tokens, offset):
        ids = torch.tensor(list(tokens), device=self.device)
        return kvc._paged_prefill(params, self.state, ids, slot, self.cfg,
                                  offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_dtype", [("float32", ""),
                                            ("bfloat16", ""),
                                            ("bfloat16", "int8")])
def test_cuda_prefill_graph_equals_eager(cuda_device, dtype, kv_dtype):
    cfg = TransformerConfig(**DIMS, dtype=dtype)
    params = params_from_numpy(ttr.init_params(7, cfg), cfg, cuda_device)
    prompts = _prompts(np.random.default_rng(5), cfg)
    graph = _cache(cfg, kv_dtype, cuda_device)
    eager = _cache(cfg, kv_dtype, cuda_device, EagerCache)
    for slot, off, n in CHUNKS:
        ids = prompts[slot][off:off + n]
        got = graph.prefill_chunk(params, slot, ids, off)
        want = eager.prefill_chunk(params, slot, ids, off)
        assert torch.equal(got, want), (slot, off, n)
        for a, b in zip(_pools(graph), _pools(eager)):
            assert torch.equal(a, b)
    stats = graph.graph_stats()
    assert stats["prefill_lengths"] == [13, 20, 37, 64]
    assert graph.device_seconds()["prefill"] > 0


@pytest.mark.cuda
def test_cuda_same_length_chunks_from_two_threads(cuda_device):
    """Two threads prefill chunks of one length into two slots, one lock
    around each call as the server's: each gets its own logits."""
    cfg = TransformerConfig(**DIMS, dtype="bfloat16")
    params = params_from_numpy(ttr.init_params(7, cfg), cfg, cuda_device)
    rng = np.random.default_rng(9)
    ids = {s: rng.integers(0, cfg.vocab, 32).tolist() for s in (1, 2)}
    alone = {}
    for s in (1, 2):
        cache = _cache(cfg, "", cuda_device)
        alone[s] = cache.prefill_chunk(params, s, ids[s], 0).argmax().item()
    cache = _cache(cfg, "", cuda_device)
    lock = threading.Lock()
    got = {}

    def one(s):
        with lock:
            logits = cache.prefill_chunk(params, s, ids[s], 0)
        with lock:
            got[s] = logits.argmax().item()

    threads = [threading.Thread(target=one, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == alone
