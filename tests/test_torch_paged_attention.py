"""The port's paged decode attention against the JAX reference.

The plain version (``paged_decode_attention_reference``, which the
wrapper computes for CPU tensors) is held to the JAX GATHER math of
``_paged_attend_layer`` (``kvcache.py:1596-1614``, inlined below as the
reference's own test inlines it) on ragged lengths, page 16 and page 128
at live 511/512/513, an int8 pool, MHA and GQA; and to the JAX Pallas
kernel under ``interpret=True`` on the small ragged case. Tolerances:
fp32 1e-5 (sum order), bf16 and int8 1e-2 (one bf16 rounding of a
score or weight can differ between the frameworks' matmuls).

The kernel's launch shape (``decode_split``: the cluster size, each
CTA's slice, its K/V ring and its shared memory, or a refusal when the
scores cannot fit) is pure Python and is tested here. The CUDA kernel
itself runs only on the card: the ``cuda``-marked tests hold it to the
plain version there, across the cluster split too (empty slices, slice
boundaries, a K/V ring that loops, G = 8 over int8), and skip on a
machine without one.
The machine with the card has no JAX, so this module imports without it
(the JAX comparisons then skip) and runs there as
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from kvedge_torch.ops import paged_attention as tpa

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.ops.paged_attention import (
        paged_decode_attention as jax_kernel,
    )
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jax_kernel = None

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_gather(q, pool_k, pool_v, tables, q_pos):
    """``_paged_attend_layer``'s gather math at one query per row."""
    B, H, Dh = q.shape
    _, page, KV, _ = pool_k.shape
    MP = tables.shape[1]
    G = H // KV
    k = pool_k[tables].reshape(B, MP * page, KV, Dh)
    v = pool_v[tables].reshape(B, MP * page, KV, Dh)
    qg = q.reshape(B, 1, KV, G, Dh)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, k) / (Dh ** 0.5)
    allowed = jnp.arange(MP * page)[None, :] <= q_pos[:, None]
    s = jnp.where(allowed[:, None, None, None], s, jnp.finfo(q.dtype).min)
    w = jax.nn.softmax(s.astype(jnp.float32), -1).astype(q.dtype)
    att = jnp.einsum("bkgqs,bskd->bqkgd", w, v)
    return att.reshape(B, 1, H, Dh)[:, 0]


def _ragged(B, H, KV, Dh, page, q_pos_list, seed=0, int8=False,
            max_pages=None):
    """numpy inputs whose rows live exactly through ``q_pos_list``; page 0
    stays the unused alias every zeroed table entry points at. Tables are
    at least ``max_pages`` wide (the pool's shape sets the kernel's
    split)."""
    rng = np.random.default_rng(seed)
    MP = max(max(qp // page + 1 for qp in q_pos_list) + 1, max_pages or 0)
    P = sum(qp // page + 1 for qp in q_pos_list) + 1
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    tables = np.zeros((B, MP), np.int32)
    nxt = 1
    for b, qp in enumerate(q_pos_list):
        for j in range(qp // page + 1):
            tables[b, j] = nxt
            nxt += 1
    out = dict(q=q, tables=tables, q_pos=np.asarray(q_pos_list, np.int32))
    if int8:
        out["pool_k"] = rng.integers(-127, 128, (P, page, KV, Dh)).astype(
            np.int8)
        out["pool_v"] = rng.integers(-127, 128, (P, page, KV, Dh)).astype(
            np.int8)
        out["scale_k"] = rng.uniform(0.001, 0.02, (P, page, KV)).astype(
            np.float32)
        out["scale_v"] = rng.uniform(0.001, 0.02, (P, page, KV)).astype(
            np.float32)
    else:
        out["pool_k"] = rng.standard_normal((P, page, KV, Dh)).astype(
            np.float32)
        out["pool_v"] = rng.standard_normal((P, page, KV, Dh)).astype(
            np.float32)
    return out


def _want(case, dtype):
    """The JAX gather on the case (int8 pools dequantized first with the
    reference's formula, as the gather does)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    pk, pv = jnp.asarray(case["pool_k"]), jnp.asarray(case["pool_v"])
    if "scale_k" in case:
        pk = (pk.astype(jnp.float32)
              * jnp.asarray(case["scale_k"])[..., None]).astype(jd)
        pv = (pv.astype(jnp.float32)
              * jnp.asarray(case["scale_v"])[..., None]).astype(jd)
    else:
        pk, pv = pk.astype(jd), pv.astype(jd)
    return _jax_gather(jnp.asarray(case["q"], jd), pk, pv,
                       jnp.asarray(case["tables"]),
                       jnp.asarray(case["q_pos"]))


def _torch_inputs(case, dtype, device="cpu"):
    td = TDT[dtype]
    pool_dtype = torch.int8 if "scale_k" in case else td
    args = (torch.from_numpy(case["q"]).to(device, td),
            torch.from_numpy(case["pool_k"]).to(device, pool_dtype),
            torch.from_numpy(case["pool_v"]).to(device, pool_dtype),
            torch.from_numpy(case["tables"]).to(device),
            torch.from_numpy(case["q_pos"]).to(device))
    kw = {}
    if "scale_k" in case:
        kw = dict(scale_k=torch.from_numpy(case["scale_k"]).to(device),
                  scale_v=torch.from_numpy(case["scale_v"]).to(device))
    return args, kw


def _check(got, want, dtype, what):
    got = got.float().cpu().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(got - want)))
    print(f"{what} [{dtype}] max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


CASES = {
    "page16-ragged-mha": (3, 8, 8, 64, 16, [40, 17, 3]),
    "page16-ragged-gqa": (3, 8, 2, 64, 16, [40, 17, 3]),
    "page16-boundaries": (5, 8, 2, 64, 16, [0, 14, 15, 16, 299]),
    "page128-511-512-513": (3, 8, 2, 64, 128, [510, 511, 512]),
    "small-dh-page4": (2, 4, 2, 8, 4, [9, 2]),
}


# The kernel's cluster split: (B, H, K, Dh, page, q_pos, max_pages, int8).
# Wide tables give 8 CTAs a row: live 1 and 2 leave slices empty, 319 /
# 320 / 321 live positions sit at 8 x 40 - 1, 8 x 40 and 8 x 40 + 1,
# live 4096 at page 128 loops over its K/V ring, and G = 8 reads an
# int8 pool.
CLUSTER_CASES = {
    "live1-live2": (2, 8, 8, 64, 16, [0, 1], 128, False),
    "split-boundaries": (3, 8, 2, 64, 16, [318, 319, 320], 128, False),
    "page128-live4096": (1, 8, 8, 64, 128, [4095], 33, False),
    "gqa8-int8": (2, 8, 1, 64, 16, [700, 37], 64, True),
}


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_gather(reference, name, dtype):
    B, H, KV, Dh, page, q_pos = CASES[name]
    case = _ragged(B, H, KV, Dh, page, q_pos, seed=len(name))
    args, kw = _torch_inputs(case, dtype)
    got = tpa.paged_decode_attention_reference(*args, **kw)
    assert got.shape == (B, H, Dh) and got.dtype == TDT[dtype]
    _check(got, np.asarray(_want(case, dtype).astype(jnp.float32)), dtype,
           name)


@pytest.mark.parametrize("page", [16, 128])
def test_plain_version_matches_jax_gather_int8(reference, page):
    case = _ragged(2, 8, 2, 64, page, [300, 37], seed=7, int8=True)
    args, kw = _torch_inputs(case, "bfloat16")
    got = tpa.paged_decode_attention_reference(*args, **kw)
    want = np.asarray(_want(case, "bfloat16").astype(jnp.float32))
    _check(got, want, "bfloat16", f"int8 page {page}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
def test_plain_version_matches_jax_gather_on_split_cases(reference, name,
                                                         dtype):
    B, H, KV, Dh, page, q_pos, max_pages, int8 = CLUSTER_CASES[name]
    case = _ragged(B, H, KV, Dh, page, q_pos, seed=5, int8=int8,
                   max_pages=max_pages)
    args, kw = _torch_inputs(case, dtype)
    got = tpa.paged_decode_attention_reference(*args, **kw)
    want = np.asarray(_want(case, dtype).astype(jnp.float32))
    _check(got, want, "bfloat16" if int8 else dtype, name)


def test_plain_version_matches_jax_pallas_interpret(reference):
    """The Pallas kernel under the interpreter, on the ragged case that
    passes on the reference tree (B=3, H=8, K=2, page 16, [40, 17, 3])."""
    case = _ragged(3, 8, 2, 64, 16, [40, 17, 3], seed=11)
    jd = jnp.bfloat16
    want = jax_kernel(jnp.asarray(case["q"], jd),
                      jnp.asarray(case["pool_k"], jd),
                      jnp.asarray(case["pool_v"], jd),
                      jnp.asarray(case["tables"]), jnp.asarray(case["q_pos"]),
                      interpret=True)
    args, kw = _torch_inputs(case, "bfloat16")
    _check(tpa.paged_decode_attention_reference(*args, **kw),
           np.asarray(want.astype(jnp.float32)), "bfloat16",
           "vs pallas interpret")


def test_wrapper_on_cpu_computes_the_plain_version_uncounted():
    case = _ragged(3, 8, 2, 64, 16, [40, 17, 3])
    args, kw = _torch_inputs(case, "float32")
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*args, **kw)
    want = tpa.paged_decode_attention_reference(*args, **kw)
    assert torch.equal(got, want)
    assert tpa.paged_decode_attention.launches == before


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    case = _ragged(2, 8, 2, 64, 16, [20, 3])
    (q, pk, pv, tables, q_pos), _ = _torch_inputs(case, "bfloat16")
    assert tpa._check(q, pk, pv, tables, q_pos, None, None) is False
    bad = [
        (q[..., :32].contiguous(), pk[..., :32].contiguous(),
         pv[..., :32].contiguous(), tables, q_pos, None, None),  # Dh 32
        (q, pk, pv, tables.long(), q_pos, None, None),            # int64
        (q, pk, pv, tables, q_pos.long(), None, None),
        (q, pk.float(), pv.float(), tables, q_pos, None, None),   # dtype
        (q.half(), pk.half(), pv.half(), tables, q_pos, None, None),
        (q, pk.transpose(1, 2), pv, tables, q_pos, None, None),   # shape
        (q, pk, pv, tables.t().contiguous().t(), q_pos, None, None),
        (q[:, :6].contiguous(), pk, pv, tables, q_pos, None, None),  # G=3
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpa._check(*args)
    with pytest.raises(ValueError, match="int8"):
        tpa._check(q, pk, pv, tables, q_pos,
                   torch.ones(pk.shape[:3]), torch.ones(pk.shape[:3]))


@pytest.mark.parametrize("max_pages,page,group,itemsize,want", [
    # The serving pool (max_seq 2048, page 16), MHA, bf16.
    (128, 16, 1, 2, (8, 256, 256, 2 * 256 * 128 + 4 * (256 + 16 + 4 + 512
                                                         + 64))),
    # Page 128 at live 4096: the 256-row bf16 ring loops over 528 rows.
    (33, 128, 1, 2, (8, 528, 256, 2 * 256 * 128 + 4 * (528 + 16 + 4 + 512
                                                        + 64))),
    # A short fp32 pool stays on one CTA.
    (3, 16, 4, 4, (1, 48, 48, 2 * 48 * 256 + 4 * (192 + 64 + 16 + 2048
                                                   + 256))),
    # int8, G = 8: the scales ride beside the 512-row ring.
    (17, 128, 8, 1, (8, 272, 272, 2 * 272 * 64 + 4 * (8 * 272 + 2 * 272
                                                      + 128 + 32 + 4096
                                                      + 512))),
])
def test_decode_split_sizes_the_kernel_launch(max_pages, page, group,
                                              itemsize, want):
    assert tpa.decode_split(max_pages, page, group, itemsize) == want


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [16, 128])
def test_decode_split_covers_the_pool_within_shared_memory(page, group,
                                                           itemsize):
    """For every pool up to 1024 pages: at most 8 CTAs, slices that cover
    every position, a ring no longer than the slice, and the layout
    within the 227 KB a CTA may use -- or a refusal naming that limit."""
    fits = 0
    for max_pages in (1, 2, 3, 7, 8, 64, 128, 129, 256, 1024):
        s_cap = max_pages * page
        try:
            split, slice_rows, ring_rows, smem = tpa.decode_split(
                max_pages, page, group, itemsize)
        except ValueError as e:
            assert "232448" in str(e) and group * s_cap // 8 * 4 > 100_000
            continue
        fits += 1
        assert 1 <= split <= 8 and split * slice_rows >= s_cap
        assert (split - 1) * slice_rows < s_cap
        assert 1 <= ring_rows <= slice_rows
        assert ring_rows * 64 * itemsize <= 32768
        assert smem <= tpa.SMEM_LIMIT
    assert fits >= 8


def test_decode_split_refuses_a_score_slice_that_cannot_fit():
    # 65536 positions over 8 CTAs is 8192 scores for each of 8 heads.
    with pytest.raises(ValueError, match=r"232448 \(227 KB\)"):
        tpa.decode_split(4096, 16, 8, 2)
    # The same pool fits with one query head per kv head.
    split, slice_rows, _, smem = tpa.decode_split(4096, 16, 1, 2)
    assert (split, slice_rows) == (8, 8192) and smem <= tpa.SMEM_LIMIT


def test_wrapper_on_cpu_takes_any_pool_length():
    """The refusal is the kernel's: on a CPU tensor the wrapper computes
    the plain version even for a pool the kernel could not split."""
    case = _ragged(1, 8, 1, 64, 16, [40], max_pages=4096)
    args, kw = _torch_inputs(case, "float32")
    with pytest.raises(ValueError):
        tpa.decode_split(args[3].shape[1], 16, 8, 4)
    got = tpa.paged_decode_attention(*args, **kw)
    assert torch.equal(got, tpa.paged_decode_attention_reference(*args, **kw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged decode kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(CLUSTER_CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, name, dtype):
    """CASES at their own table widths; CLUSTER_CASES across B1's cluster
    split (empty slices, slice boundaries, a looping ring, G = 8 int8)."""
    if name in CASES:
        B, H, KV, Dh, page, q_pos = CASES[name]
        max_pages, int8, seed = None, False, 3
    else:
        B, H, KV, Dh, page, q_pos, max_pages, int8 = CLUSTER_CASES[name]
        seed = 9
    if Dh != 64:
        pytest.skip("the kernel is built for Dh = 64")
    case = _ragged(B, H, KV, Dh, page, q_pos, seed=seed, int8=int8,
                   max_pages=max_pages)
    args, kw = _torch_inputs(case, dtype, cuda_device)
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    want = tpa.paged_decode_attention_reference(*args, **kw)
    _check(got, want.float().cpu().numpy(), "bfloat16" if int8 else dtype,
           f"cuda {name}")
