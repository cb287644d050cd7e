"""The port's flash attention (kvedge_torch.ops.attention) against the JAX
reference's Pallas kernels, run as the reference's own tests run them on
the CPU (``interpret=True``).

Inputs are made with numpy from a seed and handed to both. The plain
forward (O and LSE) is held to ``flash_attention`` and ``_flash_fwd_raw``
at block 32 and at the default block: fp32 2e-5 (the order of the fp32
sums and where each row's running max is taken), bf16 1e-2 (a bf16
rounding of p or O can land one ulp apart). The plain backward, and the
autograd path through ``_FlashAttention``, are held to ``jax.grad``
through the reference's ``custom_vjp`` at fp32 2e-4.

The CUDA kernels run only on the card: the ``cuda``-marked test holds
each of them to its plain version there and skips on a machine without
one. The card's machine has no JAX, so this module imports without it
(the JAX comparisons then skip) and runs there as
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from kvedge_torch.ops import attention as fa

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.ops import attention as jfa
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jfa = None

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def reference():
    if jfa is None:
        pytest.skip("the JAX reference is not installed here")
    return jfa


def _qkv(seed, bh, seq, dh, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, seq, dh)).astype(np.float32)
            for _ in range(n)]


def _jax(xs, dtype):
    return [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]


def _torch(xs, dtype, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=TDT[dtype])
            for x in xs]


def _close(got, want, tol, what):
    got = got.float().cpu().numpy()
    want = np.asarray(want, dtype=np.float32)
    err = float(np.max(np.abs(got - want)))
    print(f"{what}: max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("seq,block", [(64, 32), (64, None), (40, None),
                                       (136, None)])
def test_plain_forward_matches_reference_kernel(reference, seq, block, dh,
                                                dtype):
    q, k, v = _qkv(10 + seq + dh, 3, seq, dh)
    jq, jk, jv = _jax((q, k, v), dtype)
    blk = reference.pick_block(seq) if block is None else block
    want_out, want_lse = reference._flash_fwd_raw(jq, jk, jv, block=blk,
                                                  interpret=True)
    want_vjp = reference.flash_attention(jq, jk, jv, block, True)
    out, lse = fa.flash_forward_reference(*_torch((q, k, v), dtype))
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert lse.shape == (3, seq)
    _close(out, want_out, TOL[dtype], f"out {dtype} T={seq} Dh={dh}")
    _close(out, want_vjp, TOL[dtype], "out vs custom_vjp forward")
    _close(lse, want_lse, TOL["float32"], "lse")
    # On a CPU tensor the kernel wrapper computes exactly the plain version.
    got, got_lse = fa.flash_forward(*_torch((q, k, v), dtype))
    assert torch.equal(got, out) and torch.equal(got_lse, lse)


@pytest.mark.parametrize("seq,block", [(64, 32), (40, None)])
def test_plain_backward_matches_reference_vjp(reference, seq, block):
    q, k, v, do = _qkv(7 + seq, 2, seq, 16, n=4)

    def f(a, b, c):
        return jnp.sum(reference.flash_attention(a, b, c, block, True) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*_jax((q, k, v), "float32"))
    tq, tk, tv, tdo = _torch((q, k, v, do), "float32")
    out, lse = fa.flash_forward_reference(tq, tk, tv)
    got = fa.flash_backward_reference(tq, tk, tv, out, lse, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 2e-4, f"plain {name} T={seq}")
    # The autograd.Function the model calls gives the same gradients.
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (fa.flash_attention(*leaves, block) * tdo).sum().backward()
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        _close(leaf.grad, w, 2e-4, f"autograd {name} T={seq}")


def test_backward_parts_split_as_the_kernels_do():
    """dq and dk/dv passes computed apart equal the one-call backward,
    and delta is rowsum(dO * O) in fp32."""
    q, k, v, do = _torch(_qkv(3, 2, 24, 16, n=4), "bfloat16")
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(do, out)
    np.testing.assert_allclose(
        delta.numpy(), (do.float() * out.float()).sum(-1).numpy())
    dq, dk, dv = fa.flash_backward_reference(q, k, v, out, lse, do)
    assert torch.equal(fa.flash_backward_dq(q, k, v, do, lse, delta), dq)
    got_dk, got_dv = fa.flash_backward_dkv(q, k, v, do, lse, delta)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}


def test_pick_block_rule_and_refusal(reference):
    for seq in (512, 1024, 96, 40, 8, 136, 2048, 24):
        assert fa.pick_block(seq) == reference.pick_block(seq)
    assert fa.pick_block(512) == 256 and fa.pick_block(40) == 8
    for seq in (12, 50, 7):
        with pytest.raises(ValueError, match="divisible by 8") as ours:
            fa.pick_block(seq)
        with pytest.raises(ValueError) as theirs:
            reference.pick_block(seq)
        assert str(ours.value) == str(theirs.value)
    q, k, v = _torch(_qkv(1, 1, 48, 16), "float32")
    with pytest.raises(ValueError, match="multiple of block"):
        fa.flash_attention(q, k, v, 32)
    with pytest.raises(ValueError, match="divisible by 8"):
        fa.flash_attention(q[:, :20], k[:, :20], v[:, :20])


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    q, k, v = _torch(_qkv(2, 2, 16, 64), "float32")
    assert fa._check("t", (q, k, v)) == (2, 16, 64)
    bad = [
        ((q[:, :, :48].contiguous(), k[:, :, :48].contiguous(),
          v[:, :, :48].contiguous()), "Dh"),
        ((q.half(), k.half(), v.half()), "bf16 or fp32"),
        ((q, k.to(torch.bfloat16), v), "share shape and dtype"),
        ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
         "contiguous"),
        ((q[0], k[0], v[0]), r"\[BH, T, Dh\]"),
    ]
    for tensors, match in bad:
        with pytest.raises(ValueError, match=match):
            fa._check("t", tensors)
    with pytest.raises(ValueError, match="fp32"):
        fa._check("t", (q, k, v), (torch.zeros(2, 16, dtype=torch.float64),))
    # bf16 tiles load in 16-byte vectors: a contiguous view one element
    # into its storage is refused.
    shifted = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(2, 16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check("t", (shifted, shifted, shifted))
    assert fa.softmax_scale(64) == 0.125
    assert fa.softmax_scale(32) == float(np.float32(32 ** -0.5))


@pytest.mark.parametrize("shape,match", [
    ((0, 16, 64), "1 <= BH <= 65535"),
    ((65536, 1, 32), "1 <= BH <= 65535"),
    ((2, 0, 64), "T >= 1"),
])
def test_kernel_checks_refuse_shapes_outside_the_grid(shape, match):
    """Every flash kernel's grid puts BH on gridDim.y (at most 65535)."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fa._check("t", (x, x, x))


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("seq", [8, 40, 64, 136, 192, 512, 576, 2048])
def test_cta_tiles_cover_each_causal_tile_once(seq, kernel):
    """Pairs of tiles (n - 1 - p, p) a CTA: every causal (q tile, k tile)
    product is run once, every CTA but an odd count's middle one runs
    n + 1 of them, and each CTA starts with its heavier tile."""
    n = -(-seq // 64)
    ctas = fa.cta_tiles(seq, kernel)
    assert len(ctas) == (n + 1) // 2
    done = [tile for cta in ctas for tile in cta]
    assert sorted(done) == [(q, k) for q in range(n) for k in range(q + 1)]
    sizes = [len(cta) for cta in ctas]
    assert sizes[:n // 2] == [n + 1] * (n // 2)
    if n % 2:
        assert sizes[-1] == (n + 1) // 2
    owner = 0 if kernel in ("fwd", "dq") else 1  # the tile the CTA owns
    for cta in ctas:
        first = [tile for tile in cta if tile[owner] == cta[0][owner]]
        assert len(first) >= len(cta) - len(first)
    with pytest.raises(ValueError, match="fwd, dq or dkv"):
        fa.cta_tiles(seq, "bwd")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("seq", [8, 40, 64, 136, 320, 512])
@pytest.mark.parametrize("bh", [1, 16])
def test_cuda_kernels_match_plain_versions(cuda_device, bh, seq, dh, dtype):
    """T 8 and 40 are one partial tile, 64 one full tile, 136 two full
    tiles and a partial one, 320 five (an odd number of 128-row blocks,
    one with a single tile), 512 eight: each meets the bf16 forward's TMA
    loads, whose rows past T read as zeros."""
    q, k, v, do = _torch(_qkv(seq + dh + bh, bh, seq, dh, n=4), dtype,
                         cuda_device)
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
              fa.flash_backward_dkv.launches)
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(do, out)
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == tuple(b + 1 for b in before)
    want_out, want_lse = fa.flash_forward_reference(q, k, v)
    tol, gtol = {"float32": (1e-5, 2e-4), "bfloat16": (1e-2, 3e-2)}[dtype]
    _close(out, want_out.float().cpu().numpy(), tol, "cuda out")
    _close(lse, want_lse.cpu().numpy(), 1e-5, "cuda lse")
    _close(dq, fa.flash_backward_dq_reference(q, k, v, do, lse, delta)
           .float().cpu().numpy(), gtol, "cuda dq")
    want_dk, want_dv = fa.flash_backward_dkv_reference(q, k, v, do, lse,
                                                       delta)
    _close(dk, want_dk.float().cpu().numpy(), gtol, "cuda dk")
    _close(dv, want_dv.float().cpu().numpy(), gtol, "cuda dv")


def _backward(q, k, v, do):
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.attention_delta(do, out)
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta)
    return lse, delta, (dq, dk, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("seq", [8, 40, 192, 576])
@pytest.mark.parametrize("bh", [1, 16])
def test_cuda_backward_pairs_and_padding(cuda_device, bh, seq, dh, dtype):
    """T 192 and 576 are 3 and 9 tiles: an odd count leaves the middle
    tile alone in the last CTA of a pair schedule. T 8 and 40 are one
    partial tile, whose query rows past T read as zeros, and whose lse and
    delta entries past T come from the next head: dk and dv must mask
    them."""
    q, k, v, do = _torch(_qkv(2 * seq + dh + bh, bh, seq, dh, n=4), dtype,
                         cuda_device)
    lse, delta, (dq, dk, dv) = _backward(q, k, v, do)
    torch.cuda.synchronize()
    gtol = {"float32": 2e-4, "bfloat16": 3e-2}[dtype]
    want_dk, want_dv = fa.flash_backward_dkv_reference(q, k, v, do, lse,
                                                       delta)
    for name, got, want in (
            ("dq", dq, fa.flash_backward_dq_reference(q, k, v, do, lse,
                                                      delta)),
            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert bool(torch.isfinite(got).all()), name
        _close(got, want.float().cpu().numpy(), gtol, f"cuda {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_cuda_backward_bitwise_identical_over_two_runs(cuda_device, dh,
                                                       dtype):
    """No atomics: dq, dk and dv are written by one CTA each, in a fixed
    order, so two runs on the same inputs agree bit for bit."""
    q, k, v, do = _torch(_qkv(5 + dh, 16, 576, dh, n=4), dtype, cuda_device)
    _, _, first = _backward(q, k, v, do)
    _, _, second = _backward(q, k, v, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq", [(16, 512), (2, 64), (3, 40), (1, 8)])
def test_cuda_delta_is_an_fp32_sum_of_the_exact_products(cuda_device, bh,
                                                         seq):
    """On the card bf16 delta comes from 64-row block products where the
    rows divide into blocks (16 x 512, 2 x 64: there the blocks' diagonals
    are a strided view, which the kernels refuse) and from addcmul
    otherwise: either is a contiguous fp32 sum of the exact products,
    within the rounding bound of a 64-term fp32 sum in any order."""
    do, o = _torch(_qkv(9 + seq, bh, seq, 64, n=2), "bfloat16", cuda_device)
    got = fa.attention_delta(do, o)
    assert got.dtype == torch.float32 and got.shape == (bh, seq)
    assert got.is_contiguous()
    prod = do.double() * o.double()
    bound = 64 * 2.0 ** -24 * prod.abs().sum(-1)
    assert bool(((got.double() - prod.sum(-1)).abs() <= bound).all())
