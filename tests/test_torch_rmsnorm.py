"""The port's fused RMSNorm (kvedge_torch.ops.rmsnorm) against the JAX
reference's ``rmsnorm_fused``, run as the reference's own tests run it
off the TPU (the interpret-mode Pallas kernel, or its jnp fallback for a
row count not divisible by 8).

Inputs are made with numpy from a seed and handed to both. Tolerances,
each with its reason:

* forward, against the port's ``_rmsnorm``: bit for bit on the CPU (the
  plain version is the same formula);
* forward, against JAX: fp32 within 1e-6 relative (only the order of
  the fp32 mean's sum differs); bf16 within one bf16 ulp (rtol 2^-7), and
  at most one element in 500 off at all (an fp32 scale one ulp apart
  can round to the next bf16 value);
* the VJP (dx, d gain) against ``jax.grad`` through the reference's
  ``custom_vjp``: 1e-5 (fp32), and the reference's own bounds against
  autodiff of ``_rmsnorm`` (1e-5 / 1e-3);
* the swapped train step's loss within 1e-5 of the stock step's at fp32,
  the reference's bound.

The CUDA kernel runs only on the card: the ``cuda``-marked tests hold it
to its plain version there (also at ragged row counts, widths off the
16-byte vector or past the registers' budget, and misaligned views) and
skip on a machine without one
(``python -m pytest --noconftest -m cuda tests/test_torch_rmsnorm.py``).
"""

import numpy as np
import pytest
import torch

from kvedge_torch.models import training as ttrain
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.ops import rmsnorm as trms

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.models import transformer as jtr
    from kvedge_tpu.ops import rmsnorm as jrms
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jtr = jrms = None

torch.set_num_threads(2)

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(4, 64, 128), (2, 8, 256), (5, 128), (3, 64)]


@pytest.fixture
def reference():
    if jrms is None:
        pytest.skip("the JAX reference is not installed here")
    return jrms


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    gain = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    return x, gain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_reference(reference, shape, dtype):
    x, gain = _inputs(sum(shape), shape)
    want = np.asarray(reference.rmsnorm_fused(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(gain)), np.float32)
    tx = torch.from_numpy(x).to(TDT[dtype])
    tg = torch.from_numpy(gain)
    got = trms.rmsnorm_fused(tx, tg)
    assert got.dtype == TDT[dtype] and got.shape == shape
    # The plain version is _rmsnorm's formula: equal bit for bit.
    assert torch.equal(got, ttr._rmsnorm(tx, tg))
    got = got.float().numpy()
    differ = int(np.sum(got != want))
    err = float(np.max(np.abs(got - want)))
    print(f"{shape} {dtype}: {differ} of {got.size} differ, max {err:.3e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        assert differ <= got.size // 500


# The kernel's own edges: the swapped step's [2048, 512]; N not a
# multiple of the rows a CTA takes (8 warps x 4 rows at D 512 bf16); D not
# a multiple of a 16-byte vector (100, odd 129, 7); D past the rows' register
# budget, taken in segments (2304 bf16, 4100 fp32).
KERNEL_SHAPES = [(2048, 512), (33, 512), (1001, 256), (40, 100), (5, 129),
                 (3, 7), (9, 2304), (4, 4100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_forward_matches_reference_at_kernel_shapes(reference, shape,
                                                           dtype):
    """The plain forward the kernel is held to, against the reference's
    ``rmsnorm_fused`` (interpret-mode Pallas, or its jnp fallback where N
    is not a multiple of 8), at the shapes the kernel's edges meet; the
    tolerances of ``test_forward_matches_reference``."""
    x, gain = _inputs(sum(shape), shape)
    want = np.asarray(reference.rmsnorm_fused(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(gain)), np.float32)
    got = trms.rmsnorm_reference(torch.from_numpy(x).to(TDT[dtype]),
                                 torch.from_numpy(gain))
    assert got.dtype == TDT[dtype] and got.shape == shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        assert int(np.sum(got != want)) <= got.size // 500


@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_reference(reference, shape):
    x, gain = _inputs(2, shape)

    def loss(fn):
        return lambda a, b: jnp.sum(jnp.square(fn(a, b)))

    jx, jg = jnp.asarray(x), jnp.asarray(gain)
    want_dx, want_dg = jax.grad(loss(reference.rmsnorm_fused),
                                argnums=(0, 1))(jx, jg)
    auto_dx, auto_dg = jax.grad(loss(jtr._rmsnorm), argnums=(0, 1))(jx, jg)
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gain).requires_grad_(True)
    torch.square(trms.rmsnorm_fused(tx, tg)).sum().backward()
    assert tg.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(auto_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(auto_dg),
                               rtol=1e-5, atol=1e-3)


def test_bf16_vjp_returns_the_input_dtypes():
    x, gain = _inputs(3, (6, 64))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tg = torch.from_numpy(gain).requires_grad_(True)
    y = trms.rmsnorm_fused(tx, tg)
    y.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tg.grad.dtype == torch.float32
    assert torch.isfinite(tx.grad.float()).all()


def test_train_step_swap_preserves_loss(reference, monkeypatch):
    """The bench tool's patch point (``transformer._rmsnorm`` swapped for
    ``rmsnorm_fused``): the swapped loss equals the stock loss within
    1e-5 in the port, and the port's swapped loss equals the reference's
    swapped loss within 1e-5, at fp32 and from the same weights."""
    shape = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                 max_seq=32, dtype="float32")
    jcfg = jtr.TransformerConfig(**shape)
    tcfg = TransformerConfig(**shape)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = ttrain.master_params(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    batch = np.random.default_rng(1).integers(0, 128, (4, 33)).astype(
        np.int32)
    tb = torch.from_numpy(batch)
    stock = float(ttr.loss_fn(tparams, tb, tcfg).detach())
    monkeypatch.setattr(ttr, "_rmsnorm", trms.rmsnorm_fused)
    monkeypatch.setattr(jtr, "_rmsnorm", reference.rmsnorm_fused)
    keys = sorted(tparams)
    loss = ttr.loss_fn(tparams, tb, tcfg)
    grads = torch.autograd.grad(loss, [tparams[k] for k in keys])
    swapped = float(loss.detach())
    want = float(jtr.loss_fn(jparams, jnp.asarray(batch), jcfg))
    assert abs(swapped - stock) < 1e-5
    assert abs(swapped - want) < 1e-5
    assert all(torch.isfinite(g).all() for g in grads)


def test_forward_checks_refuse_what_the_kernel_does_not_take():
    # The checks run only for CUDA tensors; a meta tensor reaches them
    # without a card.
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        trms.rmsnorm_forward(x, torch.empty(64, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RMSNorm kernel has no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(32768, 512), (7, 100)])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype):
    x, gain = _inputs(sum(shape), shape)
    tx = torch.from_numpy(x).to(cuda_device, TDT[dtype])
    tg = torch.from_numpy(gain).to(cuda_device)
    before = trms.rmsnorm_forward.launches
    got = trms.rmsnorm_fused(tx, tg)
    torch.cuda.synchronize()
    assert trms.rmsnorm_forward.launches == before + 1
    want = trms.rmsnorm_reference(tx, tg)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=0)
    with pytest.raises(ValueError, match="gain must be fp32"):
        trms.rmsnorm_forward(tx.reshape(-1, shape[-1]), tg.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("misaligned", [False, True])
def test_cuda_kernel_ragged_rows_widths_and_misaligned_views(
        cuda_device, shape, dtype, misaligned):
    """The kernel at the rows a CTA does not divide, widths off the 16-byte
    vector, widths taken in segments, and a view one element past an
    aligned address (the scalar loads): one bf16 ulp, fp32 1e-6 relative,
    rows and columns past the edge unwritten."""
    x, gain = _inputs(sum(shape) + misaligned, shape)
    n, d = shape
    buf = torch.empty(n * d + 1, dtype=TDT[dtype], device=cuda_device)
    tx = buf[int(misaligned):int(misaligned) + n * d].view(n, d)
    tx.copy_(torch.from_numpy(x).to(cuda_device, TDT[dtype]))
    assert (tx.data_ptr() % 16 != 0) == misaligned
    tg = torch.from_numpy(gain).to(cuda_device)
    before = trms.rmsnorm_forward.launches
    got = trms.rmsnorm_forward(tx, tg)
    torch.cuda.synchronize()
    assert trms.rmsnorm_forward.launches == before + 1
    want = trms.rmsnorm_reference(tx, tg)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=0)
