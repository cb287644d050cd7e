"""The port's fused cross-entropy (kvedge_torch.ops.xent) and the loss
heads of ``loss_fn`` against the JAX reference, run as the reference's
own tests run it on the CPU (``fused_xent(..., interpret=True)``).

Inputs are made with numpy from a seed and handed to both. Vocab 640 is
5 of the reference's 128-wide blocks (and 10 of the kernels' 64-row
tiles), so the online logsumexp and the blockwise backward cross real
block boundaries. Tolerances, each with its reason:

* fp32: the loss, lse and target logit within 2e-5 (the reference's own
  fused-vs-naive bound: the same fp32 products summed in another order);
  dx and dE within 1e-5.
* bf16 operands: the loss within 2e-5 (s is never rounded to bf16, so
  only the order of the fp32 sums differs); dx within one bf16 ulp
  (rtol 8e-3: a ds or a dx one fp32 ulp apart can round to the next
  bf16 value); dE, fp32 from bf16-rounded ds, within 2e-5 relative to
  its largest entry.
* logits in the hundreds: 1e-4 relative, 1e-3 absolute (the reference's
  bound for that case).
* ``loss_fn`` with ``fused_xent``: the loss within 1e-5 and every
  gradient within 1e-4 at fp32 (as ``test_torch_training.py`` holds the
  naive head); at bf16 the loss within 2e-2.

The CUDA kernels run only on the card: the ``cuda``-marked tests hold
each of them to its plain version there (the bf16 forward also at ragged
N and V, targets on its tiles' edges, logits in the hundreds, two runs
bit for bit) and skip on a machine without one
(``python -m pytest --noconftest -m cuda tests/test_torch_xent.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kvedge_torch.models import training as ttrain
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.ops import xent as tx

try:
    import jax
    import jax.numpy as jnp

    from kvedge_tpu.models import transformer as jtr
    from kvedge_tpu.ops import xent as jx
except ImportError:  # the card's machine: only the cuda leg runs there
    jax = jnp = jtr = jx = None

torch.set_num_threads(2)

V, D, N = 640, 128, 64
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def reference():
    if jx is None:
        pytest.skip("the JAX reference is not installed here")
    return jx


def _inputs(seed, n=N, v=V, d=D, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return x, emb, targets, g


def _jax_run(x, emb, targets, g, dtype):
    """The reference's per-row losses and (dx, dE) of sum(losses * g)."""
    jxx = jnp.asarray(x, getattr(jnp, dtype))
    je, jt = jnp.asarray(emb), jnp.asarray(targets)

    def f(a, b):
        return jnp.sum(jx.fused_xent(a, b, jt, True) * jnp.asarray(g))

    losses = jx.fused_xent(jxx, je, jt, True)
    dx, de = jax.grad(f, argnums=(0, 1))(jxx, je)
    return (np.asarray(losses), np.asarray(dx, np.float32),
            np.asarray(de, np.float32))


def _torch_run(x, emb, targets, g, dtype, device="cpu"):
    """The port's per-row losses and (dx, dE) of sum(losses * g)."""
    tx_ = torch.from_numpy(x).to(device, TDT[dtype]).requires_grad_(True)
    te = torch.from_numpy(emb).to(device).requires_grad_(True)
    losses = tx.fused_xent(tx_, te, torch.from_numpy(targets).to(device))
    (losses * torch.from_numpy(g).to(device)).sum().backward()
    return losses.detach(), tx_.grad, te.grad


def _close(got, want, rtol, atol, what):
    got = got.float().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = float(np.nanmax(np.abs(got - want)))
    print(f"{what}: max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_dx_and_de_match_reference(reference, dtype):
    x, emb, targets, g = _inputs(1)
    want_loss, want_dx, want_de = _jax_run(x, emb, targets, g, dtype)
    loss, dx, de = _torch_run(x, emb, targets, g, dtype)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    assert dx.dtype == TDT[dtype] and de.dtype == torch.float32
    _close(loss, want_loss, 2e-5, 2e-5, f"loss {dtype}")
    if dtype == "float32":
        _close(dx, want_dx, 1e-5, 1e-5, "dx fp32")
        _close(de, want_de, 1e-5, 1e-5, "dE fp32")
    else:
        _close(dx, want_dx, 8e-3, 1e-6, "dx bf16")
        _close(de, want_de, 0, 2e-5 * float(np.abs(want_de).max()),
               "dE bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_reference_kernel(reference, dtype):
    """lse and the target logit apart, against ``_xent_fwd_raw``."""
    x, emb, targets, _ = _inputs(2)
    jxx = jnp.asarray(x, getattr(jnp, dtype))
    je = jnp.asarray(emb).astype(jxx.dtype)
    want_lse, want_t = reference._xent_fwd_raw(
        jxx, je, jnp.asarray(targets), bn=reference.pick_row_block(N, 512),
        bv=reference.pick_vocab_block(V), interpret=True)
    tx_ = torch.from_numpy(x).to(TDT[dtype])
    te = torch.from_numpy(emb).to(TDT[dtype])
    tt = torch.from_numpy(targets)
    lse, tlogit = tx.xent_forward_reference(tx_, te, tt)
    _close(lse, want_lse, 2e-5, 2e-5, f"lse {dtype}")
    _close(tlogit, want_t, 2e-5, 2e-5, f"target logit {dtype}")
    # On a CPU tensor the kernel wrapper computes exactly the plain version.
    got_lse, got_t = tx.xent_forward(tx_, te, tt)
    assert torch.equal(got_lse, lse) and torch.equal(got_t, tlogit)
    g = torch.from_numpy(np.linspace(0.5, 1.5, N, dtype=np.float32))
    assert torch.equal(tx.xent_backward_dx(tx_, te, tt, lse, g),
                       tx.xent_backward_dx_reference(tx_, te, tt, lse, g))
    assert torch.equal(tx.xent_backward_de(tx_, te, tt, lse, g),
                       tx.xent_backward_de_reference(tx_, te, tt, lse, g))


def _edge_targets(rng, n, v):
    """int32 targets, most of them on a column at an edge of the bf16
    forward's 128-column tiles: the first and last column, the first and
    last of the second tile, the last tile's first and last; the rest at
    random."""
    last = (v - 1) // 128 * 128
    edges = np.array([0, v - 1, min(127, v - 1), min(128, v - 1),
                      min(255, v - 1), last, v - 1 - (v > 1)], np.int64)
    t = rng.integers(0, v, n)
    t[: 2 * n // 3] = edges[np.arange(2 * n // 3) % len(edges)]
    return t.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,v,d", [(8, 128, 64), (136, 384, 128),
                                   (1032, 128, 64), (72, 1152, 256)])
def test_plain_forward_matches_reference_kernel_at_ragged_rows(
        reference, n, v, d, dtype):
    """The plain forward the bf16 kernel is held to, against
    ``_xent_fwd_raw`` in interpret mode, at the shapes its masks cover: N
    below, at and past a multiple of the kernel's 128 resident rows (8,
    136, 1032), one tile of vocab and an odd count of tiles (1152: 9), the
    targets on the tiles' first and last columns; lse and the target logit
    within 2e-5, as the reference's fused-vs-naive bound."""
    rng = np.random.default_rng(n + v + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    targets = _edge_targets(rng, n, v)
    jxx = jnp.asarray(x, getattr(jnp, dtype))
    want_lse, want_t = reference._xent_fwd_raw(
        jxx, jnp.asarray(emb).astype(jxx.dtype), jnp.asarray(targets),
        bn=reference.pick_row_block(n, 512), bv=reference.pick_vocab_block(v),
        interpret=True)
    lse, tlogit = tx.xent_forward_reference(
        torch.from_numpy(x).to(TDT[dtype]),
        torch.from_numpy(emb).to(TDT[dtype]), torch.from_numpy(targets))
    _close(lse, want_lse, 2e-5, 2e-5, f"lse {n} {v} {d} {dtype}")
    _close(tlogit, want_t, 2e-5, 2e-5, f"target logit {n} {v} {d} {dtype}")


def test_extreme_logits_stay_finite_and_match(reference):
    """The online logsumexp must survive logits far outside exp()'s range
    (the embedding times 400: logits in the hundreds)."""
    x, emb, targets, g = _inputs(3, scale=0.05 * 400)
    want_loss, want_dx, want_de = _jax_run(x, emb, targets, g, "bfloat16")
    loss, dx, de = _torch_run(x, emb, targets, g, "bfloat16")
    s = x.astype(np.float32) @ emb.T
    assert np.abs(s).max() > 100
    assert torch.isfinite(loss).all() and torch.isfinite(de).all()
    _close(loss, want_loss, 1e-4, 1e-3, "extreme loss")
    _close(dx, want_dx, 8e-3, 1e-3, "extreme dx")
    _close(de, want_de, 1e-4, 1e-3, "extreme dE")


def test_out_of_range_targets_match_reference(reference):
    """ids V and V+7 give NaN losses, -1 wraps to V-1, as
    ``jnp.take_along_axis`` does; the backward uses the clipped ids, as
    the reference's residuals do, so its gradients stay finite."""
    x, emb, _, g = _inputs(5, n=16)
    targets = np.array([V, V + 7, -1, 3] * 4, np.int32)
    want_loss, want_dx, want_de = _jax_run(x, emb, targets, g, "float32")
    loss, dx, de = _torch_run(x, emb, targets, g, "float32")
    got = loss.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want_loss))
    assert np.isnan(got).sum() == 8
    mask = ~np.isnan(want_loss)
    _close(got[mask], want_loss[mask], 2e-5, 2e-5, "valid rows")
    _close(dx, want_dx, 1e-5, 1e-5, "dx from clipped ids")
    _close(de, want_de, 1e-5, 1e-5, "dE from clipped ids")


@pytest.mark.parametrize("block_start", [0, 128, 256, 512])
def test_target_logit_found_in_every_block(reference, block_start):
    x, emb, _, g = _inputs(4, n=16)
    targets = np.full((16,), block_start + 7, np.int32)
    want_loss, _, _ = _jax_run(x, emb, targets, g, "float32")
    loss, _, _ = _torch_run(x, emb, targets, g, "float32")
    _close(loss, want_loss, 2e-5, 2e-5, f"targets at {block_start + 7}")


def test_pickers_refuse_as_the_reference_does(reference):
    for vocab in (32000, 512, 640, 128, 2560):
        assert tx.pick_vocab_block(vocab) == reference.pick_vocab_block(vocab)
    for rows in (32768, 64, 8, 1032, 136):
        for cap in (1024, reference.FWD_MAX_ROWS, reference.BWD_MAX_ROWS):
            assert tx.pick_row_block(rows, cap) == \
                reference.pick_row_block(rows, cap)
    for fn, arg, match in ((tx.pick_vocab_block, 1000, "divisible by 128"),
                           (tx.pick_row_block, 12, "divisible by 8")):
        with pytest.raises(ValueError, match=match) as ours:
            fn(arg)
        with pytest.raises(ValueError) as theirs:
            getattr(reference, fn.__name__)(arg)
        assert str(ours.value) == str(theirs.value)
    # fused_xent refuses them before any work, as the reference does.
    x = torch.zeros(12, 64)
    with pytest.raises(ValueError, match="divisible by 8"):
        tx.fused_xent(x, torch.zeros(128, 64),
                      torch.zeros(12, dtype=torch.long))
    with pytest.raises(ValueError, match="divisible by 128"):
        tx.fused_xent(x[:8], torch.zeros(100, 64),
                      torch.zeros(8, dtype=torch.long))


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(16, 64)
    e = torch.zeros(128, 64)
    t = torch.zeros(16, dtype=torch.int32)
    rows = torch.zeros(16)
    assert tx._check("t", x, e, t, (rows, rows)) == (16, 128, 64)
    bad = [
        ((x[:, :48].contiguous(), e[:, :48].contiguous(), t), "D in"),
        ((x.half(), e.half(), t), "bf16 or fp32"),
        ((x, e.to(torch.bfloat16), t), "one dtype"),
        ((x, e[:, :32], t), r"x \[N, D\] and E \[V, D\]"),
        ((x, e, t.long()), "int32"),
        ((x.t().contiguous().t(), e, t), "contiguous"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tx._check("t", *args)
    with pytest.raises(ValueError, match="fp32 \\[N\\]"):
        tx._check("t", x, e, t, (rows.double(),))
    shifted = torch.zeros(16 * 64 + 1, dtype=torch.bfloat16)[1:].view(16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tx._check("t", shifted, e.to(torch.bfloat16), t)


@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("n,v", [(1, 128), (8, 128), (40, 64), (65, 640),
                                 (130, 330), (200, 1000), (1032, 200)])
def test_plain_passes_match_float64_autograd_at_ragged_shapes(n, v, d):
    """The wrappers' CPU path (the plain versions the kernels are held to)
    at N and V that are not multiples of the kernels' 64-row tiles, half
    the targets in the last partial vocab tile: lse, the target logit, dx
    and dE against float64 autograd of sum(g * cross_entropy), fp32."""
    rng = np.random.default_rng(n * 7 + v + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    e = torch.from_numpy(
        (rng.standard_normal((v, d)) * 0.05).astype(np.float32))
    t = rng.integers(0, v, n)
    t[1::2] = v - 1 - np.arange(n)[1::2] % (v % 64 or 64)
    t = torch.from_numpy(t.astype(np.int32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))

    xd, ed = (a.double().requires_grad_(True) for a in (x, e))
    logits = xd @ ed.t()
    want_lse = torch.logsumexp(logits, -1)
    want_tl = logits.gather(1, t.long()[:, None])[:, 0]
    torch.autograd.backward((want_lse - want_tl) * g.double(),
                            torch.ones(n, dtype=torch.float64))
    lse, tl = tx.xent_forward(x, e, t)
    dx = tx.xent_backward_dx(x, e, t, lse, g)
    de = tx.xent_backward_de(x, e, t, lse, g)
    assert dx.dtype == torch.float32 and de.shape == (v, d)
    for name, got, want in (("lse", lse, want_lse), ("tlogit", tl, want_tl),
                            ("dx", dx, xd.grad), ("dE", de, ed.grad)):
        torch.testing.assert_close(got.double(), want.detach(), rtol=1e-5,
                                   atol=1e-5, msg=name)


def test_aligned16_copies_only_misaligned_rows():
    rows = torch.arange(40, dtype=torch.float32)
    assert tx._aligned16(rows) is rows
    shifted = rows[1:33]
    assert shifted.data_ptr() % 16
    copy = tx._aligned16(shifted)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, shifted)


def test_wrap_targets_is_take_along_axis_index_semantics(reference):
    """The naive head's repair: ``take_target_logit`` against
    ``jnp.take_along_axis`` on the same logits and ids, NaN masks and
    values."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, V)).astype(np.float32)
    ids = np.array([V, V + 7, -1, 3], np.int32)
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(logits), jnp.asarray(ids)[:, None], axis=-1))[:, 0]
    got = ttr.take_target_logit(torch.from_numpy(logits),
                                torch.from_numpy(ids).long()).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[2:], want[2:])
    assert got[2] == logits[2, V - 1] and np.isnan(got[:2]).all()
    # Every wrapping id in [-V, 0) lands where numpy's indexing lands.
    neg = np.arange(-V, 0, 37)
    picked = ttr.take_target_logit(
        torch.from_numpy(logits[:1]).expand(len(neg), V),
        torch.from_numpy(neg)).numpy()
    np.testing.assert_array_equal(picked, logits[0, neg])


# ---- loss_fn -------------------------------------------------------------

SHAPE = dict(vocab=V, d_model=D, n_heads=4, n_layers=2, d_ff=256, max_seq=32)


def _cfgs(dtype="float32", fused=True, attention="naive"):
    kw = dict(SHAPE, dtype=dtype, fused_xent=fused, attention=attention)
    return jtr.TransformerConfig(**kw), TransformerConfig(**kw)


def _weights(jcfg, tcfg, seed=0):
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = ttrain.master_params(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    return jparams, tparams


def _batch(seed, rows=4, seq=32):
    return np.random.default_rng(seed).integers(
        0, V, (rows, seq + 1)).astype(np.int32)


def _grads(tparams, batch, tcfg):
    keys = sorted(tparams)
    loss = ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg)
    grads = torch.autograd.grad(loss, [tparams[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_fused_loss_fn_matches_reference_fused_loss_fn(reference, attention):
    """The reference's FUSED_CFG shape (vocab 640, d_model 128, 4 heads,
    2 layers, d_ff 256) at fp32, from the same weights: loss and every
    gradient, the embedding's being the input gather's scatter-add plus
    the fused dE."""
    jcfg, tcfg = _cfgs(attention=attention)
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(1)
    want_loss, want = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(batch), jcfg)
    loss, grads = _grads(tparams, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    assert set(grads) == set(want)
    for key in grads:
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_fused_bf16_loss_matches_reference(reference):
    jcfg, tcfg = _cfgs("bfloat16")
    jparams, tparams = _weights(jcfg, tcfg, seed=2)
    batch = _batch(3)
    want = float(jtr.loss_fn(jparams, jnp.asarray(batch), jcfg))
    with torch.no_grad():
        got = float(ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg))
    print(f"bf16 fused loss port {got:.6f} reference {want:.6f}")
    assert abs(got - want) < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_and_naive_heads_agree_inside_the_port(dtype):
    """fp32: loss 1e-5, gradients 1e-4. bf16: the reference's own bound
    between its heads (loss 1e-3, gradients 5e-2 / 5e-3): the fused dx
    is rounded to bf16 where the naive head's matmul backward is not."""
    _, fused = _cfgs(dtype)
    naive = dataclasses.replace(fused, fused_xent=False)
    tree = ttr.init_params(7, fused)
    batch = _batch(8)
    (l_f, g_f), (l_n, g_n) = (
        _grads(ttrain.master_params(tree, c, "cpu"), batch, c)
        for c in (fused, naive))
    ltol, rtol, atol = (1e-5, 1e-4, 1e-4) if dtype == "float32" else \
        (1e-3, 5e-2, 5e-3)
    assert abs(float(l_f) - float(l_n)) < ltol
    for key in g_n:
        np.testing.assert_allclose(g_f[key].numpy(), g_n[key].numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_naive_loss_fn_keeps_take_along_axis_semantics(reference):
    """The repaired naive head: a target id of V in the last column NaNs
    the loss in both frameworks (torch.gather used to raise); -1 wraps
    to V - 1 and the losses agree."""
    jcfg, tcfg = _cfgs(fused=False)
    jparams, tparams = _weights(jcfg, tcfg)
    for bad, finite in ((V, False), (V + 7, False), (-1, True), (-V, True)):
        batch = _batch(4)
        batch[1, -1] = bad  # a target only: inputs are batch[:, :-1]
        want = float(jtr.loss_fn(jparams, jnp.asarray(batch), jcfg))
        with torch.no_grad():
            got = float(ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg))
            fused = float(ttr.loss_fn(
                tparams, torch.from_numpy(batch),
                dataclasses.replace(tcfg, fused_xent=True)))
        assert np.isfinite(want) == finite, (bad, want)
        assert np.isnan(got) == np.isnan(want) == np.isnan(fused), bad
        if finite:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(fused, want, rtol=1e-5, atol=1e-5)


def test_eval_under_no_grad_runs_only_the_forward(monkeypatch):
    """With fused_xent, a no-grad loss (the eval payload's) calls only
    the forward wrapper; a train step calls each of the three once."""
    calls = []
    for name in ("xent_forward", "xent_backward_dx", "xent_backward_de"):
        fn = getattr(tx, name)
        monkeypatch.setattr(tx, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    _, cfg = _cfgs()
    params = ttrain.master_params(ttr.init_params(3, cfg), cfg, "cpu")
    batch = torch.from_numpy(_batch(9))
    with torch.no_grad():
        ttr.loss_fn(params, batch, cfg)
    assert calls == ["xent_forward"]
    calls.clear()
    init, step = ttrain.make_train_step(cfg, "cpu")
    step(params, init(params), batch)
    assert sorted(calls) == ["xent_backward_de", "xent_backward_dx",
                             "xent_forward"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the xent kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,v,d", [(64, 640, 128), (40, 128, 64),
                                   (1032, 32000, 512)])
def test_cuda_kernels_match_plain_versions(cuda_device, n, v, d, dtype):
    rng = np.random.default_rng(n + v + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((v, d)) * 0.05).astype(
        np.float32))
    x, e = (t.to(cuda_device, TDT[dtype]) for t in (x, e))
    t = torch.from_numpy(rng.integers(0, v, n).astype(np.int32)).to(
        cuda_device)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(
        cuda_device)
    before = (tx.xent_forward.launches, tx.xent_backward_dx.launches,
              tx.xent_backward_de.launches)
    lse, tlogit = tx.xent_forward(x, e, t)
    dx = tx.xent_backward_dx(x, e, t, lse, g)
    de = tx.xent_backward_de(x, e, t, lse, g)
    torch.cuda.synchronize()
    assert (tx.xent_forward.launches, tx.xent_backward_dx.launches,
            tx.xent_backward_de.launches) == tuple(b + 1 for b in before)
    want_lse, want_t = tx.xent_forward_reference(x, e, t)
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    _close(lse - tlogit, (want_lse - want_t).cpu().numpy(), tol, tol,
           "cuda loss")
    # bf16 gradients: 3e-2, and at most two (dx) / one (dE) bf16 ulps of
    # the largest entry, as chip_smoke.py holds them.
    for name, got, want, ulps in (
            ("dx", dx, tx.xent_backward_dx_reference(x, e, t, lse, g), 2),
            ("dE", de, tx.xent_backward_de_reference(x, e, t, lse, g), 1)):
        want = want.float().cpu().numpy()
        if dtype == "float32":
            rtol, atol = 1e-5, 1e-5
        else:
            rtol, atol = 0.0, min(3e-2, ulps * 2.0 ** -7 * np.abs(want).max())
        _close(got, want, rtol, atol, f"cuda {name}")
    assert torch.equal(dx, tx.xent_backward_dx(x, e, t, lse, g))
    assert torch.equal(de, tx.xent_backward_de(x, e, t, lse, g))


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,d", [(200, 1000, 256), (130, 330, 512),
                                   (72, 200, 64), (1032, 32000, 256)])
def test_cuda_backward_ragged_shapes_and_last_vocab_tile(cuda_device, n, v,
                                                         d):
    """The bf16 backward at N and V that are multiples neither of 64 nor
    of a cluster's 128 rows, with targets in the last, partial vocab tile
    and a g that is not 16-byte aligned: dx within two bf16 ulps and dE
    within one of their largest entry (as chip_smoke.py holds them), the
    two runs bit-identical."""
    rng = np.random.default_rng(7 * n + v + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((v, d)) * 0.05).astype(
        np.float32))
    x, e = (t.to(cuda_device, torch.bfloat16) for t in (x, e))
    last = v - 1 - np.arange(n) % (v % 64 or 64)
    t = torch.from_numpy(np.where(np.arange(n) % 2, last, rng.integers(
        0, v, n)).astype(np.int32)).to(cuda_device)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n + 1).astype(np.float32)).to(
        cuda_device)[1:]
    lse, _ = tx.xent_forward(x, e, t)
    before = (tx.xent_backward_dx.launches, tx.xent_backward_de.launches)
    dx = tx.xent_backward_dx(x, e, t, lse, g)
    de = tx.xent_backward_de(x, e, t, lse, g)
    torch.cuda.synchronize()
    assert (tx.xent_backward_dx.launches,
            tx.xent_backward_de.launches) == (before[0] + 1, before[1] + 1)
    for name, got, want, ulps in (
            ("dx", dx, tx.xent_backward_dx_reference(x, e, t, lse, g), 2),
            ("dE", de, tx.xent_backward_de_reference(x, e, t, lse, g), 1)):
        want = want.float().cpu().numpy()
        atol = min(3e-2, ulps * 2.0 ** -7 * np.abs(want).max())
        _close(got, want, 0.0, atol, f"cuda ragged {name}")
    assert torch.equal(dx, tx.xent_backward_dx(x, e, t, lse, g))
    assert torch.equal(de, tx.xent_backward_de(x, e, t, lse, g))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("n,v,scale", [
    (8, 200, 0.05), (1032, 330, 0.05), (130, 128, 0.05), (8, 1000, 0.05),
    (1032, 32000, 0.05), (136, 640, 0.05 * 400), (1032, 1000, 0.05 * 400)])
def test_cuda_bf16_forward_ragged_shapes_and_tile_edges(cuda_device, n, v,
                                                        scale, d):
    """The bf16 forward (128 resident rows a CTA, 128-column score tiles)
    at N and V that are not multiples of either, V of one tile and of an
    odd and an even count, targets on the first and last column of the
    first, second and last (partial) tile, and logits in the hundreds
    (``scale`` 20): lse and the target logit apart, each within 1e-5
    relative and 1e-4 absolute of the plain forward (the same fp32
    products summed in another order, and exp taken on ex2), 1e-4 and
    1e-3 with logits in the hundreds (the reference's bound there);
    finite; two runs bit-identical."""
    rng = np.random.default_rng(3 * n + v + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((v, d)) * scale).astype(
        np.float32))
    x, e = (t.to(cuda_device, torch.bfloat16) for t in (x, e))
    t = torch.from_numpy(_edge_targets(rng, n, v)).to(cuda_device)
    before = tx.xent_forward.launches
    lse, tlogit = tx.xent_forward(x, e, t)
    lse2, tlogit2 = tx.xent_forward(x, e, t)
    torch.cuda.synchronize()
    assert tx.xent_forward.launches == before + 2
    assert torch.equal(lse, lse2) and torch.equal(tlogit, tlogit2)
    assert torch.isfinite(lse).all() and torch.isfinite(tlogit).all()
    want_lse, want_t = tx.xent_forward_reference(x, e, t)
    if scale > 1:
        assert float(want_lse.abs().max()) > 100
    rtol, atol = (1e-4, 1e-3) if scale > 1 else (1e-5, 1e-4)
    _close(lse, want_lse.cpu().numpy(), rtol, atol, "cuda bf16 lse")
    _close(tlogit, want_t.cpu().numpy(), rtol, atol, "cuda bf16 tlogit")
