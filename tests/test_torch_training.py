"""The port's training path (loss, gradients, AdamW steps, remat, the
checkpoint and ``run_training``) against the JAX reference.

The same numpy inputs and the reference's own weights (through the
port's bridge at fp32) go into ``kvedge_tpu``'s ``loss_fn`` /
``jax.grad`` / ``make_train_step`` (optax) and into the port's.
Tolerances: the fp32 loss within 1e-5 and every gradient within 1e-4
(sums in other orders; exp, log and tanh differ in the last ulp); three
optax-ordered AdamW steps: losses within 1e-5, params within 1e-4; the
bf16 loss within 2e-2 (XLA and torch round bf16 chains at other points).
Within the port, remat on and off, and 6 steps against 3 + 3 resumed,
agree bit for bit on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_torch.models import training as ttrain
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.runtime.checkpoint import StateCheckpointer

torch.set_num_threads(2)

SHAPE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)


def _cfgs(attention="naive", n_kv_heads=0, dtype="float32", remat=True):
    jcfg = jtr.TransformerConfig(**SHAPE, n_kv_heads=n_kv_heads, dtype=dtype,
                                 attention=attention, remat=remat)
    tcfg = TransformerConfig(**SHAPE, n_kv_heads=n_kv_heads, dtype=dtype,
                             attention=attention, remat=remat)
    return jcfg, tcfg


def _weights(jcfg, tcfg, seed=0):
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = ttrain.master_params(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    return jparams, tparams


def _batch(seed, rows=2, seq=64):
    return np.random.default_rng(seed).integers(
        0, SHAPE["vocab"], (rows, seq + 1)).astype(np.int32)


def _grads(tparams, batch, tcfg):
    keys = sorted(tparams)
    loss = ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg)
    grads = torch.autograd.grad(loss, [tparams[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_loss_and_every_gradient_match_reference(attention, n_kv_heads):
    jcfg, tcfg = _cfgs(attention, n_kv_heads)
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(1, seq=64 if attention == "naive" else 40)
    want_loss, want = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(batch), jcfg)
    loss, grads = _grads(tparams, batch, tcfg)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    assert set(grads) == set(want)
    for key in grads:
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_bf16_loss_matches_reference():
    jcfg, tcfg = _cfgs("flash", dtype="bfloat16")
    jparams, tparams = _weights(jcfg, tcfg, seed=2)
    batch = _batch(3)
    want = float(jtr.loss_fn(jparams, jnp.asarray(batch), jcfg))
    with torch.no_grad():
        got = float(ttr.loss_fn(tparams, torch.from_numpy(batch), tcfg))
    print(f"bf16 loss port {got:.6f} reference {want:.6f}")
    assert abs(got - want) < 2e-2


@pytest.mark.parametrize("attention,n_kv_heads",
                         [("flash", 0), ("naive", 2)])
def test_three_adamw_steps_match_optax(attention, n_kv_heads):
    jcfg, tcfg = _cfgs(attention, n_kv_heads)
    jparams, tparams = _weights(jcfg, tcfg, seed=4)
    j_init, j_step = jtr.make_train_step(jcfg)
    j_opt = j_init(jparams)
    t_init, t_step = ttrain.make_train_step(tcfg, "cpu")
    t_opt = t_init(tparams)
    for i in range(3):
        batch = _batch(10 + i)
        jparams, j_opt, j_loss = j_step(jparams, j_opt, jnp.asarray(batch))
        tparams, t_opt, t_loss = t_step(tparams, t_opt, batch)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5,
                                   atol=1e-5, err_msg=f"loss step {i + 1}")
    assert int(t_opt["count"]) == 3
    for key, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
        np.testing.assert_allclose(t_opt["mu"][key].numpy(),
                                   np.asarray(j_opt[0].mu[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"mu {key}")


def test_tied_readout_rounds_fp32_masters_to_the_compute_dtype():
    """The reference's ``embedding.T.astype(x.dtype)``: a bf16 x reads
    the bf16-rounded embedding even when the embedding is an fp32
    master, so masters and pre-cast weights give the same logits."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    emb = (0.02 * rng.standard_normal((128, 64))).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    master = ttr.tied_readout(xb, torch.from_numpy(emb))
    cast = ttr.tied_readout(xb, torch.from_numpy(emb).to(torch.bfloat16))
    assert torch.equal(master, cast) and master.dtype == torch.float32
    want = jtr.tied_readout(jnp.asarray(x, jnp.bfloat16), jnp.asarray(emb))
    np.testing.assert_allclose(master.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # An fp32 readout of the unrounded master would differ.
    assert not torch.equal(master, xb.float() @ torch.from_numpy(emb).t())


def test_flash_and_naive_keep_their_own_rounding_chains():
    """Naive rounds the scores to the dtype and divides by sqrt(Dh) in it;
    flash keeps fp32 scores times Dh^-0.5."""
    from kvedge_torch.ops import attention as fa

    rng = np.random.default_rng(12)
    q, k = (torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    flash = fa._scores(q, k)
    assert flash.dtype == torch.float32
    exact = (q.float() @ k.float().transpose(1, 2)) * fa.softmax_scale(32)
    causal = torch.ones(16, 16, dtype=torch.bool).tril()
    assert torch.equal(flash[:, causal], exact[:, causal])
    assert torch.isinf(flash[:, ~causal]).all()
    naive = ttr.scale_scores(q @ k.transpose(1, 2), 32)
    assert naive.dtype == torch.bfloat16
    assert not torch.equal(naive.float()[:, causal], flash[:, causal])


def test_remat_on_and_off_are_bit_identical():
    _, on = _cfgs("flash", remat=True)
    off = dataclasses.replace(on, remat=False)
    tree = ttr.init_params(5, on)
    batch = _batch(6)
    results = []
    for cfg in (on, off):
        params = ttrain.master_params(tree, cfg, "cpu")
        results.append(_grads(params, batch, cfg))
    (loss_on, g_on), (loss_off, g_off) = results
    assert torch.equal(loss_on, loss_off)
    for key in g_on:
        assert torch.equal(g_on[key], g_off[key]), key


def test_flash_and_naive_agree_inside_the_port():
    """The reference's own flash-vs-naive bound (5e-3 on gradients)."""
    _, naive = _cfgs("naive")
    flash = dataclasses.replace(naive, attention="flash")
    tree = ttr.init_params(7, naive)
    batch = _batch(8)
    (l_n, g_n), (l_f, g_f) = (
        _grads(ttrain.master_params(tree, c, "cpu"), batch, c)
        for c in (naive, flash))
    assert abs(float(l_n) - float(l_f)) < 1e-4
    for key in g_n:
        np.testing.assert_allclose(g_f[key].numpy(), g_n[key].numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=key)


def test_config_refuses_what_the_port_does_not_run():
    _, cfg = _cfgs()
    for change, match in [
        (dict(attention="local"), "must be 'naive', 'flash'"),
        (dict(remat_policy="some"), "must be 'full' or 'dots'"),
        (dict(n_experts=-1), "n_experts must be >= 0"),
        (dict(n_experts=4, expert_capacity_factor=0.0), "capacity"),
        (dict(n_experts=4, expert_top_k=3), "top_k"),
        (dict(n_experts=1, expert_top_k=2), "top_k"),
        (dict(pipeline_schedule="1f1b", n_experts=4), "does not support MoE"),
    ]:
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(cfg, **change).validate()
    # fused_xent, remat_policy="dots", MoE, the sequence-parallel
    # attentions and the pipelines are ported: they validate, as in the
    # reference.
    for change in (dict(fused_xent=True), dict(remat_policy="dots"),
                   dict(n_experts=4), dict(n_experts=4, expert_top_k=2),
                   dict(attention="ring"), dict(attention="ulysses"),
                   dict(pipeline_stages=2),
                   dict(pipeline_stages=2, pipeline_schedule="1f1b")):
        dataclasses.replace(cfg, **change).validate()
    # The reference's messages for the values it also refuses.
    for change in (dict(attention="local"), dict(remat_policy="some"),
                   dict(n_experts=-1),
                   dict(n_experts=4, expert_capacity_factor=0.0),
                   dict(n_experts=4, expert_top_k=3),
                   dict(n_experts=1, expert_top_k=2),
                   dict(pipeline_stages=3, n_layers=4),
                   dict(pipeline_schedule="1f1b", n_experts=4)):
        with pytest.raises(ValueError) as theirs:
            dataclasses.replace(jtr.TransformerConfig(), **change).validate()
        with pytest.raises(ValueError) as ours:
            dataclasses.replace(cfg, **change).validate()
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("attention,n_experts", [
    ("naive", 0), ("flash", 0), ("flash", 4)], ids=["naive", "flash",
                                                   "flash-moe"])
def test_dots_remat_equals_full_bitwise_and_matches_reference(attention,
                                                              n_experts):
    """``remat_policy="dots"`` keeps the non-batched products and
    recomputes the rest: the same loss and gradients as ``"full"`` bit
    for bit, and the reference's ``dots`` gradients within 1e-4."""
    moe = dict(n_experts=n_experts, expert_top_k=2,
               expert_capacity_factor=1.0) if n_experts else {}
    jcfg, full = _cfgs(attention)
    jcfg = dataclasses.replace(jcfg, remat_policy="dots", **moe)
    full = dataclasses.replace(full, **moe)
    dots = dataclasses.replace(full, remat_policy="dots")
    jparams, _ = _weights(jcfg, full, seed=3)
    batch = _batch(4, seq=40)
    (l_full, g_full), (l_dots, g_dots) = (
        _grads(ttrain.master_params(
            {k: np.asarray(v) for k, v in jparams.items()}, c, "cpu"),
            batch, c)
        for c in (full, dots))
    assert torch.equal(l_full, l_dots)
    for key in g_full:
        assert torch.equal(g_full[key], g_dots[key]), key
    want_loss, want = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(batch), jcfg)
    np.testing.assert_allclose(float(l_dots), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    for key in g_dots:
        np.testing.assert_allclose(g_dots[key].numpy(),
                                   np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_dots_remat_saves_the_products_and_recomputes_the_rest():
    """The policy's decisions: ``aten.mm`` / ``aten.addmm`` saved, a
    batched product and an elementwise op recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert ttr._dots_policy(None, aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert ttr._dots_policy(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.gelu.default):
        assert ttr._dots_policy(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE


def _tree(cfg, value):
    params = {k: torch.full(s, float(value)) for k, s in
              ttrain.expected_shapes(cfg).items()}
    return {"params": params, "opt_state": ttrain.init_opt_state(params)}


def test_checkpoint_keeps_three_atomic_steps_and_refuses_a_wrong_template(
        tmp_path):
    _, cfg = _cfgs()
    ckpt = StateCheckpointer(str(tmp_path))
    assert ckpt.latest_step() is None
    assert ckpt.directory == os.path.join(str(tmp_path), "checkpoints")
    for step in (2, 4, 6, 8):
        ckpt.save(step, _tree(cfg, step))
    assert ckpt.steps() == [4, 6, 8] and ckpt.latest_step() == 8
    assert sorted(os.listdir(ckpt.directory)) == ["4", "6", "8"]
    for step in ("4", "8"):
        assert sorted(os.listdir(os.path.join(ckpt.directory, step))) == \
            ["opt_state.pt", "params.pt"]
    template = {"params": ttrain.expected_shapes(cfg),
                "opt_state": ttrain.opt_state_template(cfg)}
    step, tree = ckpt.restore_latest(template)
    assert step == 8
    assert float(tree["params"]["w_up"][0, 0, 0]) == 8.0
    assert tree["opt_state"]["count"].dtype == torch.int32
    # A model of another shape or another tree is refused, not loaded.
    wider = dataclasses.replace(cfg, d_ff=256)
    with pytest.raises(ValueError, match="shape mismatch .* 'w_down'"):
        ckpt.restore_latest({"params": ttrain.expected_shapes(wider)},
                            params_only=True)
    with pytest.raises(ValueError, match="tree structure mismatch"):
        ckpt.restore_latest({"params": {"embedding": (128, 64)}},
                            params_only=True)
    other = StateCheckpointer(str(tmp_path), checkpoint_dir=str(
        tmp_path / "elsewhere"))
    assert other.latest_step() is None
    with pytest.raises(ValueError, match="local or mounted"):
        StateCheckpointer(str(tmp_path), checkpoint_dir="gs://bucket/x")


def test_run_training_resumes_bit_for_bit(tmp_path):
    _, cfg = _cfgs("flash", remat=True)
    batches = [_batch(20 + i) for i in range(6)]
    straight = ttrain.run_training(cfg, str(tmp_path / "a"), 6, iter(batches),
                                   checkpoint_every=3, device="cpu")
    first = ttrain.run_training(cfg, str(tmp_path / "b"), 3, iter(batches),
                                checkpoint_every=3, device="cpu")
    seen = []
    second = ttrain.run_training(cfg, str(tmp_path / "b"), 6,
                                 iter(batches[3:]), checkpoint_every=3,
                                 device="cpu",
                                 on_step=lambda s, l: seen.append(s))
    assert straight.resumed_from is None and second.resumed_from == 3
    assert second.step == 6 and seen == [4, 5, 6]
    assert first.losses + second.losses == straight.losses
    for key, p in straight.params.items():
        assert torch.equal(p, second.params[key]), key
    # A run whose target was already reached returns at once.
    again = ttrain.run_training(cfg, str(tmp_path / "b"), 6, iter([]),
                                device="cpu")
    assert again.losses == [] and again.resumed_from == 6
