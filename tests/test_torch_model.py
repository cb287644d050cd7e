"""The port's decoder (kvedge_torch.models.transformer) against the JAX
reference on the same weights and inputs.

Inputs are made with numpy from a seed and handed to both; JAX weights
cross through the port's weight bridge. Tolerances: fp32 at
rtol=atol=1e-4 (the two frameworks sum in different orders and their
exp/tanh/rsqrt differ in the last ulp) with identical argmax; bf16 at
rtol=atol=3e-2 (XLA and torch round bf16 elementwise chains at
different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_torch.models import transformer as ttr
from kvedge_torch.models.config import PRESETS as TORCH_PRESETS
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(n_kv_heads, dtype):
    jcfg = jtr.TransformerConfig(
        vocab=256, d_model=64, n_heads=4, n_kv_heads=n_kv_heads, n_layers=2,
        d_ff=128, max_seq=64, dtype=dtype, remat=False)
    tcfg = TransformerConfig(
        vocab=256, d_model=64, n_heads=4, n_kv_heads=n_kv_heads, n_layers=2,
        d_ff=128, max_seq=64, dtype=dtype)
    return jcfg, tcfg


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    err = float(np.max(np.abs(got - want)))
    print(f"{what} [{dtype}] max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2
    gain = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jtr._rmsnorm(jnp.asarray(x, JDT[dtype]), jnp.asarray(gain))
    got = ttr._rmsnorm(torch.from_numpy(x).to(TDT[dtype]),
                       torch.from_numpy(gain))
    _assert_close(got, want, dtype, "rmsnorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_matches_reference_shared_and_per_row(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7)
    want = jtr._rotary(jnp.asarray(x, JDT[dtype]), jnp.asarray(pos))
    got = ttr._rotary(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(pos))
    _assert_close(got, want, dtype, "rotary shared")
    # Decode rows each at their own position (the reference vmaps).
    rows = np.asarray([[5], [1030]], np.int32)
    xr = x[:, :1]
    want = jax.vmap(lambda t, p: jtr._rotary(t[None], p)[0])(
        jnp.asarray(xr, JDT[dtype]), jnp.asarray(rows))
    got = ttr._rotary(torch.from_numpy(xr).to(TDT[dtype]),
                      torch.from_numpy(rows))
    _assert_close(got, want, dtype, "rotary per-row")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_tanh_approximation(dtype):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x, JDT[dtype]))
    got = ttr.gelu(torch.from_numpy(x).to(TDT[dtype]))
    _assert_close(got, want, dtype, "gelu")
    # The erf form differs from the tanh form by more than fp32 noise.
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - ttr.gelu(torch.from_numpy(x))).abs().max()) > 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_readout_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    emb = (0.02 * rng.standard_normal((256, 64))).astype(np.float32)
    want = jtr.tied_readout(jnp.asarray(x, JDT[dtype]), jnp.asarray(emb))
    got = ttr.tied_readout(torch.from_numpy(x).to(TDT[dtype]),
                           torch.from_numpy(emb).to(TDT[dtype]))
    assert got.dtype == torch.float32
    _assert_close(got, want, dtype, "readout")


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype, n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads, dtype)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (2, 24))
    want = jtr.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    got = ttr.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    _assert_close(got, want, dtype, "forward logits")
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(want, -1)))


def test_init_params_layout_matches_reference():
    """The numpy init keeps the reference's keys, shapes and scales."""
    jcfg, tcfg = _cfgs(2, "float32")
    want = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    got = ttr.init_params(7, tcfg)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(np.std(got[key]), np.std(want[key]),
                                   rtol=0.2, err_msg=key)
    assert sum(v.size for v in got.values()) == tcfg.param_count
    # Same seed, same weights; another seed, other weights.
    again = ttr.init_params(7, tcfg)
    other = ttr.init_params(8, tcfg)
    np.testing.assert_array_equal(again["w_qkv"], got["w_qkv"])
    assert not np.array_equal(other["w_qkv"], got["w_qkv"])


def test_presets_and_config_match_reference():
    assert TORCH_PRESETS == jtr.PRESETS
    flag = TransformerConfig(**TORCH_PRESETS["flagship"])
    jflag = jtr.TransformerConfig(**jtr.PRESETS["flagship"])
    assert flag.param_count == jflag.param_count
    assert (flag.d_head, flag.kv_heads) == (jflag.d_head, jflag.kv_heads)
    with pytest.raises(ValueError):
        dataclasses.replace(flag, n_kv_heads=3).validate()
    with pytest.raises(ValueError):
        dataclasses.replace(flag, paged_attention="flash").validate()


def test_weight_bridge_refuses_wrong_trees():
    _, tcfg = _cfgs(2, "float32")
    tree = ttr.init_params(0, tcfg)
    bad = dict(tree, w_qkv=tree["w_qkv"][:, :, :-1])
    with pytest.raises(ValueError, match="w_qkv"):
        params_from_numpy(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(dict(tree, router=tree["w_up"]), tcfg, "cpu")
    # One cast at load gives the bits of the reference's per-use cast.
    bf = params_from_numpy(tree, dataclasses.replace(tcfg, dtype="bfloat16"),
                           "cpu")
    want = np.asarray(jnp.asarray(tree["w_up"]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(bf["w_up"].float().numpy(), want)
