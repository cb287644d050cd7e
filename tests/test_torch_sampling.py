"""The port's sampling key schedule and draws against ``jax.random``.

Key data (``PRNGKey``, ``fold_in``, the serving rows' keys) and the raw
draws (random bits, uniform floats) must be equal BIT FOR BIT — they are
integer and exact-float constructions. The Gumbel noise goes through
``log`` twice, whose implementations differ in the last ulp between the
frameworks, so the tokens are compared instead: the same token for the
same logits, key, temperature and top_p over a grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import decode as jdecode
from kvedge_torch.models import sampling as S
from kvedge_torch.runtime.serve import row_key_data

torch.set_num_threads(2)

SEEDS = [0, 1, 7, -1, 2**31 - 1, 2**33 + 5, 123456789]


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_threefry_partitionable_is_the_default_being_matched():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_exact(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(S.prng_key(seed), want)
    key = S.as_key_tensor(S.prng_key(seed))
    for data in (0, 1, 5, 2**31 + 7, 2**32 - 1):
        np.testing.assert_array_equal(
            _u32(S.fold_in(key, data)),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_serving_row_keys_and_step_keys_bit_exact(seed):
    """Row r's key is fold_in(PRNGKey(seed), r); token t of the row uses
    fold_in(row_key, t) — batched over rows as the server does."""
    base = jax.random.PRNGKey(seed)
    rows = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(5))
    got_rows = np.stack([row_key_data(seed, r) for r in range(5)])
    np.testing.assert_array_equal(got_rows, np.asarray(rows))
    steps = jnp.asarray([0, 1, 2, 63, 1000])
    want = jax.vmap(jax.random.fold_in)(rows, steps)
    got = S.fold_in(S.as_key_tensor(got_rows), torch.tensor(steps.tolist()))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    np.testing.assert_array_equal(
        _u32(S.row_sample_keys(S.as_key_tensor(got_rows), 3)),
        np.asarray(jdecode.row_sample_keys(rows, 3)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_random_bits_and_uniform_bit_exact(seed):
    key = S.as_key_tensor(S.prng_key(seed))
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(S.random_bits(key, 1001)),
                                  np.asarray(jax.random.bits(jkey, (1001,))))
    np.testing.assert_array_equal(
        S.uniform(key, 1001).numpy(),
        np.asarray(jax.random.uniform(jkey, (1001,))))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        S.uniform(key, 513, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(jkey, (513,), jnp.float32, tiny, 1.0)))
    # Gumbel: two logs, equal to the last ulp or two.
    np.testing.assert_allclose(S.gumbel(key, 1001).numpy(),
                               np.asarray(jax.random.gumbel(jkey, (1001,))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_p",
                         [(0.7, 0.9), (1.0, 1.0), (1.5, 0.5), (0.3, 0.95),
                          (2.0, 0.99), (1e-9, 0.8)])
def test_nucleus_filter_and_sample_token_pick_the_same_tokens(temperature,
                                                              top_p):
    rng = np.random.default_rng(int(temperature * 100 + top_p * 10))
    for seed in range(8):
        logits = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
        base = jax.random.PRNGKey(seed)
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(4))
        want = jdecode.sample_token(jnp.asarray(logits), keys,
                                    jnp.float32(temperature),
                                    jnp.float32(top_p))
        got = S.sample_token(torch.from_numpy(logits),
                             S.as_key_tensor(np.asarray(keys)),
                             temperature, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if top_p < 1.0:
            # The kept set (finite logits) matches too; at top_p = 1 the
            # last ulp of the running mass decides the tail's fate.
            fj = np.asarray(jdecode.nucleus_filter(
                jnp.asarray(logits), jnp.float32(temperature),
                jnp.float32(top_p)))
            ft = S.nucleus_filter(torch.from_numpy(logits), temperature,
                                  top_p).numpy()
            np.testing.assert_array_equal(np.isfinite(ft), np.isfinite(fj))


def test_top_p_keeps_at_least_the_top_token():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    out = S.nucleus_filter(logits, 1.0, 1e-6)
    assert torch.isfinite(out).tolist() == [[False, True, False]]
    key = S.as_key_tensor(S.prng_key(0))[None]
    assert S.sample_token(logits, key, 1.0, 1e-6).tolist() == [1]
