"""Seeded nucleus sampling with the JAX key schedule, in torch integer ops.

The same ``(seed, temperature, top_p)`` request must give the same
tokens on both backends, so the port carries its own copy of the
reference's key schedule and of the random draws under it:

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``'s raw key data,
  ``[0, seed mod 2**32]`` (32-bit mode, the reference's setting).
* ``fold_in(key, d)`` is threefry-2x32 of the counter pair ``(0, d)``.
* ``random_bits`` follows the partitionable threefry layout
  (``jax_threefry_partitionable``, on by default since jax 0.5): element
  i hashes the counter pair ``(i >> 32, i & 0xffffffff)`` and the 32
  output bits are the XOR of the two hash words.
* ``uniform`` -> ``gumbel`` -> ``categorical`` are ``jax.random``'s
  float32 constructions (mantissa fill, ``-log(-log(u))`` on
  ``[tiny, 1)``, argmax of noise + logits).

uint32 arithmetic runs in int64 tensors masked with ``& 0xffffffff``.
The serving schedule on top: row r of a request samples with key
``fold_in(PRNGKey(seed), r)``; its token t with ``fold_in(row_key, t)``,
t = 0 at the prefill pick and ``len(generated) + 1`` in decode.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.PRNGKey(seed)``: uint32 ``[2]``."""
    return np.asarray([0, int(seed) & _MASK], np.uint32)


def as_key_tensor(key, device=None) -> torch.Tensor:
    """Raw uint32 key data (numpy, list or tensor, ``[..., 2]``) as the
    int64 tensor the hash works on."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64) & _MASK
    arr = np.asarray(key)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must have trailing dim 2, got {arr.shape}")
    return torch.as_tensor(arr.astype(np.uint32).astype(np.int64),
                           device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x0, x1)`` under
    key ``(k0, k1)``; every argument an int64 tensor of uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on raw key data ``[..., 2]`` and integer
    ``data`` (a Python int or a tensor broadcastable to the key's
    leading dims)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & _MASK)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable layout) for
    each key of ``key [..., 2]``: ``[..., n]`` int64."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          counts >> 32, counts & _MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    bits = random_bits(key, n)
    float_bits = (bits >> 9) | 0x3F800000  # mantissa fill, exponent of 1.0
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (the default "low" mode)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, n, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical``: one draw per row of ``logits [..., V]``
    with the row's key ``[..., 2]`` (Gumbel max)."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits, dim=-1)


def nucleus_filter(logits: torch.Tensor, temperature, top_p) -> torch.Tensor:
    """Temperature scaling plus the top-p filter on fp32 ``[..., V]``.

    Sorted descending, a rank is kept while the mass BEFORE it is below
    ``top_p`` (the top rank always survives); tokens under the kept
    ranks' smallest logit get ``-inf``."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    scaled = logits / torch.clamp_min(temperature, 1e-6)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep = (cumulative - probs) < top_p
    inf = torch.tensor(float("inf"), device=logits.device)
    threshold = torch.where(keep, sorted_logits, inf).amin(dim=-1,
                                                           keepdim=True)
    return torch.where(scaled >= threshold, scaled, -inf)


def sample_token(logits: torch.Tensor, keys: torch.Tensor, temperature,
                 top_p) -> torch.Tensor:
    """One sampled token id per row: logits ``[B, V]`` fp32, ``keys``
    ``[B, 2]`` (one stream per row), ``temperature``/``top_p``
    broadcastable to ``[B, 1]``. Returns int64 ``[B]``."""
    return categorical(keys, nucleus_filter(logits, temperature, top_p))


def row_sample_keys(seed_keys: torch.Tensor, step) -> torch.Tensor:
    """Token ``step`` of each row samples with ``fold_in(row_key, step)``."""
    return fold_in(seed_keys, step)
