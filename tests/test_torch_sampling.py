"""paddle_tpu_torch.serving.sampling against jax.random.

The serving contract keys the token after position p of a request by
``fold_in(PRNGKey(seed), p)`` and draws it with
``jax.random.categorical``. Keys and random bits must match bit for bit.
The Gumbel noise ``-log(-log(u))`` matches at atol = rtol = 1e-6: the
uniforms are bitwise equal, but XLA's CPU ``log`` and torch's may differ
in the last ulp, and the noise crosses 0, where only an absolute bound
means anything. The sampled indices must then be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import sampling as S

SEEDS = [0, 1, -1, 2**31 - 1, Request(prompt=[1], seed=2**31).seed, 12345]
POSITIONS = np.arange(4097, dtype=np.int32)


def _jax_keys(seed):
    """The engine's expression: int32 seed, int32 position, vmapped."""
    def one(p):
        return jax.random.fold_in(jax.random.PRNGKey(jnp.int32(seed)), p)
    return np.asarray(jax.vmap(one)(jnp.asarray(POSITIONS))).astype(np.int64)


def test_canonical_seed_is_int32():
    assert Request(prompt=[1], seed=2**31).seed == -2**31
    assert Request(prompt=[1], seed=2**32 + 5).seed == 5


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_keys_bit_identical(seed):
    want = _jax_keys(seed)
    got = S.fold_in(S.prng_key(torch.full((POSITIONS.size,), seed)),
                    torch.from_numpy(POSITIONS)).numpy()
    np.testing.assert_array_equal(got, want)


def test_prng_key_bit_identical():
    for seed in SEEDS:
        want = np.asarray(jax.random.PRNGKey(jnp.int32(seed))).astype(np.int64)
        np.testing.assert_array_equal(S.prng_key(torch.tensor(seed)).numpy(),
                                      want)


def test_uniform_bits_and_gumbel_noise():
    key_j = jax.random.fold_in(jax.random.PRNGKey(jnp.int32(7)), 33)
    key_t = S.fold_in(S.prng_key(torch.tensor(7)), torch.tensor(33))
    n = 1000
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u_j = np.asarray(jax.random.uniform(key_j, (n,), jnp.float32,
                                        minval=tiny, maxval=1.0))
    bits = (S.random_bits(key_t, n) >> 9) | 0x3F800000
    u_t = torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0
                          + tiny, tiny).numpy()
    np.testing.assert_array_equal(u_t, u_j)
    g_j = np.asarray(jax.random.gumbel(key_j, (n,), jnp.float32))
    np.testing.assert_allclose(S.gumbel(key_t, n).numpy(), g_j,
                               atol=1e-6, rtol=1e-6)


def test_categorical_same_index():
    rng = np.random.default_rng(0)
    hits = 0
    for i in range(40):
        logits = (rng.standard_normal(512) * 2).astype(np.float32)
        seed, pos = int(rng.integers(-2**31, 2**31)), int(rng.integers(0, 4096))
        key_j = jax.random.fold_in(jax.random.PRNGKey(jnp.int32(seed)), pos)
        want = int(jax.random.categorical(key_j, jnp.asarray(logits)))
        key_t = S.fold_in(S.prng_key(torch.tensor(seed)), torch.tensor(pos))
        got = int(S.categorical(key_t, torch.from_numpy(logits)))
        assert got == want, (i, seed, pos)
        hits += want != int(np.argmax(logits))
    assert hits > 10  # the draws really sample, not argmax


def test_sample_matches_engine_expression():
    """``sample`` against the JAX engine's batched draw (greedy where the
    temperature is 0, else categorical of logits / max(t, 1e-6))."""
    rng = np.random.default_rng(1)
    lv = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.0, 0.0, 1e-9, 2.5], np.float32)
    seeds = np.array([0, 5, -1, 9, 3, 2**31 - 1], np.int32)
    pos = np.array([0, 17, 4096, 3, 8, 100], np.int32)

    def one_row(seed_i, pos_i, row):
        key = jax.random.fold_in(jax.random.PRNGKey(seed_i), pos_i)
        return jax.random.categorical(key, row)

    t = jnp.maximum(jnp.asarray(temps), 1e-6)
    sampled = jax.vmap(one_row)(jnp.asarray(seeds), jnp.asarray(pos),
                                jnp.asarray(lv) / t[:, None])
    want = np.asarray(jnp.where(jnp.asarray(temps) > 0, sampled,
                                jnp.argmax(jnp.asarray(lv), axis=-1)))
    got = S.sample(torch.from_numpy(lv), temps, seeds, pos).numpy()
    np.testing.assert_array_equal(got, want)
