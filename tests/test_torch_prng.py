"""repro_torch.prng against jax.random: every draw bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro_torch import prng
from repro_torch.interop import carry_across


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, -1, 2**32 + 5])
def test_key_matches(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(), _words(jax.random.key(seed)))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches(num):
    k = jax.random.key(11)
    np.testing.assert_array_equal(
        prng.split(prng.key(11), num).numpy(), _words(jax.random.split(k, num))
    )


def test_split_chains_match():
    """The pipeline's per-iteration chain: key, kq, ks = split(key, 3)."""
    jk, tk = jax.random.key(3), prng.key(3)
    for _ in range(6):
        jk, jq, js = jax.random.split(jk, 3)
        tk, tq, ts = prng.split(tk, 3)
        for a, b in ((jk, tk), (jq, tq), (js, ts)):
            np.testing.assert_array_equal(b.numpy(), _words(a))


@pytest.mark.parametrize("shape", [(1,), (5,), (7, 3), (2, 3, 4), (128,)])
def test_bits_match(shape):
    k = jax.random.key(5)
    want = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.bits(prng.key(5), shape, device="cpu").numpy(), want)


@pytest.mark.parametrize("shape", [(18,), (18, 18), (59, 59)])
def test_uniform_unit_matches(shape):
    """The rounding draws: uniform(key, shape) on [0, 1)."""
    for seed in range(3):
        k = jax.random.key(seed)
        got = prng.uniform(carry_across("key", _words(k)), shape, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("r_pad,n_pad", [(8, 128), (40, 128), (1024, 128), (16, 256)])
def test_uniform_phi0_matches(r_pad, n_pad):
    """The initial phases of an anneal: uniform(key, (r_pad, n_pad), 0, 2 pi)."""
    k = jax.random.split(jax.random.key(r_pad + n_pad))[1]
    want = jax.random.uniform(k, (r_pad, n_pad), jnp.float32, 0.0, 2.0 * jnp.pi)
    got = prng.uniform(carry_across("key", _words(k)), (r_pad, n_pad), 0.0, 2.0 * np.pi,
                       device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_key_interop_rejects_bad_shape():
    with pytest.raises(ValueError):
        carry_across("key", np.zeros(3, np.uint32))


@pytest.mark.parametrize("k,shape", [(1, (8, 128)), (5, (16, 128)), (64, (3, 7))])
def test_uniform_many_matches_vmapped_uniform(k, shape):
    """The farm's per-job phases: jax.vmap(jax.random.uniform) over a stack
    of keys, one hash over (K, size)."""
    keys = jax.random.split(jax.random.key(k), k)
    want = jax.vmap(lambda x: jax.random.uniform(x, shape, jnp.float32, 0.0, 2.0 * jnp.pi))(keys)
    words = torch.tensor(np.asarray(jax.random.key_data(keys)).astype(np.int64))
    got = prng.uniform_many(words, shape, 0.0, 2.0 * np.pi, device="cpu")
    assert got.shape == (k, *shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match=r"\(K, 2\)"):
        prng.uniform_many(words[:, :1], shape, device="cpu")
