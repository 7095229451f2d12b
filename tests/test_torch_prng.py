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


def _tkey(k):
    return carry_across("key", _words(k))


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


# ------------------------------------------------- fold_in, randint, bernoulli,
# permutation (bit for bit) and normal (within 2 ulp)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_fold_in_matches(seed):
    """The serving engine's per-request keys: fold_in(key(seed), request_id)."""
    for data in (0, 1, 2, 17, 1000, 2**31, 2**32 - 1):
        want = _words(jax.random.fold_in(jax.random.key(seed), data))
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 20), (0, 7), (3, 100), (-5, 5), (0, 1),
                                   (5, 5), (9, 2), (0, 65537), (0, 2**31 - 1),
                                   (-(2**31), 2**31 - 1)])
def test_randint_matches(lo, hi):
    """Spans that are and are not powers of 2, empty spans, and the full
    int32 range (where 2**32 mod span wraps)."""
    for seed, shape in ((0, (8,)), (1, (3, 5)), (2, (1,)), (3, (200,))):
        k = jax.random.key(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = prng.randint(_tkey(k), shape, lo, hi, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_many_matches_vmapped_randint():
    """SA's per-step picks: one pass over a stack of keys."""
    keys = jax.random.split(jax.random.key(4), 9)
    want = jax.vmap(lambda k: jax.random.randint(k, (8,), 0, 20))(keys)
    got = prng.randint_many(_words(keys), (8,), 0, 20, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_chain_matches_a_carried_key():
    """key, k_pick, k_acc = split(key, 3), carried over steps."""
    jk = jax.random.key(9)
    chain = prng.split_chain(prng.key(9), 12, 3)
    for t in range(12):
        jk, jp, ja = jax.random.split(jk, 3)
        np.testing.assert_array_equal(chain[t], np.stack([_words(jp), _words(ja)]))


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
def test_bernoulli_matches(p):
    for seed, shape in ((0, (8, 20)), (1, (32, 100)), (5, (3,))):
        k = jax.random.key(seed)
        want = np.asarray(jax.random.bernoulli(k, p, shape))
        np.testing.assert_array_equal(prng.bernoulli(_tkey(k), p, shape, device="cpu").numpy(),
                                      want)


def test_permutation_matches_for_n_1_to_200():
    """Every n up to 16, then sizes across the range to 200 (each n is a
    fresh compile of the reference's permutation, ~0.3 s)."""
    for n in [*range(1, 17), 31, 32, 33, 59, 64, 100, 127, 128, 129, 150, 199, 200]:
        k = jax.random.key(1000 + n)
        want = np.asarray(jax.random.permutation(k, n))
        np.testing.assert_array_equal(prng.permutation(_tkey(k), n, device="cpu").numpy(), want)


def test_permutation_many_matches_vmapped_permutation():
    keys = jax.random.split(jax.random.key(2), 7)
    want = jax.vmap(lambda k: jax.random.permutation(k, 23))(keys)
    np.testing.assert_array_equal(prng.permutation_many(_words(keys), 23, device="cpu").numpy(),
                                  np.asarray(want))


def test_normal_within_2_ulp():
    """XLA's erf_inv, ported with XLA's log1p: erf_inv and normal (its value
    times sqrt(2)) within 2 ulp of the reference on 200k draws, and fewer than
    one draw in ten thousand differs at all; +-1 maps to +-finfo.max."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    k = jax.random.key(3)
    u = np.array(jax.random.uniform(k, (200_000,), jnp.float32, lo, 1.0))
    d = _ulps(prng.erf_inv(torch.from_numpy(u)).numpy(), np.asarray(jax.lax.erf_inv(u)))
    assert d.max() <= 2 and (d > 0).mean() < 1e-4
    keys = jax.random.split(k, 200)
    want = np.asarray(jax.vmap(lambda x: jax.random.normal(x, (1000,)))(keys))
    got = np.stack([prng.normal(_tkey(x), (1000,), device="cpu").numpy() for x in keys])
    d = _ulps(got, want)
    assert got.dtype == np.float32 and d.max() <= 2 and (d > 0).mean() < 1e-4
    assert prng.erf_inv(torch.tensor([1.0, -1.0])).tolist() == [np.finfo(np.float32).max,
                                                               -np.finfo(np.float32).max]


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 20), (2, 59)])
def test_synthetic_generators_match_reference(seed, n):
    """synthetic_embeddings, synthetic_benchmark and benchmark_suite on the
    ported draws: within rtol 1e-5 (atol 1e-6 for entries near 0), the gap
    of normal's ulps and of scores_from_embeddings' matmul order."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn

    want = np.asarray(jsyn.synthetic_embeddings(jax.random.key(seed), n))
    got = tsyn.synthetic_embeddings(prng.key(seed), n, device="cpu")
    assert got.shape == (n, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for jp, tp in zip(jsyn.benchmark_suite(2, n, 4, lam=0.5, seed0=seed),
                      tsyn.benchmark_suite(2, n, 4, lam=0.5, seed0=seed, device="cpu")):
        assert (tp.m, tp.lam) == (jp.m, jp.lam)
        np.testing.assert_allclose(tp.mu.numpy(), np.asarray(jp.mu), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tp.beta.numpy(), np.asarray(jp.beta), rtol=1e-5, atol=1e-6)
