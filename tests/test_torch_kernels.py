"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, plus the invariants the
reference proves of itself, held inside the port.

Tolerances: phases rtol = atol = 2e-4 at 50 steps (the reference's own
kernel-vs-oracle bound); energies of +-1 spins on integer couplings exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import cobi_dynamics as jcobi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ising_energy import ising_energy_pallas
from repro_torch.kernels import cobi_dynamics as tcobi
from repro_torch.kernels import ising_energy as tenergy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.interop import carry_across

WRAPPERS = (
    tcobi.cobi_trajectory_cuda, tcobi.cobi_readout_cuda,
    tcobi.cobi_fused_best_cuda, tenergy.ising_energy_cuda,
    tcobi.cobi_trajectory_batched_cuda, tcobi.cobi_fused_best_batched_cuda,
    tenergy.ising_energy_batched_cuda,
)


def _instance(seed, n):
    """Chip-range integer instance (h, J) as numpy float32."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-14, 15, n).astype(np.float32)
    j = np.triu(rng.integers(-14, 15, (n, n)), 1).astype(np.float32)
    return h, j + j.T


def _pad(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, d) for d in x.shape)] = x
    return out


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


@pytest.mark.parametrize("n", [16, 59, 128])
@pytest.mark.parametrize("r", [8, 33])
def test_cobi_trajectory_matches_pallas(n, r):
    h, j = _instance(n * 1000 + r, n)
    scale = float(jops.dynamics_scale(jnp.asarray(h), jnp.asarray(j)))
    assert float(tops.dynamics_scale(*_t(h, j))) == scale
    n_pad, r_pad = 128, ((r + 7) // 8) * 8
    jp = _pad(j / np.float32(scale), (n_pad, n_pad))
    hp = _pad((h / np.float32(scale))[None], (1, n_pad))
    phi0 = np.asarray(jax.random.uniform(jax.random.key(r), (r_pad, n_pad),
                                         minval=0.0, maxval=2 * jnp.pi))
    want = jcobi.cobi_trajectory_pallas(
        jnp.asarray(jp), jnp.asarray(hp), jnp.asarray(phi0), steps=50, dt=0.3,
        ks_max=1.0, replica_block=8, interpret=True,
    )
    got = tcobi.cobi_trajectory_cuda(*_t(jp, hp, phi0), steps=50, dt=0.3, ks_max=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,r", [(8, 4), (59, 33), (128, 256), (200, 17)])
def test_ising_energy_matches_exactly(n, r):
    h, j = _instance(n + r, n)
    spins = np.where(np.random.default_rng(r).random((r, n)) < 0.5, 1, -1).astype(np.int8)
    want = np.asarray(jops.ising_energy(jnp.asarray(spins), jnp.asarray(h), jnp.asarray(j)))
    got = tops.ising_energy(*_t(spins, h, j))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.ising_energy(*_t(spins[0], h, j)).numpy(), want[0]
    )


def test_ising_energy_wrapper_matches_pallas_tile():
    """The wrapper on exact tile shapes (no padding) against the kernel."""
    n, r = 128, 64
    h, j = _instance(0, n)
    spins = np.where(np.random.default_rng(1).random((r, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    want = ising_energy_pallas(jnp.asarray(spins), jnp.asarray(h[None]), jnp.asarray(j),
                               replica_block=32, interpret=True)
    got = tenergy.ising_energy_cuda(*_t(spins, h[None], j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_best_epilogue_matches_reference_oracle():
    """Same phases in, same first-argmin energies and rows out, exactly --
    including a tie between replicas (duplicated rows) and masked slots."""
    n, r, b, s = 40, 24, 2, 3
    rng = np.random.default_rng(5)
    phi = rng.uniform(0, 2 * np.pi, (b, r, n)).astype(np.float32)
    phi[:, 7] = phi[:, 3]  # a tie: the earlier replica must win
    hs, js = zip(*(_instance(10 + i, n) for i in range(b)))
    h, j = np.stack(hs), np.stack(js)
    mask = np.zeros((b, n, s), np.float32)
    mask[:, :20, 0] = mask[:, 20:, 1] = 1.0
    reads = np.array([[24, 10, 0], [5, 24, 0]], np.float32)
    want_e, want_s = jref.ref_cobi_fused_best(*(jnp.asarray(a) for a in (phi, j, h, mask, reads)))
    got_e, got_s = tref.ref_cobi_fused_best(*_t(phi, j, h, mask, reads))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _anneal_pair(n, r, seed=0):
    h, j = _instance(seed * 31 + n, n)
    key = carry_across("key", np.asarray(jax.random.key_data(jax.random.key(n + r))))
    return (*_t(h, j), key)


@pytest.mark.parametrize("n,r", [(16, 8), (59, 10), (40, 24), (128, 16)])
def test_anneal_best_equals_none_plus_first_argmin(n, r):
    """reduce='best' == reduce='none' + first argmin, bit for bit."""
    h, j, key = _anneal_pair(n, r)
    spins, energies = tops.cobi_anneal(h, j, key, replicas=r, steps=80)
    assert spins.shape == (r, n) and spins.dtype == torch.int8
    i = int(np.argmin(energies.numpy()))
    best_s, best_e = tops.cobi_anneal(h, j, key, replicas=r, steps=80, reduce="best")
    assert best_s.shape == (n,) and best_s.dtype == torch.int8
    np.testing.assert_array_equal(best_s.numpy(), spins[i].numpy())
    assert float(best_e) == float(energies[i])


@pytest.mark.parametrize("k", [1, 3, 8, None])
def test_topk_is_sorted_prefix_of_full_readout(k):
    h, j, key = _anneal_pair(45, 8)
    _, energies = tops.cobi_anneal(h, j, key, replicas=8, steps=80)
    top_s, top_e = tops.cobi_anneal(h, j, key, replicas=8, steps=80, reduce="topk", topk=k)
    kk = 8 if k is None else k
    assert top_s.shape == (kk, 45)
    np.testing.assert_array_equal(top_e.numpy(), np.sort(energies.numpy(), kind="stable")[:kk])
    np.testing.assert_array_equal(tops.ising_energy(top_s, h, j).numpy(), top_e.numpy())


def test_topk_ties_keep_replica_order():
    """Stable sort: equal energies come back in replica order."""
    h, j, key = _anneal_pair(12, 16)
    spins, energies = tops.cobi_anneal(h, j, key, replicas=16, steps=200)
    top_s, top_e = tops.cobi_anneal(h, j, key, replicas=16, steps=200, reduce="topk")
    order = np.argsort(energies.numpy(), kind="stable")
    np.testing.assert_array_equal(top_s.numpy(), spins.numpy()[order])


def test_anneal_starts_from_reference_phases_and_improves():
    """phi0 is the reference's bit for bit, and annealing beats random spins."""
    h, j, key = _anneal_pair(24, 16)
    jkey = jax.random.key(24 + 16)
    want = jax.random.uniform(jkey, (16, 128), jnp.float32, 0.0, 2.0 * jnp.pi)
    from repro_torch import prng

    phi0 = prng.uniform(key, (16, 128), 0.0, 2 * np.pi, device="cpu")
    np.testing.assert_array_equal(phi0.numpy(), np.asarray(want))
    _, energies = tops.cobi_anneal(h, j, key, replicas=16, steps=200)
    rand = np.where(np.random.default_rng(0).random((256, 24)) < 0.5, 1.0, -1.0)
    e_rand = tref.ref_ising_energy(*_t(rand.astype(np.float32)), h, j).numpy()
    assert float(energies.min()) < e_rand.mean() - 2 * e_rand.std()


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    before = [w.launches for w in WRAPPERS]
    h, j, key = _anneal_pair(20, 8)
    for reduce in ("none", "best", "topk"):
        tops.cobi_anneal(h, j, key, replicas=8, steps=20, reduce=reduce)
    for reduce in ("none", "best"):
        tops.cobi_anneal_batch(h[None], j[None], key, replicas=8, steps=20, reduce=reduce)
    assert [w.launches for w in WRAPPERS] == before
    with pytest.raises(ValueError, match="reduce"):
        tops.cobi_anneal(h, j, key, replicas=8, steps=20, reduce="all")


def test_library_builds_once_when_two_threads_ask_at_once(monkeypatch, tmp_path):
    """The farm's drive thread and the caller may both make the first
    launch: one build, one loaded library, for both."""
    import threading
    import time

    from repro_torch.kernels import _build

    builds = []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.2)  # both threads are inside library() by now
        return {name: tmp_path / f"{name}.so" for name in names}

    class FakeLib:
        def __getattr__(self, fn):
            entry = type("Entry", (), {})()
            object.__setattr__(self, fn, entry)
            return entry

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library("cobi_dynamics")))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert builds == [("cobi_dynamics",)]
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].cobi_fused_best.argtypes == _build._ARGTYPES["cobi_dynamics"]["cobi_fused_best"]
