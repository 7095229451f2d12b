"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, plus the invariants the
reference proves of itself, held inside the port.

Tolerances: phases rtol = atol = 2e-4 at 50 steps (the reference's own
kernel-vs-oracle bound); energies of +-1 spins on integer couplings exact.
The CUDA kernels run only on the card: the ``cuda`` tests hold the anneal
loop against its plain version there and skip elsewhere; on the card, with
no JAX installed, run them alone:
``PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import cobi_dynamics as jcobi
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.ising_energy import ising_energy_pallas
except ModuleNotFoundError:  # a machine with a card but no JAX runs only the cuda tests
    jax = jnp = jcobi = jops = jref = ising_energy_pallas = None
from repro_torch import prng as tprng
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


def _loop_instance(seed, n, symmetric=True, zero=None):
    """Chip-range integer instance whose live extent (1 + the largest index
    of a nonzero coupling) is exactly n; optionally non-symmetric, or with
    row and column ``zero`` all zero inside it."""
    rng = np.random.default_rng(seed)
    j = rng.integers(-14, 15, (n, n)).astype(np.float32)
    if symmetric:
        j = np.triu(j, 1)
        j = j + j.T
    j[0, n - 1] = j[n - 1, 0] = 5.0
    if zero is not None:
        j[zero, :] = j[:, zero] = 0.0
    return rng.integers(-14, 15, n).astype(np.float32), j


LOOP_CASES = {  # the anneal loop's live-extent cases, on 128 lanes
    "extent4": dict(n=4), "extent33": dict(n=33), "extent127": dict(n=127),
    "zero_row_col": dict(n=40, zero=17), "non_symmetric": dict(n=60, symmetric=False),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_cobi_trajectory_loop_cases_match_pallas(case):
    """The plain trajectory against the Pallas kernel on the instances the
    CUDA loop's live extent cuts differently: tiny and near-full extents, a
    zero row and column inside n, a non-symmetric J."""
    h, j = _loop_instance(len(case), **LOOP_CASES[case])
    scale = float(jops.dynamics_scale(jnp.asarray(h), jnp.asarray(j)))
    jp = _pad(j / np.float32(scale), (128, 128))
    hp = _pad((h / np.float32(scale))[None], (1, 128))
    phi0 = np.asarray(jax.random.uniform(jax.random.key(7), (8, 128), minval=0.0,
                                         maxval=2 * jnp.pi))
    want = jcobi.cobi_trajectory_pallas(
        jnp.asarray(jp), jnp.asarray(hp), jnp.asarray(phi0), steps=50, dt=0.35,
        ks_max=1.2, replica_block=8, interpret=True,
    )
    got = tcobi.cobi_trajectory_cuda(*_t(jp, hp, phi0), steps=50, dt=0.35, ks_max=1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: torch.cuda.is_available() is False (no GPU or a CPU-only torch)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_anneal_loop_matches_plain_on_card(card, case):
    """On the card: the trajectory kernel within 2e-4 of its plain version
    at 50 steps, and fused best == readout + first argmin bit for bit."""
    h, j = _loop_instance(len(case), **LOOP_CASES[case])
    op = tops.anneal_operands(*(x.to(card) for x in _t(h, j)), tprng.key(3), replicas=8)
    kw = dict(steps=50, dt=0.35, ks_max=1.2)
    got = tcobi.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **kw)
    want = tcobi.cobi_trajectory_plain(op.j_scaled, op.h_scaled, op.phi0, **kw)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig)
    spins, energies = tcobi.cobi_readout_cuda(*args, op.phi0, **kw)
    mask, reads = tops.solo_slot(op.n_pad, 8, card)
    best_e, best_s = tcobi.cobi_fused_best_cuda(*args, mask, reads, op.phi0, **kw)
    i = int(torch.argmin(energies))
    assert float(best_e[0]) == float(energies[i]) and torch.equal(best_s[0], spins[i])


@pytest.mark.cuda
def test_packed_bin_equals_solo_on_card(card):
    """On the card: jobs at lane offsets 3, 21 and 77 of one bin anneal to
    their solo phases bit for bit (400 steps)."""
    kw = dict(steps=400, dt=0.35, ks_max=1.2)
    jb, hb = torch.zeros((1, 128, 128), device=card), torch.zeros((1, 1, 128), device=card)
    phib = torch.zeros((1, 8, 128), device=card)
    solos = []
    for off, n in ((3, 15), (21, 40), (77, 30)):
        op = tops.anneal_operands(*(x.to(card) for x in _t(*_loop_instance(off, n))),
                                  tprng.key(off), replicas=8)
        js, hs, p0 = op.j_scaled, op.h_scaled, op.phi0
        lanes = slice(off, off + n)
        jb[0, lanes, lanes], hb[0, 0, lanes], phib[0, :, lanes] = js[:n, :n], hs[0, :n], p0[:, :n]
        solos.append((lanes, n, tcobi.cobi_trajectory_cuda(js, hs, p0, **kw)))
    packed = tcobi.cobi_trajectory_batched_cuda(jb, hb, phib, **kw)
    for lanes, n, solo in solos:
        assert torch.equal(packed[0, :, lanes], solo[:, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 20, 59, 128, 129, 200, 1024])
def test_ising_energy_kernel_matches_plain_on_card(card, n):
    """The energy kernel bit for bit its plain version on chip-range integer
    instances: R 1 to 1024, B 1 and 3, int8 and float32 spins, and the live
    corner of zero-padded operands read in place at their row strides."""
    for r in (1, 8, 17, 256, 1024):
        hs, js = zip(*(_instance(31 * b + n + r, n) for b in range(3)))
        h, j = (torch.from_numpy(np.stack(a)).to(card) for a in (hs, js))
        spins = torch.from_numpy(_spins(n + r, 3, r, n)).to(card)
        want = tenergy.ising_energy_batched_plain(spins, h[:, None], j)
        for s in (spins, spins.float()):
            assert torch.equal(tenergy.ising_energy_batched_cuda(s, h[:, None], j), want)
            assert torch.equal(tenergy.ising_energy_cuda(s[1], h[1:2], j[1]), want[1])
        sp = torch.zeros((r, n + 5), dtype=torch.int8, device=card)
        jp = torch.zeros((n + 5, n + 5), device=card)
        sp[:, :n], jp[:n, :n] = spins[0], j[0]
        assert torch.equal(tops.ising_energy(sp[:, :n], h[0], jp[:n, :n]), want[0])


def _float_instance(seed, n, card):
    """A non-integer float32 instance (h, J) on the card."""
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(n, n)).astype(np.float32)
    return (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(card),
            torch.from_numpy((j + j.T) / np.float32(2)).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("n,reads", [(20, 8), (100, 64), (128, 8)])
def test_ising_energy_kernel_matches_readout_epilogue_on_card(card, n, reads):
    """On non-integer instances the energy kernel gives the COBI readout
    epilogue's energies bit for bit: the same fmaf chain, density and row
    sum, over the live lanes where the epilogue runs them over 128."""
    h, j = _float_instance(n, n, card)
    op = tops.anneal_operands(h, j, tprng.key(n), replicas=reads)
    spins, energies = tcobi.cobi_readout_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                              op.phi0, steps=100, dt=0.35, ks_max=1.2)
    live, want = spins[:reads, :n], energies[:reads]
    assert not torch.equal(want, want.round())  # not an integer instance
    for s in (live, live.contiguous(), live.to(torch.int8)):
        assert torch.equal(tops.ising_energy(s, h, j), want)
    assert torch.equal(tenergy.ising_energy_cuda(live, op.h_orig[:, :n], op.j_orig[:n, :n]), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 77])
def test_tile_aligned_twin_equals_unpadded_call_on_card(card, n):
    """ising_energy_cuda on tile-aligned zero-padded operands (R 8, N 128)
    equals ops.ising_energy on the live corner bit for bit, on integer and
    non-integer instances: the padding adds exact zero terms."""
    for h, j in (_t(*_instance(n, n)), _float_instance(n, n, card)):
        h, j = h.to(card), j.to(card)
        spins = torch.from_numpy(_spins(n, 8, n)).to(card)
        sp = torch.zeros((8, 128), device=card)
        hp = torch.zeros((1, 128), device=card)
        jp = torch.zeros((128, 128), device=card)
        sp[:, :n], hp[0, :n], jp[:n, :n] = spins, h, j
        assert torch.equal(tenergy.ising_energy_cuda(sp, hp, jp), tops.ising_energy(spins, h, j))


ENERGY_LANES = (1, 7, 20, 59, 128, 129, 200)
ENERGY_ROWS = (1, 8, 17, 256)
ENERGY_CASES = sorted({(n, r) for n in ENERGY_LANES for r in ENERGY_ROWS}
                      | {(8, 4), (59, 33)})


def _spins(seed, *shape):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, 1, -1).astype(np.int8)


@pytest.mark.parametrize("n,r", ENERGY_CASES)
def test_ising_energy_matches_exactly(n, r):
    """ops.ising_energy on unpadded operands, int8 and float32 spins and
    one 1-D row, bit for bit the JAX package's (which pads to its tiles)."""
    h, j = _instance(n + r, n)
    spins = _spins(r, r, n)
    want = np.asarray(jops.ising_energy(jnp.asarray(spins), jnp.asarray(h), jnp.asarray(j)))
    for s in (spins, spins.astype(np.float32)):
        np.testing.assert_array_equal(tops.ising_energy(*_t(s, h, j)).numpy(), want)
        np.testing.assert_array_equal(tops.ising_energy(*_t(s[0], h, j)).numpy(), want[0])


@pytest.mark.parametrize("n,r", [(20, 8), (129, 17)])
def test_stacked_ising_energy_matches_exactly(n, r):
    """(B, R, n) spins against a stack of three instances, int8 and float32."""
    hs, js = zip(*(_instance(7 * b + n, n) for b in range(3)))
    h, j = np.stack(hs), np.stack(js)
    spins = _spins(n, 3, r, n)
    want = np.asarray(jops.ising_energy(jnp.asarray(spins), jnp.asarray(h), jnp.asarray(j)))
    assert want.shape == (3, r)
    for s in (spins, spins.astype(np.float32)):
        np.testing.assert_array_equal(tops.ising_energy(*_t(s, h, j)).numpy(), want)


def test_energy_path_pads_nothing(monkeypatch):
    """ops.ising_energy (solo, 1-D and stacked) never pads, and
    cobi_anneal(reduce="none") pads only its dynamics operands: neither the
    spins nor the given h and J, which it scores unpadded."""
    h, j, key = _anneal_pair(20, 8)
    spins = torch.from_numpy(_spins(3, 8, 20))
    want = tref.ref_ising_energy(spins, h, j)
    real = tops._padded

    def refuse(x, shape):
        raise AssertionError(f"the energy path padded a {tuple(x.shape)} {x.dtype} tensor")

    monkeypatch.setattr(tops, "_padded", refuse)
    assert torch.equal(tops.ising_energy(spins, h, j), want)
    assert torch.equal(tops.ising_energy(spins[2], h, j), want[2])
    e3 = tops.ising_energy(torch.stack([spins] * 3), torch.stack([h] * 3), torch.stack([j] * 3))
    assert torch.equal(e3, torch.stack([want] * 3))

    padded = []

    def dynamics_only(x, shape):
        if x is h or x is j or x.dtype == torch.int8:
            refuse(x, shape)
        padded.append(tuple(shape))
        return real(x, shape)

    monkeypatch.setattr(tops, "_padded", dynamics_only)
    s, e = tops.cobi_anneal(h, j, key, replicas=8, steps=20)
    assert padded == [(128, 128), (1, 128)]  # j_scaled and h_scaled
    assert s.dtype == torch.int8 and torch.equal(e, tref.ref_ising_energy(s, h, j))


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
