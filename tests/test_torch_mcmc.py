"""The port's MCMC solver family on the CPU (the kernels' plain versions)
against the JAX package's: the counter hash and initial spins, the anneal
against the reference's oracle and its Pallas kernel in interpret mode, the
registry contract, the annealer bank's receipts, and ``solve_es`` with
``solver="mcmc"`` inline, decomposed and through ``McmcPoolBackend``.

Bars: everything is equal bit for bit -- spins, energies, selections,
objectives and curves.  The energies are equal because the port sums the
initial energy in the reference's float32 order (``formulation.row_sum``);
the acceptance test ``u < exp(...)`` uses torch's ``exp``, which may differ
from XLA's by an ulp, and no decision of these cases flips.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import SolveConfig as JSolveConfig
from repro.core.hardware import MCMC_CMOS as JMCMC_CMOS
from repro.core import improved_ising as jimproved
from repro.core import quantize_ising as jquantize
from repro.core import solve_es as jsolve_es
from repro.data.synthetic import synthetic_benchmark
from repro.farm import McmcPoolBackend as JMcmcPool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.solvers.base import ising_solver as jising_solver
from repro_torch.core import SolveConfig, solve_es
from repro_torch.core.formulation import IsingProblem
from repro_torch.core.hardware import MCMC_CMOS
from repro_torch.farm import McmcPoolBackend
from repro_torch.interop import carry_across
from repro_torch.kernels import mcmc_dynamics as tmcmc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.solvers import ThreadPoolBackend, ising_solver

WRAPPERS = (tmcmc.mcmc_sweep_batched, tmcmc.mcmc_fused_best_batched)


def _tkey(jkey):
    return carry_across("key", np.asarray(jax.random.key_data(jkey)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _random_instance(seed: int, n: int):
    """tests/test_solver_registry.py's float-normal instance."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    j = jax.random.normal(k1, (n, n), jnp.float32)
    j = (j + j.T) / 2
    j = j - jnp.diag(jnp.diag(j))
    h = jax.random.normal(k2, (n,), jnp.float32)
    return h, j


def _same(a, b):
    return (np.array_equal(a.selection, b.selection) and a.objective == b.objective
            and np.array_equal(a.curve, b.curve))


@pytest.fixture(scope="module")
def instance():
    """The registry suite's integer instance, for both packages."""
    p = synthetic_benchmark(5, 12, 4, lam=0.5)
    q = jquantize(jimproved(p), "deterministic", int_range=14).ising
    return q, carry_across("ising", np.asarray(q.h), np.asarray(q.j), device="cpu")


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_counter_hash_and_initial_spins_match_reference(seed):
    jkey = jax.random.key(seed)
    seeds = jref.mcmc_seeds(jkey)
    tseeds = tref.mcmc_seeds(_tkey(jkey))
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(seeds).astype(np.int64))
    rep = np.array([0, 1, 7, 255, 4095, 2**31 + 3])[:, None]
    pos = np.arange(0, 256, 5)[None, :]
    for sweep in (0, 1, 49, 2**20 + 1):
        want = jref.mcmc_u01(seeds[2], jnp.asarray(rep, jnp.uint32), jnp.uint32(sweep),
                             jnp.asarray(pos, jnp.uint32))
        got = tref.mcmc_u01(int(tseeds[2]), torch.tensor(rep), sweep, torch.tensor(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tref.mcmc_init_spins(tseeds[0], 24, 128).numpy(),
        np.asarray(jref.mcmc_init_spins(seeds[0], 24, 128)),
    )
    _, j = _random_instance(seed, 20)
    assert float(tref.mcmc_t_hi(_t(j))) == float(jref.mcmc_t_hi(j))


@pytest.mark.parametrize("reduce", ["none", "best"])
@pytest.mark.parametrize("mode", ["sweep", "random"])
@pytest.mark.parametrize("n,chunk,replica_block", [(12, 32, 8), (12, 128, 16), (20, 64, 16)])
def test_mcmc_anneal_matches_reference_oracle_and_pallas(mode, n, chunk, replica_block, reduce):
    """tests/test_solver_registry.py's six kernel-parity cases, both reduces:
    the port's plain anneal equals the reference's oracle (impl="ref") and
    its Pallas kernel in interpret mode, spins and energies bit for bit."""
    h, j = _random_instance(100 + n, n)
    jkey = jax.random.key(n * 7 + chunk)
    kw = dict(replicas=16, sweeps=6, mode=mode, t_lo=0.1, reduce=reduce)
    s_ref, e_ref = jops.mcmc_anneal(h, j, jkey, impl="ref", **kw)
    s_pal, e_pal = jops.mcmc_anneal(h, j, jkey, impl="pallas", chunk=chunk,
                                    replica_block=replica_block, **kw)
    s, e = tops.mcmc_anneal(_t(h), _t(j), _tkey(jkey), chunk=chunk,
                            replica_block=replica_block, **kw)
    assert s.dtype == torch.int8 and s.shape == np.asarray(s_ref).shape
    assert e.shape == np.asarray(e_ref).shape
    for want_s, want_e in ((s_ref, e_ref), (s_pal, e_pal)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))


def test_batched_plain_versions_match_per_instance_oracle():
    """B = 3 instances through the batched wrappers (plain on the CPU) equal
    three independent runs of the reference's oracle; the fused best equals
    the first argmin over the first ``reads`` = 3 of 8 replicas."""
    b, replicas, n, n_pad, reads = 3, 8, 12, 128, 3
    insts = [_random_instance(40 + i, n) for i in range(b)]
    jkeys = [jax.random.fold_in(jax.random.key(9), i) for i in range(b)]
    jp = torch.zeros((b, n_pad, n_pad))
    hp = torch.zeros((b, 1, n_pad))
    s0, seeds, params = [], [], []
    for i, ((h, j), k) in enumerate(zip(insts, jkeys)):
        jp[i, :n, :n], hp[i, 0, :n] = _t(j), _t(h)
        sd = tref.mcmc_seeds(_tkey(k))
        seeds.append(sd)
        s0.append(tref.mcmc_init_spins(sd[0], replicas, n_pad))
        params.append([float(jref.mcmc_t_hi(j)), 0.05, n, reads])
    s0, seeds = torch.stack(s0), torch.stack(seeds)
    params = torch.tensor(params, dtype=torch.float32)
    kw = dict(sweeps=5, chunk=64, replica_block=8)
    e_all, s_all = tmcmc.mcmc_sweep_batched(jp, hp, s0, seeds, params, **kw)
    e_best, s_best = tmcmc.mcmc_fused_best_batched(jp, hp, s0, seeds, params, **kw)
    assert e_all.shape == (b, replicas) and e_best.shape == (b,) and s_best.shape == (b, n_pad)
    for i, ((h, j), k) in enumerate(zip(insts, jkeys)):
        jpi = jnp.zeros((n_pad, n_pad), jnp.float32).at[:n, :n].set(j)
        hpi = jnp.zeros((n_pad,), jnp.float32).at[:n].set(h)
        s_ref, e_ref = jref.ref_mcmc_sweep(jpi, hpi, k, replicas=replicas, sweeps=5,
                                           t_hi=jref.mcmc_t_hi(j), t_lo=0.05, n_real=n)
        np.testing.assert_array_equal(s_all[i].numpy(), np.asarray(s_ref))
        np.testing.assert_array_equal(e_all[i].numpy(), np.asarray(e_ref))
        first = int(np.argmin(np.asarray(e_ref)[:reads]))
        assert float(e_best[i]) == float(e_ref[first])
        np.testing.assert_array_equal(s_best[i].numpy(), np.asarray(s_ref[first]))


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    before = [w.launches for w in WRAPPERS]
    h, j = _random_instance(3, 10)
    for reduce in ("none", "best"):
        tops.mcmc_anneal(_t(h), _t(j), _tkey(jax.random.key(0)), sweeps=2, reduce=reduce)
    assert [w.launches for w in WRAPPERS] == before
    with pytest.raises(ValueError, match="reduce"):
        tops.mcmc_anneal(_t(h), _t(j), _tkey(jax.random.key(0)), sweeps=2, reduce="topk")
    with pytest.raises(ValueError, match="mode"):
        tops.mcmc_anneal(_t(h), _t(j), _tkey(jax.random.key(0)), sweeps=2, mode="gibbs")


class _YieldingCount(int):
    """A launch count whose addition yields to the other threads, so a
    read-add-write that is not locked loses counts."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


def test_launch_counts_are_exact_under_concurrent_launches(monkeypatch):
    """The bank's workers launch at once: every launch counts.  The kernel
    is stubbed out; tensors on the meta device take the wrapper's launch
    path, which a CPU tensor never does."""
    monkeypatch.setattr(tmcmc, "_launch", lambda *args, **kwargs: None)
    meta = dict(device="meta")
    j, h, s0 = torch.empty((1, 128, 128), **meta), torch.empty((1, 1, 128), **meta), \
        torch.empty((1, 8, 128), **meta)
    seeds, params = torch.zeros((1, 4), dtype=torch.int64), torch.zeros((1, 4))
    threads, calls = 8, 200
    for wrapper in WRAPPERS:
        monkeypatch.setattr(wrapper, "launches", _YieldingCount(0))

        def launch(wrapper=wrapper):
            for _ in range(calls):
                wrapper(j, h, s0, seeds, params, sweeps=1, replica_block=8)

        pool = [threading.Thread(target=launch) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
        assert wrapper.launches == threads * calls


# ------------------------------------------------------- registry and bank


def test_registry_contract_for_mcmc(instance):
    """tests/test_solver_registry.py's contract for "mcmc" on the port, and
    each call equal to the reference's solver on the same key."""
    jq, tq = instance
    solver, jsolver = ising_solver("mcmc"), jising_solver("mcmc")
    n = tq.n
    for key, reads, steps, reduce in ((11, 8, 120, "none"), (23, 8, 120, "best"),
                                      (31, 3, 80, "none")):
        res = solver(tq, _tkey(jax.random.key(key)), reads=reads, steps=steps, check=True,
                     reduce=reduce)
        want = jsolver(jq, jax.random.key(key), reads=reads, steps=steps, check=True,
                       reduce=reduce)
        np.testing.assert_array_equal(res.spins.numpy(), np.asarray(want.spins))
        np.testing.assert_array_equal(res.energies.numpy(), np.asarray(want.energies))
        rows = 1 if reduce == "best" else reads
        assert res.spins.shape == (rows, n) and res.energies.shape == (rows,)
        assert set(np.unique(res.spins.numpy())) <= {-1, 1}
        recomputed = tops.ising_energy(res.spins.to(torch.float32), tq.h, tq.j)
        np.testing.assert_array_equal(recomputed.numpy(), res.energies.numpy())
    key = _tkey(jax.random.key(23))
    best = solver(tq, key, reads=8, steps=120, reduce="best")
    host = solver(tq, key, reads=8, steps=120, reduce="none").reduced("best")
    assert torch.equal(best.spins, host.spins) and torch.equal(best.energies, host.energies)


def test_thread_pool_default_solver_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="queue 1: host solvers"):
        ThreadPoolBackend()


def test_pool_receipts_and_results_equal_the_reference(instance):
    """The same jobs through the JAX bank and the port's: the results equal,
    and so do the receipts' billed fields (MCMC_CMOS chip time and energy,
    program and readout bytes, no host seconds)."""
    jq, tq = instance
    assert dataclasses.asdict(MCMC_CMOS) == dataclasses.asdict(JMCMC_CMOS)
    jobs = [(3, 8, "best"), (4, 3, "none"), (5, 16, "best")]
    jbank, tbank = JMcmcPool(workers=2), McmcPoolBackend(workers=2, device="cpu")
    try:
        for seed, reads, reduce in jobs:
            jf = jbank.submit(jq, jax.random.key(seed), reads=reads, steps=80, reduce=reduce)
            tf = tbank.submit(tq, _tkey(jax.random.key(seed)), reads=reads, steps=80,
                              reduce=reduce)
            want, got = jf.result(timeout=120), tf.result(timeout=120)
            np.testing.assert_array_equal(got.spins.numpy(), np.asarray(want.spins))
            np.testing.assert_array_equal(got.energies.numpy(), np.asarray(want.energies))
            jr, tr = jf.receipt(), tf.receipt()
            for field in ("chip_seconds", "energy_joules", "bytes_h2d", "bytes_d2h",
                          "host_seconds"):
                assert getattr(tr, field) == getattr(jr, field), field
            assert tr.host_seconds == 0.0 and tr.sim_latency_seconds >= 0.0
        assert tbank.stats() | {"est_queue_seconds": 0.0} == \
            jbank.stats() | {"est_queue_seconds": 0.0}
    finally:
        jbank.close()
        tbank.close()


# ------------------------------------------------------------- solve_es


def _es_pair(seed, n, m):
    jp = synthetic_benchmark(seed, n, m, lam=0.5)
    return jp, carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=m, lam=0.5,
                            device="cpu")


def test_direct_document_selects_the_reference_summary():
    """synthetic_document(7, 20), m = 6, lambda = 0.5, the default
    SolveConfig(solver="mcmc") (10 iterations x 8 reads x 50 sweeps), key 0:
    the reference's selection and objective, inline and through the bank,
    and the JAX package's curve on the same mu/beta."""
    from repro.embeddings.encoder import problem_from_sentences as jfrom_sentences
    from repro.data.synthetic import synthetic_document as jdocument

    jp = jfrom_sentences(jdocument(7, 20), m=6, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=6, lam=0.5,
                      device="cpu")
    cfg = SolveConfig(solver="mcmc")
    inline = solve_es(tp, _tkey(jax.random.key(0)), cfg, device="cpu")
    with McmcPoolBackend(workers=2, device="cpu") as bank:
        pooled = solve_es(tp, _tkey(jax.random.key(0)), cfg, device="cpu", backend=bank)
    want = jsolve_es(jp, jax.random.key(0), JSolveConfig(solver="mcmc"))
    assert np.nonzero(inline.selection)[0].tolist() == [1, 4, 8, 9, 10, 12]
    assert abs(inline.objective - 0.93262) <= 1e-5
    assert _same(inline, pooled) and _same(inline, want)
    assert pooled.chip_seconds == pytest.approx(cfg.iterations * cfg.reads * 50e-6)
    assert pooled.bytes_h2d == cfg.iterations * (20 * 20 + 20) * 4


@pytest.mark.parametrize("mode", ["sweep", "random"])
def test_solve_es_paths_equal_each_other_and_the_reference(mode):
    """A direct solve inline and through the bank, equal to each other and to
    the JAX package; ``mode`` reaches the solver through the bank."""
    jp, tp = _es_pair(3, 16, 4)
    cfg = dict(solver="mcmc", iterations=3, reads=8, steps=120)
    jkey = jax.random.key(5)
    with JMcmcPool(workers=2, mode=mode) as jbank:
        want = jsolve_es(jp, jkey, JSolveConfig(**cfg), backend=jbank)
    with McmcPoolBackend(workers=2, mode=mode, device="cpu") as bank:
        pooled = solve_es(tp, _tkey(jkey), SolveConfig(**cfg), device="cpu", backend=bank)
    assert _same(pooled, want)
    if mode == "sweep":
        inline = solve_es(tp, _tkey(jkey), SolveConfig(**cfg), device="cpu")
        assert _same(inline, pooled)


def test_decomposed_solve_inline_and_through_the_bank_equal_the_reference():
    jp, tp = _es_pair(5, 70, 6)
    cfg = dict(solver="mcmc", iterations=2, reads=8, steps=80, decompose=True, p=20, q=10)
    jkey = jax.random.key(2)
    inline = solve_es(tp, _tkey(jkey), SolveConfig(**cfg), device="cpu")
    with McmcPoolBackend(workers=2, device="cpu") as bank:
        pooled = solve_es(tp, _tkey(jkey), SolveConfig(**cfg), device="cpu", backend=bank)
    want = jsolve_es(jp, jkey, JSolveConfig(**cfg))
    assert inline.selection.sum() == 6
    assert np.array_equal(inline.selection, pooled.selection)
    assert inline.objective == pooled.objective
    assert np.array_equal(inline.selection, want.selection)
    assert inline.objective == want.objective


def test_bank_finds_the_ground_state_of_a_field_only_instance():
    with McmcPoolBackend(workers=1, device="cpu") as bank:
        assert bank.device == torch.device("cpu")
        q = IsingProblem(h=torch.ones(4), j=torch.zeros((4, 4)))
        res = bank.submit(q, _tkey(jax.random.key(0)), reads=8, steps=16,
                          reduce="best").result(timeout=60)
        np.testing.assert_array_equal(res.spins.numpy(), -np.ones((1, 4), np.int8))
        assert float(res.energies[0]) == -4.0
