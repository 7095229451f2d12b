"""The port's host solvers against the reference's, on the CPU: greedy,
random, Tabu and SA.

Bars: greedy, random's selections, Tabu (spins, energies; solve_es's
selection, objective and curve) and SA's initial spins, picks and uniforms
are the reference's bit for bit on chip-range integer instances, where every
Tabu and SA quantity is an exact integer in float32.  SA's temperature
(float32 pow) and exp may differ from XLA's by an ulp, which can flip a
decision only when a uniform falls between the two values: the tested cases
hold its selections (and, as it happens, spins and energies) equal.  The
Tabu fallback of reference_bounds (test_torch_core.py) and the thread-pool
backend (test_torch_mcmc.py) are held to the reference where their
not-ported guards stood.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import SolveConfig as JSolveConfig
from repro.core import solve_es as jsolve_es
from repro.core.formulation import improved_ising as jimproved
from repro.core.hardware import TABU_CPU as JTABU_CPU
from repro.core.rounding import quantize_ising as jquantize
from repro.data.synthetic import synthetic_benchmark
from repro.solvers import base as jbase
from repro.solvers import greedy as jgreedy
from repro.solvers import random_baseline as jrandom
from repro.solvers import sa as jsa
from repro.solvers import tabu as jtabu
from repro_torch.core import SolveConfig, solve_es
from repro_torch.core.formulation import IsingProblem
from repro_torch.core.hardware import TABU_CPU
from repro_torch.interop import carry_across
from repro_torch.solvers import base as tbase
from repro_torch.solvers import greedy, random_baseline, sa, tabu


def _tkey(k):
    return carry_across("key", np.asarray(jax.random.key_data(k)))


def _problems(seed, n, m=4, lam=0.5):
    jp = synthetic_benchmark(seed, n, m, lam=lam)
    return jp, carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=m, lam=lam,
                            device="cpu")


def _quantized(seed, n):
    """A chip-range integer instance: the reference's stochastic rounding."""
    jp, _ = _problems(seed, n)
    q = jquantize(jimproved(jp), key=jax.random.key(100 + seed)).ising
    return q, IsingProblem(h=torch.tensor(np.asarray(q.h)), j=torch.tensor(np.asarray(q.j)))


def _same_result(got, want):
    np.testing.assert_array_equal(got.spins.numpy(), np.asarray(want.spins))
    np.testing.assert_array_equal(got.energies.numpy(), np.asarray(want.energies))
    assert got.spins.dtype == torch.int8 and got.energies.dtype == torch.float32


def test_tabu_cpu_and_unknown_names_equal_the_reference():
    """TABU_CPU's constants; names the registry lacks raise what the
    reference raises (its names and "random" are asserted with the tests of
    brute and of solve_es's baselines)."""
    assert dataclasses.asdict(TABU_CPU) == dataclasses.asdict(JTABU_CPU)
    for name in ("greedy", "nope"):
        with pytest.raises(ValueError) as want:
            jbase.ising_solver(name)
        with pytest.raises(ValueError) as got:
            tbase.ising_solver(name)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,n,m", [(0, 12, 4), (1, 20, 6), (2, 40, 12)])
def test_greedy_matches(seed, n, m):
    jp, tp = _problems(seed, n, m)
    np.testing.assert_array_equal(greedy.greedy_select(tp), jgreedy.greedy_select(jp))


@pytest.mark.parametrize("seed,n,m", [(0, 12, 4), (3, 30, 6)])
def test_random_baseline_matches(seed, n, m):
    """Selections bit for bit (permutation ranks); objectives within float32
    summation order (rtol 1e-6)."""
    jp, tp = _problems(seed, n, m)
    k = jax.random.key(seed)
    want = np.asarray(jrandom.random_selections(k, n, m, 9))
    got = random_baseline.random_selections(_tkey(k), n, m, 9, device="cpu")
    assert got.dtype == torch.int32 and (got.sum(-1) == m).all()
    np.testing.assert_array_equal(got.numpy(), want)
    jx, jobjs = jrandom.solve(jp, k, 9)
    tx, tobjs = random_baseline.solve(tp, _tkey(k), 9)
    np.testing.assert_allclose(tobjs.numpy(), np.asarray(jobjs), rtol=1e-6)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 20), (2, 33), (3, 59)])
def test_tabu_bitwise_on_integer_instances(seed, n):
    jq, tq = _quantized(seed, n)
    for kseed, kw in ((seed, {}), (seed + 50, dict(replicas=16, iters=90, tenure=2))):
        k = jax.random.key(kseed)
        _same_result(tabu.solve(tq, _tkey(k), **kw), jtabu.solve(jq, k, **kw))
    k = jax.random.key(seed)
    best = tabu.solve_ising(tq, _tkey(k), reads=8, reduce="best")
    _same_result(best, jtabu.solve_ising(jq, k, reads=8, reduce="best"))


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 20), (2, 33)])
def test_sa_matches_on_integer_instances(seed, n):
    jq, tq = _quantized(seed, n)
    k = jax.random.key(seed)
    want, got = jsa.solve(jq, k, sweeps=20), sa.solve(tq, _tkey(k), sweeps=20)
    _same_result(got, want)


@pytest.mark.parametrize("solver", ["tabu", "sa"])
@pytest.mark.parametrize("seed", [1, 2])
def test_solve_es_with_host_solvers_matches(solver, seed):
    """Through solve_es (quantized iterations): Tabu's selection, objective
    and curve bit for bit; SA's selection equal."""
    jp, tp = _problems(seed, 18, m=5)
    kw = dict(solver=solver, iterations=4, reads=6, int_range=14)
    want = jsolve_es(jp, jax.random.key(seed), JSolveConfig(**kw))
    got = solve_es(tp, _tkey(jax.random.key(seed)), SolveConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.selection, want.selection)
    if solver == "tabu":
        assert got.objective == want.objective
        np.testing.assert_array_equal(got.curve, want.curve)
