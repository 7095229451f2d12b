"""The port's public surface against the reference's, on the CPU: the
engine's ``stats()["encoder_cache"]`` with the default HashedBoW encoder,
the formulation's ``qubo_energy`` / ``ising_offset`` /
``selection_to_spins``, ``rounding.joint_scale``, ``brute.exact_qubo_min``,
and the names ``repro_torch.solvers`` exports after a bare import.

The checks are twins of the reference's own (tests/test_formulation.py,
tests/test_kofn.py), each run through both packages on the same inputs.
Bars: selections, spins, cache counters, scales and the float64 offset bit
for bit; float32 energies within rtol 1e-6 (einsum summation order).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.solvers as jsolvers
from repro.core import SolveConfig as JSolveConfig
from repro.core import formulation as jform
from repro.core import kofn as jkofn
from repro.core import rounding as jround
from repro.data.synthetic import synthetic_benchmark
from repro.serving import SummarizationEngine as JEngine
from repro.serving import SummarizeRequest as JSummarizeRequest
from repro.solvers import brute as jbrute
from repro_torch import core as tcore
from repro_torch.core import SolveConfig
from repro_torch.core import formulation as tform
from repro_torch.core import kofn as tkofn
from repro_torch.core import rounding as tround
from repro_torch.data.synthetic import synthetic_document
from repro_torch.interop import carry_across
from repro_torch.serving import SummarizationEngine, SummarizeRequest
from repro_torch.solvers import brute as tbrute

ROOT = Path(__file__).resolve().parents[1]


def _sym(seed, n, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n)) * scale + shift
    return ((q + q.T) / 2).astype(np.float32), rng


def _pair(q):
    return jform.QuboProblem(q=jnp.asarray(q)), tform.QuboProblem(q=torch.from_numpy(q))


def _feasible(rng, n, k, count):
    xs = np.zeros((count, n), np.float32)
    for x in xs:
        x[rng.choice(n, k, replace=False)] = 1
    return xs


def _problem(seed, n, m):
    jp = synthetic_benchmark(seed, n, m, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=m, lam=0.5,
                      device="cpu")
    return jp, tp


# ------------------------------------------------------------ encoder cache


def test_engine_encoder_cache_stats_equal_the_reference():
    """Three text requests with a shared vocabulary: the default encoder's
    hits, misses, size and hit rate equal the reference engine's."""
    cfg = dict(solver="tabu", iterations=1, reads=2, int_range=14)
    texts = [" ".join(synthetic_document(seed, 12)) for seed in (41, 42, 41)]
    with JEngine(JSolveConfig(**cfg), pool_workers=1, seed=0) as jeng:
        jeng.run_batch([JSummarizeRequest(text=t, m=4) for t in texts], seed=1)
        want = jeng.stats()["encoder_cache"]
    with SummarizationEngine(SolveConfig(**cfg), pool_workers=1, seed=0, device="cpu") as teng:
        teng.run_batch([SummarizeRequest(text=t, m=4) for t in texts], seed=1)
        got = teng.stats()["encoder_cache"]
    assert got == want
    assert got["hits"] > 0 and got["misses"] > 0


# -------------------------------------------------------------- formulation


@pytest.mark.parametrize("seed,n", [(0, 4), (7, 9), (23, 16), (50, 12)])
def test_qubo_ising_energy_equivalence(seed, n):
    """H_qubo(x) == H_ising(s) + offset for x = (1+s)/2, random Q, in both
    packages; the offset bit for bit, the energies within rtol 1e-6."""
    q, rng = _sym(seed, n)
    jq, tq = _pair(q)
    ji, ti = jform.qubo_to_ising(jq), tform.qubo_to_ising(tq)
    off = tform.ising_offset(tq)
    assert off == jform.ising_offset(jq)
    x = rng.integers(0, 2, size=(8, n)).astype(np.float32)
    s = tform.selection_to_spins(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jform.selection_to_spins(jnp.asarray(x))))
    assert s.dtype == torch.float32
    eq = tform.qubo_energy(tq.q, torch.from_numpy(x))
    np.testing.assert_allclose(eq.numpy(), np.asarray(jform.qubo_energy(jq.q, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    ei = tform.ising_energy(ti.h, ti.j, s) + off
    np.testing.assert_allclose(eq.numpy(), ei.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tform.spins_to_selection(s).numpy(), x.astype(np.int32))


def test_core_exports_the_reference_names():
    assert tcore.qubo_energy is tform.qubo_energy
    assert tcore.selection_to_spins is tform.selection_to_spins


@pytest.mark.parametrize("seed", range(5))
def test_original_qubo_min_is_constrained_optimum(seed):
    """With gamma_auto the unconstrained QUBO argmin is the exact
    cardinality-M optimum: the port's exact_qubo_min selects the reference's
    minimiser bit for bit."""
    jp, tp = _problem(seed, 12, 4)
    x_q, e_q = tbrute.exact_qubo_min(tform.qubo_original(tp).q)
    jx, je = jbrute.exact_qubo_min(np.asarray(jform.qubo_original(jp).q))
    np.testing.assert_array_equal(x_q, jx)
    assert x_q.dtype == np.int32
    np.testing.assert_allclose(e_q, je, rtol=1e-6)
    _, x_best, _, _ = tbrute.exact_constrained_bounds(tp)
    np.testing.assert_array_equal(x_q, x_best.astype(np.int32))
    assert x_q.sum() == tp.m


def test_exact_qubo_min_is_chunked_as_the_reference():
    q, _ = _sym(3, 11, shift=-0.2)
    for chunk in (1 << 4, 1 << 18):
        x, e = tbrute.exact_qubo_min(q, chunk=chunk)
        jx, je = jbrute.exact_qubo_min(q, chunk=chunk)
        np.testing.assert_array_equal(x, jx)
        assert e == je
    with pytest.raises(ValueError, match="too large"):
        tbrute.exact_qubo_min(np.zeros((23, 23), np.float32))


@pytest.mark.parametrize("seed", range(3))
def test_improved_equals_original_on_feasible_set(seed):
    """The mu_b shift is constant on |x| = M, in the port as in the reference."""
    jp, tp = _problem(seed, 10, 3)
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(_feasible(rng, tp.n, tp.m, 6))
    eo = tform.qubo_energy(tform.qubo_original(tp, gamma=2.0).q, xs).numpy()
    ei = tform.qubo_energy(tform.qubo_improved(tp, gamma=2.0).q, xs).numpy()
    np.testing.assert_allclose(eo - eo[0], ei - ei[0], rtol=1e-4, atol=1e-3)
    jeo = np.asarray(jform.qubo_energy(jform.qubo_original(jp, gamma=2.0).q,
                                       jnp.asarray(xs.numpy())))
    np.testing.assert_allclose(eo, jeo, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- k-of-n


@pytest.mark.parametrize("seed,n", [(0, 5), (4, 9), (11, 14), (20, 12)])
def test_rebalance_aligns_medians(seed, n):
    q, _ = _sym(seed, n, scale=3.0, shift=1.0)
    jq, tq = _pair(q)
    ti, c = tkofn.rebalance_ising(tform.qubo_to_ising(tq))
    _, jc = jkofn.rebalance_ising(jform.qubo_to_ising(jq))
    assert c == jc
    off = ti.j.numpy()[~np.eye(n, dtype=bool)]
    assert abs(np.median(ti.h.numpy()) - np.median(off)) < 1e-3 * max(1.0, abs(np.median(off)))


@pytest.mark.parametrize("seed", [0, 5, 13])
def test_rebalance_constant_on_fixed_cardinality(seed):
    """Energy differences between equal-cardinality x are preserved, and the
    shift is c k, through the port's qubo_energy."""
    n, k = 10, 4
    q, rng = _sym(seed, n)
    jq, tq = _pair(q)
    q2, c = tkofn.rebalance_qubo(tq)
    assert c == jkofn.rebalance_qubo(jq)[1]
    xs = torch.from_numpy(_feasible(rng, n, k, 5))
    e1, e2 = tform.qubo_energy(tq.q, xs).numpy(), tform.qubo_energy(q2.q, xs).numpy()
    np.testing.assert_allclose(e1 - e1[0], e2 - e2[0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(e1 - e2, c * k, rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------ rounding


@pytest.mark.parametrize("n,int_range", [(7, 14), (20, 14), (59, 127), (3, 1)])
def test_joint_scale_is_the_references(n, int_range):
    jp, tp = _problem(n, n, min(3, n - 1))
    ji, ti = jform.improved_ising(jp), tform.improved_ising(tp)
    # Both packages' own instances (they agree within 1e-6), then the
    # reference's instance carried across: the scale bit for bit.
    carried = tform.IsingProblem(h=torch.from_numpy(np.array(ji.h)),
                                 j=torch.from_numpy(np.array(ji.j)))
    assert tround.joint_scale(carried, int_range) == jround.joint_scale(ji, int_range)
    np.testing.assert_allclose(tround.joint_scale(ti, int_range),
                               jround.joint_scale(ji, int_range), rtol=1e-6)
    assert tround.joint_scale(carried, int_range) == tround.quantize_ising(
        carried, "deterministic", int_range=int_range).scale
    zero = tform.IsingProblem(h=torch.zeros(3), j=torch.zeros(3, 3))
    assert tround.joint_scale(zero, int_range) == jround.joint_scale(
        jform.IsingProblem(h=jnp.zeros(3), j=jnp.zeros((3, 3))), int_range)


# ------------------------------------------------------------------- solvers


def test_bare_solvers_import_exposes_the_reference_names():
    """A fresh interpreter's bare ``import repro_torch.solvers`` has every
    public name of ``repro.solvers`` (the seven submodules, SolverBackend,
    SolverFuture and the rest), without an import cycle."""
    out = subprocess.run(
        [sys.executable, "-c", "import repro_torch.solvers as s; print(' '.join(dir(s)))"],
        capture_output=True, text=True, timeout=120, check=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    got = set(out.stdout.split())
    want = {n for n in dir(jsolvers) if not n.startswith("_")}
    assert want <= got, sorted(want - got)
    for name in ("brute", "cobi", "greedy", "mcmc", "random_baseline", "sa", "tabu"):
        assert name in got
