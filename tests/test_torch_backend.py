"""The port's backend-driven pipeline on the CPU: ``solve_es`` through the
chip farm against the port's inline ``solve_es``, the pipelined window
planner against the reference's, the farm path's quality and receipts
against the JAX farm's, and fault recovery.

Bars: the backend path equals the inline path bit for bit (selection,
objective, curve), direct and decomposed, pipelined or lockstep; the planner
gives the reference's window plan and final selection for the same
sub-solver; the backend objective is within 0.05 (normalized) of the JAX
farm path's on the same keys and its receipts equal the JAX farm's; a
recovered run equals the fault-free run bit for bit.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import SolveConfig as JSolveConfig
from repro.core import solve_es as jsolve_es
from repro.core.decomposition import PipelinedDecomposition as JPlan
from repro.core.decomposition import decompose_solve as jdecompose_solve
from repro.core.decomposition import guess_top_mu as jguess
from repro.core.metrics import normalized_objective, reference_bounds
from repro.data.synthetic import synthetic_benchmark
from repro.farm import CobiFarm as JFarm
from repro_torch.core import SolveConfig, pipeline, solve_es
from repro_torch.core.decomposition import PipelinedDecomposition, guess_top_mu
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import problem_from_sentences
from repro_torch.farm import CobiFarm, FarmFault, FaultPlan
from repro_torch.interop import carry_across

CFG = dict(solver="cobi", iterations=3, reads=8, int_range=14, steps=80)


def _key(k):
    return carry_across("key", np.asarray(jax.random.key_data(k)))


def _doc(seed, n, m=5):
    return problem_from_sentences(synthetic_document(seed, n), m=m, lam=0.5, device="cpu")


def _same(a, b):
    return (np.array_equal(a.selection, b.selection) and a.objective == b.objective
            and np.array_equal(a.curve, b.curve))


def _farm(**kw):
    return CobiFarm(4, device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_backend_solve_es_equals_inline(seed):
    p = _doc(7 + seed, 20)
    cfg = SolveConfig(**CFG)
    inline = solve_es(p, _key(jax.random.key(seed)), cfg, device="cpu")
    farm = _farm()
    rep = solve_es(p, _key(jax.random.key(seed)), cfg, device="cpu", backend=farm)
    assert _same(inline, rep) and rep.solver_invocations == cfg.iterations
    st = farm.stats()
    assert st.drains == 1 and st.jobs_completed == cfg.iterations
    assert rep.bytes_h2d == st.bytes_h2d and rep.bytes_d2h == st.bytes_d2h
    assert rep.chip_seconds > 0 and rep.sim_completed == st.sim_seconds


@pytest.mark.parametrize("pipelined", [True, False])
def test_backend_decomposed_solve_equals_inline(pipelined):
    p = _doc(11, 64, m=6)
    cfg = SolveConfig(**{**CFG, "iterations": 2}, decompose=True, p=20, q=10,
                      pipeline_windows=pipelined)
    key = _key(jax.random.key(4))
    inline = solve_es(p, key, cfg, device="cpu")
    rep = solve_es(p, key, cfg, device="cpu", farm=_farm())
    assert np.array_equal(inline.selection, rep.selection)
    assert inline.objective == rep.objective and rep.selection.sum() == 6


def test_lockstep_generators_share_drains_and_equal_inline():
    """Three documents driven in lockstep through one manual farm: one drain
    for all of them, each report equal to its inline solve."""
    docs = [_doc(20 + i, n) for i, n in enumerate([12, 18, 25])]
    keys = [_key(jax.random.key(30 + i)) for i in range(3)]
    cfg = SolveConfig(**CFG)
    farm = _farm()
    gens = [pipeline.iter_solve_es(d, k, cfg, backend=farm) for d, k in zip(docs, keys)]
    for g in gens:
        next(g)
    farm.drain()
    reports = []
    for g in gens:
        with pytest.raises(StopIteration) as done:
            g.send(None)
        reports.append(done.value.value)
    assert farm.stats().drains == 1
    for d, k, rep in zip(docs, keys, reports):
        assert _same(solve_es(d, k, cfg, device="cpu"), rep)


# ------------------------------------------------------ pipelined planner


@functools.lru_cache(maxsize=None)
def _planner_pair(seed, n, m):
    jp = synthetic_benchmark(seed, n, m, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=m, lam=0.5, device="cpu")
    return jp, tp


def _brute(sub, m, _key):
    """The sub-solver both planners get: exact best m-subset by enumeration
    in host float64 (first best on ties), on either package's EsProblem."""
    mu = np.asarray(sub.mu, np.float64)
    beta = np.asarray(sub.beta, np.float64)
    combos = np.array(list(itertools.combinations(range(mu.shape[0]), m)))
    x = np.zeros((len(combos), mu.shape[0]), np.int32)
    np.put_along_axis(x, combos, 1, axis=1)
    obj = x @ mu - sub.lam * np.einsum("ci,ij,cj->c", x, beta, x)
    return x[int(np.argmax(obj))]


@pytest.mark.parametrize("speculate", [True, False])
def test_pipelined_planner_matches_reference(speculate):
    """Same window plan (memberships, budgets, keys, speculative flags) at
    every resolve step and the same final selection as the reference's
    planner, for the same sub-solver."""
    jp, tp = _planner_pair(1, 85, 5)
    jkey = jax.random.key(2)
    jplan = JPlan(jp, jkey, p=12, q=6, speculate=speculate)
    tplan = PipelinedDecomposition(tp, _key(jkey), p=12, q=6, speculate=speculate)

    def plan_of(plan, words):
        return [(s.seq, s.indices, s.m, tuple(words(s.key)), s.speculative)
                for s in plan.pending_specs()]

    jwords = lambda k: np.asarray(jax.random.key_data(k)).tolist()
    twords = lambda k: k.tolist()
    while not jplan.done():
        assert plan_of(tplan, twords) == plan_of(jplan, jwords)
        js, ts = jplan.next_spec(), tplan.next_spec()
        jplan.resolve(_brute(jp.subproblem(np.asarray(js.indices)), js.m, js.key))
        tplan.resolve(_brute(tp.subproblem(np.asarray(ts.indices)), ts.m, ts.key))
    assert tplan.done()
    np.testing.assert_array_equal(tplan.final[0], jplan.final[0])
    assert (tplan.replans, tplan.mispeculations) == (jplan.replans, jplan.mispeculations)
    want, _ = jdecompose_solve(jp, _brute, jax.random.key(2), p=12, q=6)
    np.testing.assert_array_equal(tplan.final[0], want)


def test_pipelined_planner_plans_whole_first_pass():
    jp, tp = _planner_pair(1, 85, 5)
    want = JPlan(jp, jax.random.key(0), p=20, q=10).pending_specs()
    got = PipelinedDecomposition(tp, _key(jax.random.key(0)), p=20, q=10).pending_specs()
    assert len(got) == len(want) == 8
    assert [(s.indices, s.speculative) for s in got] == [(s.indices, s.speculative) for s in want]
    assert sorted(i for s in got if not s.speculative for i in s.indices) == list(range(80))
    np.testing.assert_array_equal(guess_top_mu(tp, 7), jguess(jp, 7))


# --------------------------------------------------- against the JAX farm


def test_backend_path_close_to_jax_farm_and_bills_the_same():
    """Same document and keys through both farms: normalized objectives
    within 0.05, and the same receipts (chip time, energy, bytes, sim
    clock), which depend on shapes and placement alone."""
    jp = synthetic_benchmark(3, 18, 5, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=5, lam=0.5, device="cpu")
    jkey = jax.random.key(6)
    cfg = dict(CFG, iterations=4, steps=300)
    ref = jsolve_es(jp, jkey, JSolveConfig(**cfg), backend=JFarm(4, impl="ref"))
    rep = solve_es(tp, _key(jkey), SolveConfig(**cfg), device="cpu", backend=_farm())
    b = reference_bounds(jp)
    assert abs(normalized_objective(rep.objective, b) - normalized_objective(ref.objective, b)) <= 0.05
    for name in ("chip_seconds", "chip_energy_joules", "bytes_h2d", "bytes_d2h",
                 "sim_completed", "solver_invocations"):
        assert getattr(rep, name) == getattr(ref, name), name


# ----------------------------------------------------------- recovery


class StubRecovery:
    """The recovery surface ``_reduce_with_recovery`` takes: retry on the
    same backend, or fail over to ``spare`` once."""

    retryable = FarmFault
    failover_name = "spare"

    def __init__(self, spare=None, give_up_after=50):
        self.spare, self.give_up_after, self.faults = spare, give_up_after, []

    def note_fault(self, exc):
        self.faults.append(type(exc).__name__)

    def decide(self, attempt, exc, *, failed_over=False):
        if attempt >= self.give_up_after:
            raise RuntimeError(f"gave up after {attempt} attempts") from exc
        return self.spare if (self.spare is not None and not failed_over) else None


@pytest.mark.parametrize("how", ["retry", "failover"])
def test_recovery_retries_farm_faults_to_the_fault_free_result(how):
    p = _doc(9, 20)
    cfg = SolveConfig(**{**CFG, "iterations": 4})
    key = _key(jax.random.key(1))
    clean = solve_es(p, key, cfg, device="cpu", backend=_farm())
    faulty = _farm(faults=FaultPlan(seed=4, chip_transient_rate=0.5))
    spare = _farm(policy="timer", timer_interval=0.005) if how == "failover" else None
    stub = StubRecovery(spare)
    rep = pipeline.drive_with_backend(
        pipeline.iter_solve_es(p, key, cfg, backend=faulty, recovery=stub), faulty)
    assert stub.faults and set(stub.faults) == {"ChipFailure"}
    assert _same(clean, rep)
    if how == "failover":
        assert rep.backend_jobs == {"spare": len(stub.faults)}
        spare.close()


def test_recovery_that_gives_up_raises_and_strands_nothing():
    p = _doc(9, 20)
    farm = _farm(faults=FaultPlan(seed=0, failed_chips=(0, 1, 2, 3)))
    gen = pipeline.iter_solve_es(p, _key(jax.random.key(1)), SolveConfig(**CFG),
                                 backend=farm, recovery=StubRecovery(give_up_after=1))
    with pytest.raises(RuntimeError, match="gave up"):
        pipeline.drive_with_backend(gen, farm)
    assert farm.pending_jobs() == 0


def test_route_hook_and_argument_errors():
    p = _doc(7, 20)
    cfg = SolveConfig(**CFG)
    farm = _farm()
    route = lambda n, reads: ("farm4", farm, None, 0.25)
    rep = pipeline.drive_with_backend(
        pipeline.iter_solve_es(p, _key(jax.random.key(0)), cfg, backend=farm, route=route), farm)
    assert rep.backend_jobs == {"farm4": cfg.iterations}
    (w,) = rep.windows
    assert dataclasses.astuple(w) == ("farm4", 0.25, rep.chip_seconds, rep.chip_energy_joules,
                                      cfg.iterations)
    with pytest.raises(ValueError, match="backend"):
        next(pipeline.iter_solve_es(p, _key(jax.random.key(0)), cfg))
    with pytest.raises(ValueError, match="registry solver"):
        next(pipeline.iter_solve_es(p, _key(jax.random.key(0)),
                                    SolveConfig(solver="exact"), backend=farm))
