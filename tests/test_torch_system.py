"""The port's slice as a whole on the CPU: text or reference state in, an
M-sentence summary out, through repro_torch's solve_es with the kernels'
plain versions, held against the JAX package on the same keys.

Bars: the per-iteration keys and rounded instances are the reference's bit
for bit; the direct solve reaches normalized objective > 0.8 (the
reference's own bar) and comes within 0.05 of the reference's objective on
every seed; the decomposed solve selects exactly M.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import SolveConfig as JSolveConfig
from repro.core import pipeline as jpipe
from repro.core import solve_es as jsolve_es
from repro.core.formulation import EsProblem as JEsProblem
from repro.core.formulation import improved_ising as jimproved
from repro.core.metrics import normalized_objective, reference_bounds
from repro.data.synthetic import (
    scores_from_embeddings,
    synthetic_benchmark,
    synthetic_embeddings,
)
from repro_torch.core import SolveConfig, improved_ising, solve_es
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pipeline as tpipe
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import problem_from_sentences
from repro_torch.interop import carry_across

CFG = dict(solver="cobi", iterations=4, reads=8, int_range=14, steps=300)


def _system_instance():
    """tests/test_system.py's document instance: N=18, M=5, lambda=0.5."""
    e = synthetic_embeddings(jax.random.key(0), 18, dim=48)
    mu, beta = scores_from_embeddings(e)
    jp = JEsProblem(mu=mu, beta=beta, m=5, lam=0.5)
    return jp, carry_across("es", np.asarray(mu), np.asarray(beta), m=5, lam=0.5,
                           device="cpu")


def _key(k):
    return carry_across("key", np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_direct_solve_matches_reference(seed):
    jp, tp = _system_instance()
    jcfg, tcfg = JSolveConfig(**CFG), SolveConfig(**CFG)
    jkey = jax.random.key(seed)

    ji, ti = jimproved(jp), improved_ising(tp)
    pairs = zip(jpipe._iteration_keys(jkey, 4), tpipe._iteration_keys(_key(jkey), 4))
    for (jq, js), (tq, ts) in pairs:
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jax.random.key_data(jq)))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jax.random.key_data(js)))
        want = jpipe._quantized_instance(ji, jcfg, jq)
        got = tpipe._quantized_instance(ti, tcfg, tq)
        np.testing.assert_array_equal(got.h.numpy(), np.asarray(want.h))
        np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))

    rep = solve_es(tp, _key(jkey), tcfg, device="cpu")
    ref = jsolve_es(jp, jkey, jcfg)
    assert rep.selection.sum() == 5 and rep.solver_invocations == 4
    b = reference_bounds(jp)
    got, want = normalized_objective(rep.objective, b), normalized_objective(ref.objective, b)
    assert got > 0.8
    assert abs(got - want) <= 0.05
    assert np.all(np.diff(rep.curve) >= 0)


def test_text_to_summary_on_cpu():
    """Text -> HashedBoW -> mu/beta -> Ising -> anneal -> 6-sentence summary."""
    sents = synthetic_document(7, 20)
    p = problem_from_sentences(sents, m=6, lam=0.5, device="cpu")
    rep = solve_es(p, _key(jax.random.key(0)), SolveConfig(**CFG), device="cpu")
    summary = [sents[i] for i in np.nonzero(rep.selection)[0]]
    assert len(summary) == 6
    assert tmetrics.normalized_objective(rep.objective, tmetrics.reference_bounds(p)) > 0.8


def test_decomposed_solve_selects_m():
    """tests/test_system.py's oversized instance: N=70 > 59 spins."""
    jp = synthetic_benchmark(5, 70, 6, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=6, lam=0.5,
                      device="cpu")
    cfg = SolveConfig(solver="cobi", iterations=2, reads=6, int_range=14, steps=250,
                      decompose=True, p=20, q=10)
    rep = solve_es(tp, _key(jax.random.key(2)), cfg, device="cpu")
    assert rep.selection.sum() == 6
    assert np.isfinite(rep.objective)
    assert rep.solver_invocations == 2 * 6  # 5 windows + the final solve


@pytest.mark.parametrize("solver", ["brute", "exact"])
def test_enumeration_solvers_match(solver):
    jp, tp = _system_instance()
    ref = jsolve_es(jp, jax.random.key(0), JSolveConfig(solver=solver))
    rep = solve_es(tp, _key(jax.random.key(0)), SolveConfig(solver=solver), device="cpu")
    np.testing.assert_array_equal(rep.selection, ref.selection)
    assert rep.objective == ref.objective


def test_solve_es_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, tp = _system_instance()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_es(tp, _key(jax.random.key(0)), SolveConfig(**CFG))


@pytest.mark.parametrize("entry", ["bits", "uniform", "problem_from_sentences", "carry_across",
                                   "uniform_many", "CobiFarm", "solve_many", "solve_batch",
                                   "McmcPoolBackend", "solve_es_mcmc"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` every entry point that makes tensors asks for the
    card, and raises here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch import prng
    from repro_torch.farm import CobiFarm, McmcPoolBackend, solve_many
    from repro_torch.solvers.cobi import solve_batch

    _, tp = _system_instance()
    ising = improved_ising(tp)
    calls = {
        "bits": lambda: prng.bits(prng.key(0), (4,)),
        "uniform": lambda: prng.uniform(prng.key(0), (4,)),
        "problem_from_sentences": lambda: problem_from_sentences(
            synthetic_document(7, 8), m=3),
        "carry_across": lambda: carry_across("es", np.ones(3), np.eye(3), m=1, lam=0.5),
        "uniform_many": lambda: prng.uniform_many(prng.split(prng.key(0), 2), (4,)),
        "CobiFarm": lambda: CobiFarm(2),
        "solve_many": lambda: solve_many([ising], [prng.key(0)], check=False),
        "solve_batch": lambda: solve_batch([ising], [prng.key(0)], check=False),
        "McmcPoolBackend": lambda: McmcPoolBackend(),
        "solve_es_mcmc": lambda: solve_es(tp, prng.key(0), SolveConfig(solver="mcmc")),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    if entry == "McmcPoolBackend":
        McmcPoolBackend(device="cpu").close()
    if entry == "solve_es_mcmc":
        cfg = SolveConfig(solver="mcmc", iterations=1, reads=8, steps=16)
        assert solve_es(tp, prng.key(0), cfg, device="cpu").selection.sum() == tp.m


@pytest.mark.parametrize("solver", ["tabu", "sa", "random"])
def test_unported_solvers_name_their_roadmap_item(solver):
    _, tp = _system_instance()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_es(tp, _key(jax.random.key(0)), SolveConfig(solver=solver), device="cpu")
