"""repro_torch's core math, data and metrics against the JAX reference on the
same inputs: formulation (rtol 1e-6), rounding, repair, decomposition traces
and HashedBoW embeddings (bit for bit), exact reference bounds."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import decomposition as jdecomp
from repro.core import formulation as jform
from repro.core import kofn as jkofn
from repro.core import metrics as jmetrics
from repro.core import pipeline as jpipe
from repro.core import rounding as jround
from repro.core.hardware import COBI as JCOBI
from repro.data import synthetic as jsyn
from repro.embeddings import encoder as jenc
from repro_torch.core import decomposition as tdecomp
from repro_torch.core import formulation as tform
from repro_torch.core import kofn as tkofn
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rounding as tround
from repro_torch.core.hardware import SolverHardware
from repro_torch.data import synthetic as tsyn
from repro_torch.data import text as ttext
from repro_torch.embeddings import encoder as tenc
from repro_torch.interop import carry_across


def _problems(n, m=5, lam=0.5, seed=None):
    """The same EsProblem in both packages: mu, beta scored by the reference
    from numpy-seeded embeddings with a shared document direction."""
    rng = np.random.default_rng(n if seed is None else seed)
    e = rng.standard_normal((n, 48)) + 1.5 * rng.standard_normal(48)
    mu, beta = jsyn.scores_from_embeddings(jnp.asarray(e, jnp.float32))
    jp = jform.EsProblem(mu=mu, beta=beta, m=m, lam=lam)
    tp = carry_across("es", np.asarray(mu), np.asarray(beta), m=m, lam=lam, device="cpu")
    return jp, tp


def _key_pair(seed):
    k = jax.random.key(seed)
    return k, carry_across("key", np.asarray(jax.random.key_data(k)))


# ------------------------------------------------------------- formulation


@pytest.mark.parametrize("n", [7, 18, 20, 59])
@pytest.mark.parametrize("form", ["improved_ising", "original_ising"])
def test_formulation_matches(n, form):
    """h and J at rtol 1e-6; n = 18, 20 are even counts for the median."""
    jp, tp = _problems(n)
    want = getattr(jform, form)(jp)
    got = getattr(tform, form)(tp)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.j.numpy(), np.asarray(want.j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", [6, 7, 342])
def test_median_is_jnp_median(size):
    """Even counts average the two middle values, as jnp.median does."""
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32)
    assert float(tform.median(torch.from_numpy(x))) == float(jnp.median(x))


def test_qubo_and_gamma_match():
    jp, tp = _problems(12)
    assert tform.gamma_auto(tp) == jform.gamma_auto(jp)
    for name in ("qubo_improved", "qubo_original"):
        np.testing.assert_allclose(
            getattr(tform, name)(tp).q.numpy(), np.asarray(getattr(jform, name)(jp).q),
            rtol=1e-6, atol=0,
        )
    x = np.random.default_rng(0).integers(0, 2, (4, 12))
    np.testing.assert_allclose(
        tform.es_objective(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jform.es_objective(jp, jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("n", [20, 59, 70, 100])
def test_es_objective_of_a_selection_is_bitwise(n):
    """A decomposed solve reports es_objective of its final selection: the
    port sums in the reference's order, so the objective is its bit for bit."""
    jp = jsyn.synthetic_benchmark(n, n, 6, lam=0.5)
    tp = carry_across("es", np.asarray(jp.mu), np.asarray(jp.beta), m=6, lam=0.5,
                      device="cpu")
    rng = np.random.default_rng(n)
    for _ in range(5):
        x = np.zeros(n, np.float32)
        x[rng.choice(n, 6, replace=False)] = 1.0
        assert float(tform.es_objective(tp, torch.from_numpy(x))) == float(
            jform.es_objective(jp, jnp.asarray(x)))


def test_kofn_bias_matches():
    jp, tp = _problems(16)
    ji, ti = jform.original_ising(jp), tform.original_ising(tp)
    assert tkofn.kofn_bias(ti) == jkofn.kofn_bias(ji)


# --------------------------------------------------------------- rounding


@pytest.mark.parametrize("scheme", ["deterministic", "stochastic_5050", "stochastic"])
@pytest.mark.parametrize("n", [18, 59])
def test_quantize_ising_identical(scheme, n):
    jp, tp = _problems(n)
    ji, ti = jform.improved_ising(jp), tform.improved_ising(tp)
    for seed in range(3):
        jk, tk = _key_pair(seed)
        want = jround.quantize_ising(ji, scheme, key=jk)
        got = tround.quantize_ising(ti, scheme, key=tk)
        np.testing.assert_array_equal(got.ising.h.numpy(), np.asarray(want.ising.h))
        np.testing.assert_array_equal(got.ising.j.numpy(), np.asarray(want.ising.j))
        assert got.scale == want.scale


def test_quantize_ising_many_identical_and_bits():
    jp, tp = _problems(18)
    ji, ti = jform.improved_ising(jp), tform.improved_ising(tp)
    jkeys = jax.random.split(jax.random.key(4), 5)
    tkeys = [carry_across("key", np.asarray(jax.random.key_data(k))) for k in jkeys]
    want = jround.quantize_ising_many(ji, jkeys, "stochastic", bits=4)
    got = tround.quantize_ising_many(ti, tkeys, "stochastic", bits=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.ising.h.numpy(), np.asarray(w.ising.h))
        np.testing.assert_array_equal(g.ising.j.numpy(), np.asarray(w.ising.j))
    with pytest.raises(ValueError):
        tround.quantize_ising(ti, "stochastic")  # needs a key


# ------------------------------------------------------------ pipeline bits


@pytest.mark.parametrize("n,m", [(18, 5), (30, 9)])
def test_repair_selection_identical(n, m):
    jp, tp = _problems(n, m=m)
    rng = np.random.default_rng(n)
    for k in (0, 1, m - 1, m, m + 3, n):
        x = np.zeros(n, np.int32)
        x[rng.choice(n, k, replace=False)] = 1
        np.testing.assert_array_equal(
            tpipe.repair_selection(tp, x), jpipe.repair_selection(jp, x)
        )


def test_iteration_keys_identical():
    jk, tk = _key_pair(9)
    for (a, b), (c, d) in zip(jpipe._iteration_keys(jk, 5), tpipe._iteration_keys(tk, 5)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jax.random.key_data(a)))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jax.random.key_data(b)))


def _top_mu(mu, m):
    x = np.zeros(mu.shape[0], np.int32)
    x[np.argsort(mu, kind="stable")[::-1][:m]] = 1
    return x


@pytest.mark.parametrize("n,p,q", [(70, 20, 10), (45, 12, 6), (20, 20, 10)])
def test_decompose_steps_indexed_identical(n, p, q):
    """Same windows, kept sets and window keys, driven by the same
    deterministic sub-solver (top-m relevance)."""
    jp, tp = _problems(n, m=5, seed=100 + n)
    jk, tk = _key_pair(n)
    jgen = jdecomp.decompose_steps_indexed(jp, jk, p=p, q=q)
    tgen = tdecomp.decompose_steps_indexed(tp, tk, p=p, q=q)
    jitem, titem = next(jgen), next(tgen)
    while True:
        (jw, jsub, jm, jkey), (tw, tsub, tm, tkey) = jitem, titem
        np.testing.assert_array_equal(tw, jw)
        assert tm == jm
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(jax.random.key_data(jkey)))
        np.testing.assert_array_equal(tsub.mu.numpy(), np.asarray(jsub.mu))
        x = _top_mu(np.asarray(jsub.mu), jm)
        try:
            jitem = jgen.send(x)
        except StopIteration as done:
            jresult = done.value
            with pytest.raises(StopIteration) as tdone:
                tgen.send(x)
            break
        titem = tgen.send(x)
    (jsel, jtrace), (tsel, ttrace) = jresult, tdone.value.value
    np.testing.assert_array_equal(tsel, jsel)
    assert ttrace.num_solves == jtrace.num_solves
    for a, b in zip(ttrace.windows + ttrace.kept, jtrace.windows + jtrace.kept):
        np.testing.assert_array_equal(a, b)


def test_decompose_solve_matches():
    jp, tp = _problems(50, m=6, seed=3)
    jk, tk = _key_pair(1)
    jsel, jtr = jdecomp.decompose_solve(jp, lambda s, m, k: _top_mu(np.asarray(s.mu), m), jk)
    tsel, ttr = tdecomp.decompose_solve(tp, lambda s, m, k: _top_mu(s.mu.numpy(), m), tk)
    np.testing.assert_array_equal(tsel, jsel)
    assert ttr.num_solves == jtr.num_solves
    np.testing.assert_array_equal(tdecomp.window_indices(7, 5, 4), jdecomp.window_indices(7, 5, 4))


# --------------------------------------------------------- data, embeddings


@pytest.mark.parametrize("seed,n", [(0, 18), (7, 20), (3, 100)])
def test_hashed_bow_embeddings_identical(seed, n):
    sents = tsyn.synthetic_document(seed, n)
    assert sents == jsyn.synthetic_document(seed, n)
    got = tenc.HashedBowEncoder().encode(sents).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenc.HashedBowEncoder().encode(sents)))


def test_problem_from_sentences_matches():
    """mu and beta from the same embeddings: rtol 1e-5 (float32 matmul
    summation order differs between torch and XLA)."""
    sents = tsyn.synthetic_document(7, 20)
    want = jenc.problem_from_sentences(sents, m=6, lam=0.5)
    got = tenc.problem_from_sentences(sents, m=6, lam=0.5, device="cpu")
    assert (got.m, got.lam) == (want.m, want.lam)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=1e-5, atol=1e-6)


def test_split_sentences_matches():
    from repro.data import text as jtext

    text = "Officials met on Monday. Residents were relieved! Was it over? \"Yes,\" one said."
    assert ttext.split_sentences(text) == jtext.split_sentences(text)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("n,m", [(12, 4), (18, 5)])
def test_reference_bounds_exact_match(n, m):
    jp, tp = _problems(n, m=m)
    want, got = jmetrics.reference_bounds(jp), tmetrics.reference_bounds(tp)
    assert (got.obj_max, got.obj_min, got.exact) == (want.obj_max, want.obj_min, True)
    assert tmetrics.normalized_objective(0.5, got) == jmetrics.normalized_objective(0.5, want)


def test_reference_bounds_tabu_branch_not_ported():
    _, tp = _problems(40, m=12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmetrics.reference_bounds(tp)


def test_tts_ets_match():
    hw = SolverHardware(**{f: getattr(JCOBI, f) for f in
                           ("name", "seconds_per_solve", "solver_power_w",
                            "host_eval_seconds", "host_power_w")})
    firsts = [1.0, 3.0, float("inf"), 2.0]
    p = tmetrics.success_probability(firsts)
    assert p == jmetrics.success_probability(firsts)
    assert tmetrics.tts_seconds(p, hw) == jmetrics.tts_seconds(p, JCOBI)
    assert tmetrics.ets_joules(p, hw) == jmetrics.ets_joules(p, JCOBI)
    curve = np.array([0.5, 0.85, 0.95])
    assert tmetrics.first_success_iteration(curve) == jmetrics.first_success_iteration(curve)


def test_energy_selection_and_rebalance_match():
    jp, tp = _problems(14)
    ji, ti = jform.improved_ising(jp), tform.improved_ising(tp)
    s = np.where(np.random.default_rng(2).random((6, 14)) < 0.5, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(
        tform.ising_energy(ti.h, ti.j, torch.from_numpy(s)).numpy(),
        np.asarray(jform.ising_energy(ji.h, ji.j, jnp.asarray(s))), rtol=1e-6, atol=1e-5,
    )
    for dtype in (np.int8, np.float32):
        np.testing.assert_array_equal(
            tform.spins_to_selection(torch.from_numpy(s.astype(dtype))).numpy(),
            np.asarray(jform.spins_to_selection(jnp.asarray(s.astype(dtype)))),
        )
    (tr, tc), (jr, jc) = tkofn.rebalance_ising(ti), jkofn.rebalance_ising(ji)
    assert tc == jc
    np.testing.assert_allclose(tr.h.numpy(), np.asarray(jr.h), rtol=1e-6, atol=1e-6)
    (tq, tc), (jq, jc) = (tkofn.rebalance_qubo(tform.qubo_original(tp)),
                          jkofn.rebalance_qubo(jform.qubo_original(jp)))
    assert tc == jc
    np.testing.assert_allclose(tq.q.numpy(), np.asarray(jq.q), rtol=1e-6, atol=1e-6)


def test_brute_registry_solver_matches():
    from repro.solvers import brute as jbrute
    from repro_torch.solvers import ISING_SOLVER_NAMES, ising_solver

    assert ISING_SOLVER_NAMES == ("brute", "cobi", "mcmc")
    jp, tp = _problems(12)
    ji, ti = jform.improved_ising(jp), tform.improved_ising(tp)
    want = jbrute.solve_ising(ji)
    got = ising_solver("brute")(ti, None, reads=4)
    np.testing.assert_array_equal(got.spins.numpy(), np.asarray(want.spins))
    np.testing.assert_array_equal(got.energies.numpy(), np.asarray(want.energies))
    with pytest.raises(ValueError, match="unknown Ising solver"):
        ising_solver("anneal9000")


def test_brute_hardware_and_documents_match(tmp_path):
    from repro.core.hardware import brute_hardware as jbrute_hw
    from repro.data import text as jtext
    from repro_torch.core.hardware import brute_hardware

    assert dataclasses.asdict(brute_hardware(1234)) == dataclasses.asdict(jbrute_hw(1234))
    (tmp_path / "a.txt").write_text("One sentence here. Another one follows! A third?")
    (tmp_path / "b.txt").write_text("Too short.")
    paths = sorted(tmp_path.iterdir())
    assert ttext.load_documents(paths) == jtext.load_documents(paths)
