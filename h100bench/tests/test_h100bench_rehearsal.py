"""CPU rehearsals of a run of each cell through the harness (tiny sizes, the
kernels' plain versions), and the faults the comparison must catch: the
rest of a run driven with the timed path broken underneath, past the
harness's look for a chip."""

from __future__ import annotations

import math

import numpy as np
import pytest

from h100bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_run_yields_the_result_line(cell):
    trace = cell.endswith("news-batch") and cell.startswith("es-sbert")
    out = tiny.run(cell, trace=trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 1
    want = {m["name"] for m in __import__("h100bench.harness", fromlist=["x"]).cell_metrics(
        tiny.REHEARSAL, cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    else:
        assert {"solve_ms_p50", "encode_wait_ms_p50", "farm_jobs_per_drain"} <= set(out["metrics"])
        assert "breakdown" in out


def _drop_one(report):
    """An answer altered where it is produced: one selected sentence dropped."""
    sel = report.selection.copy()
    sel[np.nonzero(sel)[0][-1]] = 0
    report.selection = sel


def _swap_ends(report):
    """An answer altered where it is produced, its size kept: the selection
    moved to the document's last sentences, the objective left as it was."""
    sel = np.zeros_like(report.selection)
    sel[-int(report.selection.sum()):] = 1
    report.selection = sel


@pytest.mark.parametrize("fault", [_drop_one, _swap_ends])
def test_an_altered_answer_is_not_correct(fault, monkeypatch):
    from repro_torch.serving import engine

    real = engine.iter_solve_es

    def broken(*args, **kwargs):
        report = yield from real(*args, **kwargs)
        fault(report)
        return report

    monkeypatch.setattr(engine, "iter_solve_es", broken)
    out = tiny.run("es-bow-cobi.news-batch")
    assert out["attempted"] > 0 and not out["correct"]
    assert math.isfinite(out["checks"]["mu_beta_gap"]["value"])  # answers were judged


def test_altered_embeddings_are_not_correct(monkeypatch):
    """The encoder's output altered where it is produced: each sentence gets
    its neighbour's embedding."""
    from repro_torch.embeddings import serving

    real = serving._embed_batch

    def broken(*args):
        return torch_roll(real(*args))

    def torch_roll(emb):
        import torch

        return torch.roll(emb, 1, dims=1)

    monkeypatch.setattr(serving, "_embed_batch", broken)
    out = tiny.run("es-sbert-cobi.news-batch")
    assert out["attempted"] > 0 and not out["correct"]
    assert out["checks"]["objective_gap"]["value"] > out["checks"]["objective_gap"]["limit"]


# Faults of what the solver is handed and answers, each planted where the
# program produces it: (cell, the number that must catch it, the plant).

def _no_bias(monkeypatch):
    """The formulation without Eq. 12's bias: the original QUBO's Ising form."""
    from repro_torch.core import formulation, pipeline

    real = formulation.improved_ising
    monkeypatch.setattr(pipeline, "improved_ising",
                        lambda problem, gamma=None, mu_b=None: real(problem, gamma, 0.0))


def _half_range(monkeypatch):
    """The rounding onto [-7, 7] where the configuration states [-14, 14]."""
    from repro_torch.core import pipeline

    real = pipeline.quantize_ising_many

    def broken(ising, keys, scheme="stochastic", *, int_range=14, bits=None):
        return real(ising, keys, scheme, int_range=int_range // 2, bits=bits)

    monkeypatch.setattr(pipeline, "quantize_ising_many", broken)


def _rounded_alike(monkeypatch):
    """Every iteration rounded to nearest: the stochastic draws left out."""
    from repro_torch.core import pipeline

    real = pipeline.quantize_ising_many
    monkeypatch.setattr(pipeline, "quantize_ising_many",
                        lambda ising, keys, scheme="stochastic", **kw:
                        real(ising, keys, "deterministic", **kw))


def _spin_flipped(monkeypatch):
    """The farm's answer altered where it is produced: the first lane of each
    packed best read flipped after the kernel scored it."""
    from repro_torch.kernels import ops

    real = ops.cobi_anneal_packed_best

    def broken(*args, **kwargs):
        e, spins = real(*args, **kwargs)
        spins = spins.clone()
        spins[..., 0] = -spins[..., 0]
        return e, spins

    monkeypatch.setattr(ops, "cobi_anneal_packed_best", broken)


def _window_dropped(monkeypatch):
    """The decomposition's first window dropped: its survivors taken by
    relevance, never handed to the solver."""
    from repro_torch.core import decomposition

    real = decomposition.decompose_steps_indexed

    def broken(problem, key, *, p=20, q=10):
        gen = real(problem, key, p=p, q=q)
        window, sub, m, k = item = next(gen)
        if len(window) < problem.n:
            item = gen.send(decomposition.guess_top_mu(sub, m))
        while True:
            x = yield item
            try:
                item = gen.send(x)
            except StopIteration as done:
                return done.value

    monkeypatch.setattr(decomposition, "decompose_steps_indexed", broken)


SOLVER_FAULTS = {
    "no_bias": ("es-bow-cobi.news-batch", "formulation_gap", _no_bias),
    "half_range": ("es-bow-cobi.news-batch", "rounding_faults", _half_range),
    "rounded_alike": ("es-bow-cobi.news-batch", "rounding_faults", _rounded_alike),
    "spin_flipped": ("es-bow-cobi.news-batch", "energy_faults", _spin_flipped),
    "window_dropped": ("es-bow-cobi.long-decomposed", "window_faults", _window_dropped),
}


@pytest.mark.parametrize("fault", sorted(SOLVER_FAULTS))
def test_a_fault_of_what_the_solver_sees_is_not_correct(fault, monkeypatch):
    cell, number, plant = SOLVER_FAULTS[fault]
    plant(monkeypatch)
    out = tiny.run(cell)
    assert out["attempted"] > 0 and not out["correct"]
    # The answers themselves were judged sound: only the fault's number trips.
    assert out["checks"]["bad_answers"]["value"] == 0, out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]
