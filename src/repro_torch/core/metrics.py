"""Evaluation metrics: normalized objective (Eq. 13), TTS (Eqs. 14-15),
ETS (Eq. 16)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.formulation import (
    EsProblem,
    es_objective,
    improved_ising,
    spins_to_selection,
)
from repro_torch.core.hardware import SolverHardware
from repro_torch.solvers import brute

ENUM_LIMIT = 2_000_000


@dataclasses.dataclass(frozen=True)
class Bounds:
    obj_max: float
    obj_min: float
    exact: bool  # True if from exact enumeration (Gurobi-equivalent)


def reference_bounds(problem: EsProblem, key: Optional[torch.Tensor] = None) -> Bounds:
    """Ground-truth obj_max/obj_min over |x| = M.

    Exact enumeration for C(N, M) <= ENUM_LIMIT; otherwise long
    multi-restart FP Tabu on the penalty form (32 replicas, 30 N steps, on
    the problem's device), maximizing and minimizing (the negated problem),
    with greedy repair, as the reference does.  The Tabu bounds come from
    float32 products summed in another order than XLA's, so they agree with
    the reference's within rtol 1e-5, not bit for bit.
    """
    if brute.num_candidates(problem.n, problem.m) <= ENUM_LIMIT:
        hi, _, lo, _ = brute.exact_constrained_bounds(problem)
        return Bounds(obj_max=hi, obj_min=lo, exact=True)

    from repro_torch.core.pipeline import repair_selection
    from repro_torch.solvers import tabu

    if key is None:
        key = prng.key(0)

    def _extremum(p: EsProblem, k) -> float:
        res = tabu.solve(improved_ising(p), k, replicas=32, iters=30 * p.n)
        xs = spins_to_selection(res.spins).cpu().numpy()
        xs = np.stack([repair_selection(p, x) for x in xs])
        return float(torch.max(es_objective(p, torch.from_numpy(xs))))

    k1, k2 = prng.split(key)
    obj_max = _extremum(problem, k1)
    neg = EsProblem(mu=-problem.mu, beta=-problem.beta, m=problem.m, lam=problem.lam)
    obj_min = -_extremum(neg, k2)
    return Bounds(obj_max=obj_max, obj_min=obj_min, exact=False)


def normalized_objective(obj: float | np.ndarray, bounds: Bounds) -> np.ndarray:
    """Eq. (13): (obj - obj_min) / (obj_max - obj_min)."""
    span = max(bounds.obj_max - bounds.obj_min, 1e-12)
    return (np.asarray(obj) - bounds.obj_min) / span


# ---------------------------------------------------------------------------
# TTS / ETS  (Eqs. 14-16)
# ---------------------------------------------------------------------------


def success_probability(first_success_iters: Sequence[float]) -> float:
    """Eq. (14): MLE of the per-iteration success probability from the
    iteration counts at which each benchmark first reaches the threshold."""
    ks = np.asarray([k for k in first_success_iters if np.isfinite(k)], np.float64)
    if ks.size == 0:
        return 0.0
    return 1.0 / float(np.mean(np.maximum(ks, 1.0)))


def tts_seconds(
    p_success: float,
    hw: SolverHardware,
    *,
    p_target: float = 0.95,
    include_host_eval: bool = True,
) -> float:
    """Eq. (15): TTS = ln(1-p_target)/ln(1-p_success) * runtime-per-iteration,
    one solve plus (optionally) one host objective evaluation per iteration."""
    if p_success <= 0.0:
        return float("inf")
    per_iter = hw.seconds_per_solve + (hw.host_eval_seconds if include_host_eval else 0.0)
    if p_success >= 1.0:
        return per_iter
    n_iters = np.log(1.0 - p_target) / np.log(1.0 - p_success)
    return float(n_iters * per_iter)


def ets_joules(p_success: float, hw: SolverHardware, *, p_target: float = 0.95) -> float:
    """Eq. (16): solver TTS x solver power + host-eval TTS x host power."""
    if p_success <= 0.0:
        return float("inf")
    if p_success >= 1.0:
        n_iters = 1.0
    else:
        n_iters = np.log(1.0 - p_target) / np.log(1.0 - p_success)
    solver_time = n_iters * hw.seconds_per_solve
    host_time = n_iters * hw.host_eval_seconds
    return float(solver_time * hw.solver_power_w + host_time * hw.host_power_w)


def first_success_iteration(normalized_curve: np.ndarray, threshold: float = 0.9) -> float:
    """Index (1-based) at which a best-so-far curve first reaches threshold."""
    idx = np.nonzero(np.asarray(normalized_curve) >= threshold)[0]
    return float(idx[0] + 1) if idx.size else float("inf")
