"""Evaluation metrics: normalized objective (Eq. 13), TTS (Eqs. 14-15),
ETS (Eq. 16)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.formulation import EsProblem
from repro_torch.core.hardware import SolverHardware
from repro_torch.solvers import brute

ENUM_LIMIT = 2_000_000


@dataclasses.dataclass(frozen=True)
class Bounds:
    obj_max: float
    obj_min: float
    exact: bool  # True if from exact enumeration (Gurobi-equivalent)


def reference_bounds(problem: EsProblem, key=None) -> Bounds:
    """Ground-truth obj_max/obj_min over |x| = M by exact enumeration, for
    C(N, M) <= ENUM_LIMIT.  Larger instances need the reference's Tabu
    fallback, which is not ported yet."""
    del key  # seeds only the Tabu fallback
    if brute.num_candidates(problem.n, problem.m) <= ENUM_LIMIT:
        hi, _, lo, _ = brute.exact_constrained_bounds(problem)
        return Bounds(obj_max=hi, obj_min=lo, exact=True)
    raise NotImplementedError(
        f"C({problem.n}, {problem.m}) exceeds exact enumeration; the Tabu "
        "fallback of reference_bounds ports with Tabu (ROADMAP queue 1: host solvers)"
    )


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
