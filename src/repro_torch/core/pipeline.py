"""End-to-end ES solve pipeline (paper Sec. V): improved formulation ->
stochastic rounding -> integer Ising -> solver -> best-of-iterations under
the FP objective -> optional decomposition driver.

The inline path of ``repro.core.pipeline.solve_es``: per-iteration solver
dispatch goes through the :mod:`repro_torch.solvers.base` registry.  The
formulation, rounding and anneals run on the card (``device="cuda"``, the
default) or, when the caller asks for it, on the CPU with the kernels' plain
versions.  Greedy repair and the best-of reduce run in host numpy, as in the
reference.  The backend-scheduled drivers (``iter_solve_es``,
``drive_with_backend``) port with the chip farm (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import decomposition as decomp
from repro_torch.core.formulation import (
    EsProblem,
    IsingProblem,
    es_objective,
    improved_ising,
    original_ising,
)
from repro_torch.core.rounding import COBI_RANGE, quantize_ising
from repro_torch.device import resolve_device
from repro_torch.solvers import base as solver_base
from repro_torch.solvers import brute as brute_solver


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Knobs of the hardware-aware ES pipeline (the reference's inline-path
    fields; the farm's window-pipelining knobs port with the farm)."""

    solver: str = "cobi"  # cobi | brute | exact
    formulation: str = "improved"  # improved | original
    rounding: str = "stochastic"  # deterministic | stochastic_5050 | stochastic
    int_range: Optional[int] = COBI_RANGE  # None -> no quantization (FP solve)
    bits: Optional[int] = None  # overrides int_range when set
    iterations: int = 10  # solver invocations (paper's definition)
    reads: int = 8  # anneals / restarts per invocation
    gamma: Optional[float] = None  # None -> gamma_auto
    repair: bool = True  # greedy-repair cardinality before evaluating
    steps: int = 400  # COBI anneal steps
    decompose: bool = False
    p: int = 20
    q: int = 10


@dataclasses.dataclass
class SolveReport:
    selection: np.ndarray  # (N,) {0,1}
    objective: float  # FP Eq. (3) objective of `selection`
    curve: np.ndarray  # best-so-far FP objective after each iteration
    solver_invocations: int


def repair_selection(problem: EsProblem, x: np.ndarray) -> np.ndarray:
    """Greedy add/remove to reach cardinality M (marginal-gain ordered), with
    the gain vector updated incrementally by one O(N) axpy per flip."""
    x = np.asarray(x, np.int32).copy()
    k = int(x.sum())
    if k == problem.m:
        return x
    mu = problem.mu.detach().cpu().numpy().astype(np.float64)
    beta = problem.beta.detach().cpu().numpy().astype(np.float64)
    lam2 = 2.0 * problem.lam
    # score_i = mu_i - 2*lam*(beta x)_i: removing selected i loses score_i,
    # adding unselected i gains score_i (beta has zero diagonal).
    score = mu - lam2 * (beta @ x)
    buf = np.empty_like(score)
    if k > problem.m:
        contrib = np.where(x > 0, score, np.inf)
        while k > problem.m:
            i = int(np.argmin(contrib))
            x[i] = 0
            k -= 1
            np.multiply(beta[i], lam2, out=buf)  # symmetric: row i == col i
            contrib += buf  # every remaining red_j drops by beta_ij
            contrib[i] = np.inf
    else:
        gain = np.where(x > 0, -np.inf, score)
        while k < problem.m:
            i = int(np.argmax(gain))
            x[i] = 1
            k += 1
            np.multiply(beta[i], lam2, out=buf)
            gain -= buf  # every remaining red_j grows by beta_ij
            gain[i] = -np.inf
    return x


def _build_ising(problem: EsProblem, cfg: SolveConfig) -> IsingProblem:
    if cfg.formulation == "improved":
        return improved_ising(problem, gamma=cfg.gamma)
    if cfg.formulation == "original":
        return original_ising(problem, gamma=cfg.gamma)
    raise ValueError(f"unknown formulation {cfg.formulation!r}")


def _objective_np(problem: EsProblem, x: np.ndarray) -> float:
    """Eq. (3) in host float32, as the reference's per-iteration reduce."""
    mu = problem.mu.detach().cpu().numpy().astype(np.float32)
    beta = problem.beta.detach().cpu().numpy().astype(np.float32)
    xf = x.astype(np.float32)
    return float(xf @ mu - np.float32(problem.lam) * (xf @ (beta @ xf)))


def _best_selection(result) -> np.ndarray:
    """argmin-energy read (first on ties) -> {0,1} selection, in host numpy."""
    energies = result.energies.detach().cpu().numpy()
    spins = result.spins.detach().cpu().numpy()[int(np.argmin(energies))]
    return ((spins.astype(np.int32) + 1) // 2).astype(np.int32)


def _iteration_keys(key: torch.Tensor, iterations: int):
    """Per-iteration (k_quant, k_solve) pairs, split as the reference does."""
    out = []
    for _ in range(iterations):
        key, k_quant, k_solve = prng.split(key, 3)
        out.append((k_quant, k_solve))
    return out


def _quantized_instance(ising_fp: IsingProblem, cfg: SolveConfig, k_quant):
    if cfg.int_range is None and cfg.bits is None:
        return ising_fp
    return quantize_ising(
        ising_fp, cfg.rounding, int_range=cfg.int_range or COBI_RANGE,
        bits=cfg.bits, key=k_quant,
    ).ising


def solve_es(
    problem: EsProblem,
    key: torch.Tensor,
    cfg: SolveConfig = SolveConfig(),
    *,
    device=None,
) -> SolveReport:
    """Solve one ES instance per the paper's iterative workflow (Sec. IV-A).

    ``device=None`` runs on the card and raises where there is none;
    ``device="cpu"`` runs the kernels' plain versions on the CPU.  For the
    same key the per-iteration keys, rounded instances and initial phases
    are the reference's bit for bit.
    """
    device = resolve_device(device)
    problem = problem.to(device)
    if cfg.decompose:
        return _solve_decomposed(problem, key, cfg, device)
    if cfg.solver == "brute":
        x, obj, count = brute_solver.brute_force_select(problem)
        return SolveReport(x.astype(np.int32), obj, np.array([obj]), count)
    if cfg.solver == "exact":
        obj, x, _, _ = brute_solver.exact_constrained_bounds(problem)
        return SolveReport(x.astype(np.int32), obj, np.array([obj]), 1)
    if cfg.solver in solver_base.NOT_PORTED:
        raise solver_base.not_ported(cfg.solver)

    ising_fp = _build_ising(problem, cfg)
    solve = solver_base.ising_solver(cfg.solver)
    check = cfg.int_range is not None or cfg.bits is not None
    best_x, best_obj, curve = None, -np.inf, []
    for k_quant, k_solve in _iteration_keys(key, cfg.iterations):
        inst = _quantized_instance(ising_fp, cfg, k_quant)
        result = solve(inst, k_solve, reads=cfg.reads, steps=cfg.steps, check=check)
        x = _best_selection(result)
        if cfg.repair:
            x = repair_selection(problem, x)
        obj = _objective_np(problem, x)
        if obj > best_obj:
            best_obj, best_x = obj, x
        curve.append(best_obj)
    return SolveReport(best_x, best_obj, np.asarray(curve), cfg.iterations)


def make_subsolver(cfg: SolveConfig, device=None) -> decomp.SubSolver:
    """Adapter: run the iterative pipeline on a decomposition subproblem."""
    sub_cfg = dataclasses.replace(cfg, decompose=False)

    def solve(sub: EsProblem, m: int, key: torch.Tensor) -> np.ndarray:
        return solve_es(sub.with_m(m), key, sub_cfg, device=device).selection

    return solve


def _solve_decomposed(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, device
) -> SolveReport:
    k_dec, _ = prng.split(key)
    selection, trace = decomp.decompose_solve(
        problem, make_subsolver(cfg, device), k_dec, p=cfg.p, q=cfg.q
    )
    if cfg.repair:
        selection = repair_selection(problem, selection)
    obj = float(es_objective(problem, torch.as_tensor(selection)))
    return SolveReport(
        selection, obj, np.asarray([obj]), trace.num_solves * cfg.iterations
    )
