"""Exact enumeration solvers (host numpy, as in the reference).

  * :func:`exact_constrained_bounds` -- the ground-truth obj_min / obj_max of
    Eq. (13) by enumerating all C(N, M) subsets (N <= ~25).
  * :func:`brute_force_select` -- the paper's brute-force baseline solver.
  * :func:`solve_ising` -- exact Ising minimum by 2^N enumeration, the
    ``"brute"`` entry of the solver registry.
  * :func:`exact_qubo_min` -- exact unconstrained QUBO minimum by 2^N
    enumeration.
"""

from __future__ import annotations

import itertools
from math import comb
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formulation import EsProblem
from repro_torch.solvers.base import SolverResult

MAX_ENUM = 5_000_000


def num_candidates(n: int, m: int) -> int:
    return comb(n, m)


def _all_selections(n: int, m: int) -> np.ndarray:
    """(C(n,m), n) {0,1} matrix of all cardinality-m selections."""
    count = num_candidates(n, m)
    if count > MAX_ENUM:
        raise ValueError(f"C({n},{m}) = {count} too large to enumerate")
    combos = np.fromiter(
        itertools.chain.from_iterable(itertools.combinations(range(n), m)),
        dtype=np.int32,
        count=count * m,
    ).reshape(count, m)
    x = np.zeros((count, n), np.float32)
    np.put_along_axis(x, combos, 1.0, axis=1)
    return x


def _objective_np(problem: EsProblem, x: np.ndarray) -> np.ndarray:
    mu = problem.mu.detach().cpu().numpy().astype(np.float64)
    beta = problem.beta.detach().cpu().numpy().astype(np.float64)
    lin = x @ mu
    quad = np.einsum("ri,ij,rj->r", x, beta, x)
    return lin - problem.lam * quad


def exact_constrained_bounds(
    problem: EsProblem,
) -> Tuple[float, np.ndarray, float, np.ndarray]:
    """Exact (obj_max, x_max, obj_min, x_min) of Eq. (3) over |x| = M."""
    x = _all_selections(problem.n, problem.m)
    objs = _objective_np(problem, x)
    hi, lo = int(np.argmax(objs)), int(np.argmin(objs))
    return float(objs[hi]), x[hi], float(objs[lo]), x[lo]


def brute_force_select(problem: EsProblem) -> Tuple[np.ndarray, float, int]:
    """Best cardinality-M selection by enumeration:
    (x, objective, num_candidates_evaluated)."""
    x = _all_selections(problem.n, problem.m)
    objs = _objective_np(problem, x)
    hi = int(np.argmax(objs))
    return x[hi], float(objs[hi]), x.shape[0]


def solve_ising(ising, key=None, *, reads: int = 8, steps: int = 400,
                check: bool = False, reduce: str = "none", chunk: int = 1 << 18):
    """Exact Ising minimum by chunked 2^N enumeration (N <= 22), as a
    :class:`SolverResult` with a single read.  ``key``, ``reads``, ``steps``,
    ``check`` and ``reduce`` are accepted for the registry's uniform call
    surface and change nothing."""
    del key, reads, steps, check, reduce
    h = ising.h.detach().cpu().numpy().astype(np.float32)
    j = ising.j.detach().cpu().numpy().astype(np.float32)
    n = h.shape[0]
    if n > 22:
        raise ValueError(f"brute Ising enumeration supports N <= 22, got {n}")
    best_e, best_s = np.inf, None
    for start in range(0, 2**n, chunk):
        idx = np.arange(start, min(start + chunk, 2**n), dtype=np.int64)
        spins = (((idx[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1).astype(
            np.float32
        )
        e = spins @ h + np.einsum("ri,ri->r", spins @ j, spins)
        i = int(np.argmin(e))
        if e[i] < best_e:
            best_e, best_s = float(e[i]), spins[i].astype(np.int8)
    return SolverResult(
        spins=torch.from_numpy(best_s[None, :]),
        energies=torch.tensor([best_e], dtype=torch.float32),
    )


def exact_qubo_min(q: np.ndarray, chunk: int = 1 << 18) -> Tuple[np.ndarray, float]:
    """Exact unconstrained QUBO minimum by 2^N enumeration (N <= 22), chunked:
    (x int32, energy)."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    q = np.asarray(q, np.float32)
    n = q.shape[0]
    if n > 22:
        raise ValueError(f"2^{n} too large")
    best_e, best_x = np.inf, None
    for start in range(0, 2**n, chunk):
        idx = np.arange(start, min(start + chunk, 2**n), dtype=np.int64)
        bits = ((idx[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
        e = np.einsum("ri,ri->r", bits @ q, bits)
        i = int(np.argmin(e))
        if e[i] < best_e:
            best_e, best_x = float(e[i]), bits[i].astype(np.int32)
    return best_x, best_e
