"""Common solver interface: results and the per-iteration solver registry.

Every solver consumes an :class:`repro_torch.core.formulation.IsingProblem`
and returns a :class:`SolverResult`.  :func:`ising_solver` maps a solver name
to a uniform callable ``solve(ising, key, *, reads, steps, check, reduce)``,
so the pipeline's per-iteration invoke needs no per-solver branching.  This
slice of the port registers ``cobi`` and ``brute``; the reference's other
names raise an error that names the ROADMAP item which ports them.  The
``SolverBackend`` protocol and the thread-pool backend port with the chip
farm.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch


@dataclasses.dataclass
class SolverResult:
    spins: torch.Tensor  # (R, N) int8 in {-1, +1}
    energies: torch.Tensor  # (R,) f32 -- energy of the instance that was solved


# Solver name -> (module, attr) of the uniform Ising entry point.
_ISING_SOLVERS = {
    "cobi": ("repro_torch.solvers.cobi", "solve"),
    "brute": ("repro_torch.solvers.brute", "solve_ising"),
}
# Reference solvers this slice does not port yet, with the ROADMAP item
# (queue 1) that ports them.
NOT_PORTED = {
    "tabu": "queue 1, item 4 (solvers)",
    "sa": "queue 1, item 4 (solvers)",
    "mcmc": "queue 1, item 8 (the MCMC family)",
    "random": "queue 1, item 4 (solvers)",
}

ISING_SOLVER_NAMES = tuple(sorted(_ISING_SOLVERS))


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"solver {name!r} is not ported to repro_torch yet: ROADMAP {NOT_PORTED[name]}"
    )


def ising_solver(name: str) -> Callable[..., SolverResult]:
    """Uniform per-iteration solver entry point for ``name``: a callable
    ``(ising, key, *, reads=8, steps=400, check=False, reduce="none")``."""
    if name in NOT_PORTED:
        raise not_ported(name)
    try:
        module, attr = _ISING_SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown Ising solver {name!r}; known: {ISING_SOLVER_NAMES}"
        ) from None
    return getattr(importlib.import_module(module), attr)
