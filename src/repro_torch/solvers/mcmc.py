"""MCMC solver: the asynchronous-sweep Metropolis annealer on the card.

The second hardware-flavored solver family next to COBI: a Snowball-style
dual-mode CMOS annealer (in-order sweeps or uniform-random proposals,
``mode=``) simulated by the MCMC kernels (kernels/mcmc_dynamics.py).  Unlike
the oscillator chip it takes any float couplings: no integer programming
constraint and no dynamics rescale.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formulation import IsingProblem
from repro_torch.kernels import ops
from repro_torch.solvers.base import SolverResult

# The pipeline's shared ``steps`` budget is counted in oscillator Euler
# steps; one asynchronous Metropolis sweep (N proposals, a rank-1 field
# update each) costs about eight of those.  cfg.steps=400 -> 50 sweeps.
STEPS_PER_SWEEP = 8


def sweeps_for_steps(steps: int) -> int:
    return max(1, int(steps) // STEPS_PER_SWEEP)


def solve(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    replicas: int = 8,
    sweeps: int = 50,
    chunk: int | None = None,
    mode: str = "sweep",
    t_hi: float | None = None,
    t_lo: float = 0.05,
    reduce: str = "none",
) -> SolverResult:
    """Run ``replicas`` independent Metropolis chains down the ladder on the
    device of ``ising.h``.

    ``reduce="none"`` returns every chain's best-visited state; ``"best"``
    only the argmin-energy chain via the fused epilogue (spins (1, N),
    energies (1,)), equal to ``"none"`` + first argmin.  ``t_hi`` defaults to
    ``2 max_i sum_j |J_ij| + 1e-6``, taken in numpy on a host copy of J as
    the reference takes it.
    """
    if t_hi is None:
        j_host = ising.j.detach().cpu().numpy()
        t_hi = float(2.0 * np.abs(j_host).sum(-1).max() + 1e-6)
    kwargs = {} if chunk is None else {"chunk": chunk}
    spins, energies = ops.mcmc_anneal(
        ising.h.to(torch.float32), ising.j.to(torch.float32), key,
        replicas=replicas, sweeps=sweeps, mode=mode,
        t_hi=np.float32(t_hi), t_lo=t_lo, reduce=reduce, **kwargs,
    )
    if reduce == "best":
        spins, energies = spins[None], energies[None]
    return SolverResult(spins=spins, energies=energies)


def solve_ising(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    reads: int = 8,
    steps: int = 400,
    check: bool = False,
    reduce: str = "none",
    **kwargs,
) -> SolverResult:
    """The ``"mcmc"`` entry of the solver registry: ``reads`` maps to
    replicas, ``steps`` to sweeps at :data:`STEPS_PER_SWEEP`; ``check`` has
    no MCMC meaning (any float instance is programmable) and is ignored;
    extra kwargs (``sweeps``, ``mode``, ``chunk``, ``t_hi``, ``t_lo``) pass
    through."""
    del check
    kwargs.setdefault("sweeps", sweeps_for_steps(steps))
    return solve(ising, key, replicas=reads, reduce=reduce, **kwargs)
