"""COBI solver: the coupled-oscillator Ising machine, simulated on the card.

The chip (59 spins, all-to-all, integer couplings in [-14, +14]) is modeled
by the oscillator-dynamics kernels (kernels/cobi_dynamics.py).  Each "read"
is one anneal from a random phase state.  Integer couplings are enforced:
passing a non-integer instance raises, as the chip's programming interface
would.  :func:`solve_batch` serves many instances at once on the chip farm.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formulation import IsingProblem
from repro_torch.core.rounding import COBI_RANGE
from repro_torch.kernels import ops
from repro_torch.solvers.base import SolverResult

COBI_MAX_SPINS = 59  # physical spins on the 2025 COBI chip


def check_programmable(ising: IsingProblem, *, max_spins: int = COBI_MAX_SPINS) -> None:
    if ising.n > max_spins:
        raise ValueError(f"COBI supports <= {max_spins} spins, got {ising.n}")
    for name, t in (("h", ising.h), ("J", ising.j)):
        v = t.detach().cpu().numpy()
        if not np.allclose(v, np.round(v), atol=1e-6):
            raise ValueError(f"COBI needs integer {name}; quantize first (core.rounding)")
        if np.max(np.abs(v)) > COBI_RANGE:
            raise ValueError(f"COBI {name} range is [-{COBI_RANGE}, {COBI_RANGE}]")


def solve(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    reads: int = 8,
    steps: int = 400,
    dt: float = 0.35,
    ks_max: float = 1.2,
    check: bool = True,
    reduce: str = "none",
) -> SolverResult:
    """Run ``reads`` independent anneals on the device of ``ising.h``.

    ``reduce="none"`` returns all reads; ``"best"`` only the argmin-energy
    read via the fused epilogue (spins (1, N), energies (1,)); ``"topk"`` the
    reads sorted by energy.  The ``"cobi"`` entry of the solver registry.
    """
    if check:
        check_programmable(ising)
    spins, energies = ops.cobi_anneal(
        ising.h.to(torch.float32), ising.j.to(torch.float32), key,
        replicas=reads, steps=steps, dt=dt, ks_max=ks_max, reduce=reduce,
    )
    if reduce == "best":
        spins, energies = spins[None], energies[None]
    return SolverResult(spins=spins, energies=energies)


def solve_batch(
    instances,
    keys,
    *,
    n_chips: int = 4,
    reads: int = 8,
    steps: int = 400,
    dt: float = 0.35,
    ks_max: float = 1.2,
    device=None,
    check: bool = True,
    reduce: str = "none",
    policy: str = "manual",
) -> "list[SolverResult]":
    """Solve many instances at once on a virtual chip farm.

    Block-diagonally packs the instances onto ``n_chips`` simulated COBI
    chips and anneals them in one batched kernel launch (see
    ``repro_torch.farm``); results are per-instance and bit-identical to what
    each instance would get from the farm alone.  ``policy`` selects the
    farm's drain policy (results are bit-identical to ``"manual"``);
    ``device=None`` means the card.  For scheduling control use
    ``repro_torch.farm.CobiFarm`` directly.
    """
    from repro_torch.farm import solve_many  # farm imports this module; lazy import

    return solve_many(
        instances, keys, n_chips=n_chips, reads=reads, steps=steps,
        dt=dt, ks_max=ks_max, device=device, check=check, reduce=reduce,
        policy=policy,
    )
