"""Common solver interface: results, the per-iteration solver registry and
the ``SolverBackend`` serving protocol.

Every solver consumes an :class:`repro_torch.core.formulation.IsingProblem`
and returns a :class:`SolverResult`.  Two call surfaces build on that:

* **Registry** -- :func:`ising_solver` maps a solver name to a uniform
  callable ``solve(ising, key, *, reads, steps, check, reduce)``, so the
  pipeline's per-iteration invoke needs no per-solver branching.  The port
  registers ``cobi`` and ``brute``; the reference's other names raise an
  error that names the ROADMAP item which ports them.

* **Backend protocol** -- :class:`SolverBackend` is the continuous serving
  surface: ``submit()`` enqueues one job and returns a :class:`SolverFuture`
  (``result(timeout=)`` / ``receipt()`` / ``cancel()`` /
  ``add_done_callback`` / ``release``), and the pipeline's backend drivers
  reduce futures instead of calling solvers inline.
  ``repro_torch.farm.CobiFarm`` implements it with packed batched anneals
  and simulated-hardware receipts.  The reference's host thread-pool backend
  (``ThreadPoolBackend``, ``PoolFuture``, ``PoolReceipt``) ports with the
  host solvers it serves.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@dataclasses.dataclass
class SolverResult:
    spins: torch.Tensor  # (R, N) int8 in {-1, +1}
    energies: torch.Tensor  # (R,) f32 -- energy of the instance that was solved

    def best(self) -> tuple[torch.Tensor, torch.Tensor]:
        i = int(torch.argmin(self.energies))
        return self.spins[i], self.energies[i]

    def reduced(self, reduce: str = "best") -> "SolverResult":
        """Host-side replica reduction, matching the farm's fused epilogue:
        ``"best"`` keeps only the argmin-energy read ((1, N) spins / (1,)
        energies, first minimum on ties -- the ``np.argmin`` convention every
        consumer uses); ``"none"`` returns self unchanged."""
        if reduce == "none":
            return self
        if reduce != "best":
            raise ValueError(f"unknown reduce {reduce!r}")
        i = int(np.argmin(self.energies.detach().cpu().numpy()))
        return SolverResult(
            spins=self.spins[i : i + 1], energies=self.energies[i : i + 1]
        )


# --------------------------------------------------------------- registry

# Solver name -> (module, attr) of the uniform Ising entry point.
_ISING_SOLVERS = {
    "cobi": ("repro_torch.solvers.cobi", "solve"),
    "brute": ("repro_torch.solvers.brute", "solve_ising"),
}
# Reference solvers the port does not have yet, with the ROADMAP queue-1
# item that ports them, by title.
NOT_PORTED = {
    "tabu": "queue 1: host solvers",
    "sa": "queue 1: host solvers",
    "mcmc": "queue 1: the MCMC family",
    "random": "queue 1: host solvers",
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


# ---------------------------------------------------------------- protocol


@runtime_checkable
class SolverFuture(Protocol):
    """Handle to one submitted solve job (the ``FarmFuture`` contract)."""

    def done(self) -> bool: ...

    def result(self, timeout: Optional[float] = None) -> SolverResult: ...

    def receipt(self, timeout: Optional[float] = None) -> Any: ...

    def cancel(self) -> bool: ...

    def add_done_callback(self, fn: Callable[[Any], None]) -> None: ...

    def release(self) -> None: ...


@runtime_checkable
class SolverBackend(Protocol):
    """Continuous serving surface every solver is driven through.

    ``submit`` enqueues one job and returns a :class:`SolverFuture`;
    ``policy`` names the drain policy (``"manual"`` backends resolve futures
    only on a caller-side ``drain()``; any other value means futures resolve
    on their own and ``flush_hint()`` is at most an end-of-burst nudge).
    ``repro_torch.farm.CobiFarm`` satisfies this structurally.
    """

    policy: str

    def submit(
        self,
        ising,
        key: torch.Tensor,
        *,
        reads: int = 8,
        steps: int = 400,
        priority: int = 0,
        deadline: Optional[float] = None,
        check: Optional[bool] = None,
        reduce: str = "none",
        tag: Optional[int] = None,
    ) -> SolverFuture: ...

    def drain(self) -> int: ...

    def flush_hint(self) -> None: ...

    def pending_jobs(self) -> int: ...

    def sim_now(self) -> float: ...

    def capacity_hint(self) -> "CapacityHint": ...

    def close(self) -> None: ...


@dataclasses.dataclass(frozen=True)
class CapacityHint:
    """A backend's live-load snapshot for routers and admission layers.

    ``est_queue_seconds`` is the backend's own estimate of how long a job
    submitted NOW waits before service begins (farm: chip cycles of queued
    tiers); ``parallelism`` is the number of concurrent service slots
    (chips); ``kind`` tells consumers which clock the estimate lives on
    (``"sim"`` chips vs ``"host"`` wall time).
    """

    pending_jobs: int
    est_queue_seconds: float
    parallelism: int
    kind: str = "host"  # "sim" | "host"
