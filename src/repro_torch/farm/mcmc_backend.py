"""MCMC annealer bank: the ``SolverBackend`` serving surface for the CMOS
Metropolis machine (solvers/mcmc.py).

A :class:`McmcPoolBackend` is the farm-shaped wrapper around the MCMC solver
family: self-draining submit -> future -> receipt like
:class:`~repro_torch.solvers.base.ThreadPoolBackend` (each worker thread
stands in for one annealer unit's control processor), but

* jobs solve with the fused on-device best-of epilogue when the caller asks
  for ``reduce="best"`` (as the pipeline's backend drivers always do), so
  only each job's winning read leaves the card;
* receipts bill the simulated CMOS-annealer hardware model
  (:data:`repro_torch.core.hardware.MCMC_CMOS`: 50 us / 15 mW per read) as
  ``chip_seconds`` / ``energy_joules``, plus the per-job program/readout
  transfer bytes -- not measured host watts.

The bank runs on the card unless constructed with ``device="cpu"``; its
worker threads launch the MCMC kernels there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.formulation import IsingProblem
from repro_torch.core.hardware import MCMC_CMOS, SolverHardware
from repro_torch.device import resolve_device
from repro_torch.solvers.base import PoolReceipt, SolverResult, ThreadPoolBackend

__all__ = ["McmcPoolBackend"]


class McmcPoolBackend(ThreadPoolBackend):
    """Bank of simulated CMOS MCMC annealer units behind a job queue.

    ``workers`` is the number of annealer units that run concurrently
    (``capacity_hint().parallelism``); ``mode``/``sweeps`` knobs forward to
    every solve.  ``hardware`` is the per-read cost model billed on
    receipts.  ``device=None`` means the card; jobs' instances move there.
    """

    def __init__(
        self,
        *,
        workers: int = 4,
        hardware: SolverHardware = MCMC_CMOS,
        mode: str = "sweep",
        sweeps: Optional[int] = None,
        obs=None,
        device=None,
    ):
        self.device = resolve_device(device)
        super().__init__(
            "mcmc", workers=workers, host_power_w=hardware.host_power_w, obs=obs,
        )
        self.hardware = hardware
        self.mode = mode
        self.sweeps = sweeps

    def _solve_job(self, ising, key, *, reads, steps, check, reduce,
                   **solve_kwargs) -> SolverResult:
        """Solve with the backend's mode knobs; ``reduce`` passes through to
        the solver, so ``"best"`` takes the fused on-device epilogue."""
        solve_kwargs.setdefault("mode", self.mode)
        if self.sweeps is not None:
            solve_kwargs.setdefault("sweeps", self.sweeps)
        ising = IsingProblem(h=ising.h.to(self.device), j=ising.j.to(self.device))
        return self._fn(ising, key, reads=reads, steps=steps,
                        check=bool(check), reduce=reduce, **solve_kwargs)

    def _make_receipt(self, job_id, tag, *, ising, reads, wall, submitted,
                      done) -> PoolReceipt:
        """Bill the annealer hardware model: ``reads`` sequential anneals at
        ``seconds_per_solve`` each, plus the J/h program upload and the
        winning-read readout.  ``host_seconds`` stays 0: the measured wall
        time is simulation cost, not modeled hardware time."""
        del wall
        n = int(ising.n)
        chip_seconds = reads * self.hardware.seconds_per_solve
        return PoolReceipt(
            job_id, tag,
            chip_seconds=chip_seconds,
            energy_joules=chip_seconds * self.hardware.solver_power_w,
            bytes_h2d=(n * n + n) * 4,
            bytes_d2h=(n + 1) * 4,
            sim_latency_seconds=done - submitted,
            sim_completed=done,
        )

    def stats(self) -> dict:
        hint = self.capacity_hint()
        return dataclasses.asdict(hint) | {
            "hardware": self.hardware.name,
            "mode": self.mode,
        }
