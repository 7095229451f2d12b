"""Hardware cost models (paper Sec. V): the per-solve time and power that
TTS/ETS use, the COBI chip's (which bills the chip farm's receipts), the
CMOS MCMC annealer's (which bills the MCMC bank's), and the brute-force CPU
baseline's model.

COBI constants are the paper's: ~200 us per anneal at 25 mW, and 18.9 us of
host objective evaluation per stochastic-rounding iteration at 20 W.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverHardware:
    name: str
    seconds_per_solve: float  # one Ising solve / anneal
    solver_power_w: float  # power drawn during the solve
    host_eval_seconds: float  # per-iteration FP objective evaluation on host
    host_power_w: float


COBI = SolverHardware(
    name="cobi",
    seconds_per_solve=200e-6,
    solver_power_w=25e-3,
    host_eval_seconds=18.9e-6,
    host_power_w=20.0,
)

# Snowball-class CMOS MCMC annealer: asynchronous Metropolis updates in
# SRAM-adjacent logic.  Faster and lower-power per anneal than the oscillator
# chip; it bills the MCMC annealer bank's receipts (farm/mcmc_backend.py).
MCMC_CMOS = SolverHardware(
    name="mcmc",
    seconds_per_solve=50e-6,
    solver_power_w=15e-3,
    host_eval_seconds=18.9e-6,
    host_power_w=20.0,
)

# Brute force enumerates C(N, M) subsets; per-solve time scales with the count.
BRUTE_CPU_SECONDS_PER_CANDIDATE = 1.6e-9 * 400  # ~N^2 flops per candidate at ~CPU rate


def brute_hardware(num_candidates: int) -> SolverHardware:
    return SolverHardware(
        name="brute",
        seconds_per_solve=BRUTE_CPU_SECONDS_PER_CANDIDATE * max(num_candidates, 1),
        solver_power_w=20.0,
        host_eval_seconds=0.0,  # enumeration needs no extra per-iteration eval
        host_power_w=20.0,
    )
