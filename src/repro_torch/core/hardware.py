"""Hardware cost models (paper Sec. V): the per-solve time and power that
TTS/ETS use, the COBI chip's (which bills the chip farm's receipts), the
CMOS MCMC annealer's (which bills the MCMC bank's), and the Tabu and
brute-force CPU baselines' models.

COBI constants are the paper's: ~200 us per anneal at 25 mW, and 18.9 us of
host objective evaluation per stochastic-rounding iteration at 20 W.

``GpuChip`` / ``H100_SXM`` are the roofline constants of the card the port
runs on (NVIDIA's datasheet figures, dense, at 700 W): ``launch/dryrun.py``
checks a cell's per-rank memory against them and ``chip_smoke.py`` divides
by their peaks.  The reference's ``TpuChip`` / ``TPU_V5E`` have no twin:
the port targets no TPU, and a TPU's rates are not the card's.
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

# Tabu on the host CPU: the software baseline's per-solve time and power,
# which bill the host pools' solves when no receipt meters them.
TABU_CPU = SolverHardware(
    name="tabu",
    seconds_per_solve=25e-3,
    solver_power_w=20.0,
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


@dataclasses.dataclass(frozen=True)
class GpuChip:
    """Roofline constants of one card (datasheet figures, dense)."""

    name: str
    power_limit_w: float
    peak_bf16_flops: float  # FLOP/s on the tensor cores
    peak_tf32_flops: float  # FLOP/s of TF32 products on the tensor cores
    peak_f32_flops: float  # FLOP/s of float32 FMA outside the tensor cores
    hbm_bandwidth: float  # bytes/s
    hbm_bytes: float
    nvlink_bandwidth: float  # bytes/s a direction


H100_SXM = GpuChip(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    peak_bf16_flops=989.4e12,
    peak_tf32_flops=494.7e12,
    peak_f32_flops=67e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    nvlink_bandwidth=450e9,
)
