"""Fit and persist the serving router's calibration profile on the card.

The port's twin of the reference's ``benchmarks/calibrate.py``: the same
TTS/ETS sweep (``repro_torch.serving.calibration.calibrate_profile``: host
wall seconds per solver invocation -> quadratic pool latency fit; Eq.-14
MLE success probability -> quality-gap knots), the same per-size lines and
the same round-trip check of the saved ``CalibrationProfile`` JSON, which
the router loads at serve time (``python -m repro_torch.launch.serve
--route --profile PATH``).  The H100's fits are checked in beside the
serving package::

  PYTHONPATH=src python -m repro_torch.launch.calibrate \\
      --out src/repro_torch/serving/profiles/CALIBRATION_cobi_pool_h100.json
  PYTHONPATH=src python -m repro_torch.launch.calibrate --backend mcmc \\
      --pool-solver tabu \\
      --out src/repro_torch/serving/profiles/CALIBRATION_mcmc_h100.json
  PYTHONPATH=src python -m repro_torch.launch.calibrate --tiny --device cpu

Before the timed sweep, one untimed ``solve_es`` at each size with each
solver the sweep runs builds the kernels and makes their first launches,
so neither lands in the fitted latencies.  Everything runs on ``--device``
(default ``cuda``, the card, which must be there; ``cpu`` runs the kernels'
plain versions).  On the card the profile's ``meta`` also names the card
and its power limit.  ``--tiny`` shrinks the sweep for smoke runs (its fit
is not representative).
"""

from __future__ import annotations

import argparse
import subprocess
import time

from repro_torch.device import resolve_device

TINY = dict(sizes=(8, 12), n_benchmarks=2, iterations=4, steps=100)
FULL = dict(sizes=(10, 20, 40), n_benchmarks=3, iterations=8, steps=300)


def sweep_solvers(pool_solver: str, backend: str | None) -> tuple:
    """The solvers ``calibrate_profile`` sweeps: the pool's, COBI for the
    farm's knots when the pool runs another, and MCMC for its own model."""
    solvers = [pool_solver]
    if pool_solver != "cobi":
        solvers.append("cobi")
    if backend == "mcmc":
        solvers.append("mcmc")
    return tuple(solvers)


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def warm_up(sizes, solvers, *, steps: int, device) -> float:
    """One untimed ``solve_es`` (one iteration, the sweep's settings: 8
    reads, key 6000) on the first benchmark of each size with each solver;
    returns its seconds."""
    from repro_torch import prng
    from repro_torch.core import SolveConfig, solve_es
    from repro_torch.data.synthetic import benchmark_suite

    t0 = time.perf_counter()
    for n in sizes:
        problem, = benchmark_suite(1, n, max(2, min(6, n // 3)), lam=0.5,
                                   device=device)
        for solver in solvers:
            cfg = SolveConfig(
                solver=solver, formulation="improved", iterations=1,
                reads=8, steps=steps, int_range=14, rounding="stochastic",
            )
            solve_es(problem, prng.key(6000), cfg, device=device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def run(tiny: bool = False, out: str | None = None,
        pool_solver: str = "cobi", backend: str | None = None,
        device=None):
    """Warm up, fit, print the per-size lines, save and round-trip check;
    returns the :class:`CalibrationProfile`.  ``device`` ``None`` or
    ``"cuda"`` is the card, and raises without one."""
    from repro_torch.serving.calibration import (
        CalibrationProfile,
        calibrate_profile,
    )

    kw = dict(TINY if tiny else FULL)
    if backend not in (None, "mcmc"):
        raise SystemExit(f"--backend must be 'mcmc', got {backend!r}")
    dev = resolve_device(None if str(device) in ("None", "cuda") else device)
    mcmc_workers = 4 if backend == "mcmc" else 0
    solvers = sweep_solvers(pool_solver, backend)
    warm = warm_up(kw["sizes"], solvers, steps=kw["steps"], device=dev)
    print(f"warm-up: {warm:.3f} s (one untimed solve_es at each size in "
          f"{list(kw['sizes'])} with {list(solvers)} on {dev})")
    prof = calibrate_profile(pool_solver=pool_solver,
                             mcmc_workers=mcmc_workers, device=dev, **kw)
    if dev.type == "cuda":
        prof.meta["card"] = card_name()
    pool = prof.model("pool")
    farm = prof.model("farm")
    mcmc = prof.models.get("mcmc")
    for n in kw["sizes"]:
        jobs = [(n, 8)]
        line = (
            f"n={n:3d}  pool_s={pool.request_seconds(jobs, kw['steps']):.6f}"
            f"  farm_s={farm.request_seconds(jobs, kw['steps']):.6f}"
            f"  p_succ={dict(zip(pool.quality_n, pool.quality_p))[n]:.3f}"
        )
        if mcmc is not None:
            line += (
                f"  mcmc_s={mcmc.request_seconds(jobs, kw['steps']):.6f}"
                f"  mcmc_p={dict(zip(mcmc.quality_n, mcmc.quality_p))[n]:.3f}"
            )
        print(line)
    if out:
        prof.save(out)
        # Round-trip check: the artifact must reproduce its own predictions.
        back = CalibrationProfile.load(out)
        probe = [(max(kw["sizes"]), 8)]
        for name in prof.models:
            assert back.model(name).request_seconds(probe, kw["steps"]) == \
                prof.model(name).request_seconds(probe, kw["steps"])
        print(f"wrote {out} (schema {back.version}, "
              f"models {sorted(back.models)})")
    return prof


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="small sweep for smoke runs (poor fit quality)")
    ap.add_argument("--out", default=None,
                    help="write the profile JSON to this path")
    ap.add_argument("--pool-solver", default="cobi",
                    help="solver the host pool backend runs (default: cobi)")
    ap.add_argument("--backend", default=None, choices=("mcmc",),
                    help="additionally fit this solver family's quality "
                         "knots (adds its model to the profile)")
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run (cuda, the card; or cpu for "
                         "the kernels' plain versions)")
    args = ap.parse_args()
    run(tiny=args.tiny, out=args.out, pool_solver=args.pool_solver,
        backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
