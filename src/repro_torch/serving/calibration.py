"""Per-backend cost models fitted from TTS/ETS-style calibration runs.

The paper's headline numbers (COBI 3-4.5x faster than brute force,
two-to-three orders of magnitude lower energy at comparable quality to Tabu)
are points on a time-to-solution / energy-to-solution / quality surface, one
per machine.  This module turns that surface into an operational artifact:
a :class:`CalibrationProfile` holds one :class:`BackendCostModel` per serving
backend, each predicting

* **latency** of a request's solve jobs on that backend (sim-clock chip
  occupancy for the farm, worker wall time for host pools),
* **energy** billed to those jobs (chip power x lane share for the farm,
  host watts x wall time for pools), and
* **quality gap** -- the probability of missing the paper's 0.9-normalized-
  objective threshold after a request's stochastic-rounding iterations,
  from the same MLE geometric success probability (Eq. 14) the TTS
  methodology in ``benchmarks/tts_ets.py`` measures.

Profiles are versioned JSON artifacts (``save``/``load``; see
``PROFILE_SCHEMA`` below) so routing decisions are reproducible from a
checked-in file, and they stay honest online: ``observe()`` folds realized
``JobReceipt``/``PoolReceipt`` accounting into per-model EWMA correction
factors, so a model fitted on a quiet box tracks the live farm.

Artifact schema (``PROFILE_SCHEMA``)::

    {
      "version": 1,
      "meta": {...},                      # free-form fit provenance
      "models": {
        "<backend name>": {
          "name": str, "kind": "farm"|"host"|"annealer", "solver": str,
          "seconds_per_solve": float,     # farm/annealer: one chip anneal
          "power_w": float,               # chip / host watts
          "lanes_per_chip": int, "parallelism": int,
          "lat_coef": [c0, c1, c2],       # host s/invocation = c0+c1*n+c2*n^2
          "reads_ref": int, "steps_ref": int, "steps_scale": bool,
          "quality_n": [...], "quality_p": [...],   # Eq. 14 p(n) knots
          "fault_rate": float,            # expected per-job fault probability
          "ewma_latency": float, "ewma_energy": float
        }, ...
      }
    }
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.farm.packing import estimate_packing, replica_tiers

PROFILE_SCHEMA = 1

# Default EWMA smoothing for online corrections: one realized request moves
# the correction 20% of the way to its observed ratio, so ~10 requests
# converge on a steady bias while a single outlier cannot capsize the model.
EWMA_ALPHA = 0.2

# Replica-tier bucketing mirrored from the farm scheduler (kept here so the
# farm model's latency estimate tiers jobs exactly like a real drain).
REPLICA_BUCKET = 8
REPLICA_TIER_RATIO = 3.0


@dataclasses.dataclass
class BackendCostModel:
    """Predicts latency / energy / quality for ONE serving backend.

    ``kind="farm"`` models a packed chip farm: request latency mirrors the
    admission estimator (replica tiers -> BFD packing estimate -> chip
    cycles x ``reads x seconds_per_solve``), energy is chip power attributed
    by lane share.  ``kind="host"`` models a worker pool: per-invocation
    wall seconds are a fitted quadratic in instance size n (scaled linearly
    by reads and, when ``steps_scale``, by anneal steps), request latency is
    the pool's critical path over ``parallelism`` workers, energy is host
    watts x total worker seconds.  ``kind="annealer"`` models a bank of
    single-instance annealer units (the MCMC CMOS machine): per-invocation
    cost is the hardware constant ``reads x seconds_per_solve`` like the
    farm, but there is no lane packing -- request latency is the host-style
    critical path over ``parallelism`` units and energy is the full chip
    power (one instance owns the whole array).  ``fault_rate`` is the
    expected per-job fault probability (profile prior, refreshed online by
    the router from the backend's breaker bank): latency predictions are
    inflated by the expected geometric retry count ``1 / (1 - fault_rate)``,
    so a flaky-but-fast backend competes on its EFFECTIVE latency.
    ``ewma_latency`` / ``ewma_energy`` are multiplicative online corrections
    (1.0 = trust the fit).
    """

    name: str
    kind: str  # "farm" | "host" | "annealer"
    solver: str = "cobi"
    seconds_per_solve: float = 0.0
    power_w: float = 0.0
    lanes_per_chip: int = 64
    parallelism: int = 1  # chips (farm) or workers (host)
    lat_coef: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reads_ref: int = 8
    steps_ref: int = 400
    steps_scale: bool = True
    quality_n: Tuple[int, ...] = ()
    quality_p: Tuple[float, ...] = ()  # per-iteration success prob at each n
    fault_rate: float = 0.0
    ewma_latency: float = 1.0
    ewma_energy: float = 1.0

    def __post_init__(self):
        if self.kind not in ("farm", "host", "annealer"):
            raise ValueError(
                f"kind must be 'farm', 'host' or 'annealer', got {self.kind!r}"
            )
        if len(self.quality_n) != len(self.quality_p):
            raise ValueError("quality_n and quality_p must pair up")

    # ------------------------------------------------------------- predict

    def invocation_seconds(self, n: int, reads: int, steps: int) -> float:
        """Raw (uncorrected) seconds for ONE solver invocation of ``reads``
        anneals on an ``n``-spin instance."""
        if self.kind in ("farm", "annealer"):
            # The simulated chip executes its programmed array once per
            # read; anneal steps shape the kernel, not the 200us (farm) /
            # 50us (annealer) hardware model, exactly like the scheduler's
            # bin-seconds accounting.
            return reads * self.seconds_per_solve
        c0, c1, c2 = self.lat_coef
        per = c0 + c1 * n + c2 * n * n
        per *= reads / max(self.reads_ref, 1)
        if self.steps_scale:
            per *= steps / max(self.steps_ref, 1)
        return max(per, 0.0)

    def invocation_energy(self, n: int, reads: int, steps: int) -> float:
        """Raw joules billed to one invocation (farm: lane share of its
        bin's chip energy; annealer/host: watts x chip/worker seconds)."""
        sec = self.invocation_seconds(n, reads, steps)
        if self.kind == "farm":
            share = min(max(n, 1) / max(self.lanes_per_chip, 1), 1.0)
            return sec * self.power_w * share
        return sec * self.power_w

    def retry_factor(self) -> float:
        """Expected attempts per job under the model's fault rate: geometric
        ``1 / (1 - fault_rate)``, clamped so even a pathological rate keeps
        the prediction finite (10x at ``fault_rate >= 0.9``)."""
        rate = min(max(self.fault_rate, 0.0), 0.9)
        return 1.0 / (1.0 - rate)

    def request_seconds(self, jobs: Sequence[Tuple[int, int]], steps: int
                        ) -> float:
        """Corrected latency for one request's ``(n, reads)`` solve jobs,
        as if the request drained alone (queue wait is the router's job).
        Inflated by :meth:`retry_factor`: faulted jobs re-run, so a flaky
        backend's effective latency grows with its observed fault rate."""
        if not jobs:
            return 0.0
        if self.kind == "farm":
            sizes = [n for n, _ in jobs]
            tiers = replica_tiers([r for _, r in jobs],
                                  bucket=REPLICA_BUCKET,
                                  ratio=REPLICA_TIER_RATIO)
            total = 0.0
            for tier_reads, idxs in tiers:
                est = estimate_packing([sizes[i] for i in idxs],
                                       self.lanes_per_chip)
                cycles = math.ceil(est.n_bins / max(self.parallelism, 1))
                total += cycles * tier_reads * self.seconds_per_solve
            return total * self.retry_factor() * self.ewma_latency
        per = [self.invocation_seconds(n, r, steps) for n, r in jobs]
        # Critical path over the pool: ideal work-sharing, never better
        # than the single longest invocation.
        lat = max(max(per), sum(per) / max(self.parallelism, 1))
        return lat * self.retry_factor() * self.ewma_latency

    def request_energy(self, jobs: Sequence[Tuple[int, int]], steps: int
                       ) -> float:
        """Corrected joules billed to one request's jobs."""
        return self.ewma_energy * sum(
            self.invocation_energy(n, r, steps) for n, r in jobs
        )

    def quality_gap(self, n: int, iterations: int) -> float:
        """Predicted probability of missing the 0.9-normalized threshold
        after ``iterations`` stochastic-rounding iterations: ``(1-p(n))^I``
        with p(n) interpolated between the profile's Eq.-14 knots.  A model
        with no quality knots predicts gap 0 (meets any floor)."""
        if not self.quality_n:
            return 0.0
        p = float(np.interp(n, np.asarray(self.quality_n, np.float64),
                            np.asarray(self.quality_p, np.float64)))
        p = min(max(p, 0.0), 1.0)
        return (1.0 - p) ** max(iterations, 1)

    # -------------------------------------------------------------- serde

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["lat_coef"] = list(self.lat_coef)
        d["quality_n"] = list(self.quality_n)
        d["quality_p"] = list(self.quality_p)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BackendCostModel":
        d = dict(d)
        d["lat_coef"] = tuple(d.get("lat_coef", (0.0, 0.0, 0.0)))
        d["quality_n"] = tuple(d.get("quality_n", ()))
        d["quality_p"] = tuple(d.get("quality_p", ()))
        return cls(**d)


class CalibrationProfile:
    """Versioned set of backend cost models + online EWMA correction."""

    def __init__(self, models: Dict[str, BackendCostModel],
                 meta: Optional[dict] = None, version: int = PROFILE_SCHEMA):
        if version != PROFILE_SCHEMA:
            raise ValueError(
                f"calibration profile schema {version} not supported "
                f"(this build reads schema {PROFILE_SCHEMA})"
            )
        self.version = version
        self.models = dict(models)
        self.meta = dict(meta or {})

    # ------------------------------------------------------------- access

    def model(self, name: str) -> BackendCostModel:
        try:
            return self.models[name]
        except KeyError:
            raise KeyError(
                f"no cost model for backend {name!r}; profiled: "
                f"{sorted(self.models)}"
            ) from None

    def observe(self, name: str, *, predicted_seconds: float,
                realized_seconds: float, predicted_energy: float = 0.0,
                realized_energy: float = 0.0, alpha: float = EWMA_ALPHA
                ) -> None:
        """Fold one realized request into the model's EWMA corrections.

        ``predicted_*`` must be the profile's own (already-corrected)
        predictions for the request, so the update is a fixed-point: once
        the correction matches the live bias, observed ratios hover at 1
        and the EWMA stops moving."""
        m = self.model(name)
        if predicted_seconds > 0.0 and realized_seconds > 0.0:
            ratio = realized_seconds / predicted_seconds
            m.ewma_latency *= (1.0 - alpha) + alpha * ratio
        if predicted_energy > 0.0 and realized_energy > 0.0:
            ratio = realized_energy / predicted_energy
            m.ewma_energy *= (1.0 - alpha) + alpha * ratio

    # -------------------------------------------------------------- serde

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "meta": self.meta,
                "models": {k: m.to_dict() for k, m in self.models.items()},
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        d = json.loads(text)
        return cls(
            models={k: BackendCostModel.from_dict(m)
                    for k, m in d.get("models", {}).items()},
            meta=d.get("meta"),
            version=d.get("version", -1),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_json(f.read())


# ------------------------------------------------------------------ fitting


def fit_host_latency(samples: Sequence[Tuple[int, float]]
                     ) -> Tuple[float, float, float]:
    """Least-squares quadratic ``seconds(n) = c0 + c1*n + c2*n^2`` from
    ``(n, seconds_per_invocation)`` samples (at the model's reference reads
    and steps).  Deterministic; falls back to lower order with few points."""
    ns = np.asarray([n for n, _ in samples], np.float64)
    ys = np.asarray([s for _, s in samples], np.float64)
    order = min(2, max(ns.size - 1, 0))
    cols = [np.ones_like(ns), ns, ns * ns][: order + 1]
    coef, *_ = np.linalg.lstsq(np.stack(cols, axis=1), ys, rcond=None)
    out = [0.0, 0.0, 0.0]
    out[: coef.size] = [float(c) for c in coef]
    return tuple(out)  # type: ignore[return-value]


def mcmc_model(*, workers: int = 4,
               quality_n: Sequence[int] = (),
               quality_p: Sequence[float] = ()) -> BackendCostModel:
    """Cost model for the MCMC annealer bank (``McmcPoolBackend``): the
    Snowball-class hardware constants are exact by construction, like the
    farm's; only the quality knots need fitting (Metropolis search quality
    differs from the oscillator dynamics -- that gap is what quality-aware
    routing trades against the 4x latency / ~2x power edge)."""
    from repro_torch.core.hardware import MCMC_CMOS

    return BackendCostModel(
        name="mcmc", kind="annealer", solver="mcmc",
        seconds_per_solve=MCMC_CMOS.seconds_per_solve,
        power_w=MCMC_CMOS.solver_power_w,
        parallelism=max(workers, 1),
        quality_n=tuple(int(n) for n in quality_n),
        quality_p=tuple(float(p) for p in quality_p),
    )


def default_profile(
    *,
    n_chips: int = 4,
    lanes_per_chip: int = 64,
    pool_workers: int = 4,
    pool_solver: str = "cobi",
    host_invocation_seconds: float = 10e-3,
    host_power_w: float = 20.0,
    mcmc_workers: int = 0,
) -> CalibrationProfile:
    """Uncalibrated starting profile from the paper's hardware constants.

    The farm model is exact by construction (the 200us/25mW simulation IS
    the model); the host pool gets a deliberately conservative flat
    ``host_invocation_seconds`` that the EWMA correction and/or a real
    ``benchmarks/calibrate.py`` fit tighten.  ``mcmc_workers > 0`` adds the
    MCMC annealer-bank model (50us/15mW).  No quality knots: the backends
    are treated as quality-equivalent by default, so routing never trades
    quality until a fitted profile says it may.
    """
    from repro_torch.core.hardware import COBI

    farm = BackendCostModel(
        name="farm", kind="farm", solver="cobi",
        seconds_per_solve=COBI.seconds_per_solve,
        power_w=COBI.solver_power_w,
        lanes_per_chip=lanes_per_chip, parallelism=n_chips,
    )
    pool = BackendCostModel(
        name="pool", kind="host", solver=pool_solver,
        power_w=host_power_w, parallelism=max(pool_workers, 1),
        lat_coef=(host_invocation_seconds, 0.0, 0.0),
        steps_scale=pool_solver in ("cobi", "sa"),
    )
    models = {"farm": farm, "pool": pool}
    if mcmc_workers > 0:
        models["mcmc"] = mcmc_model(workers=mcmc_workers)
    return CalibrationProfile(
        models,
        meta={"source": "default_profile", "fitted": False},
    )


def calibrate_profile(
    *,
    sizes: Sequence[int] = (10, 20, 40),
    n_benchmarks: int = 3,
    iterations: int = 8,
    reads: int = 8,
    steps: int = 300,
    n_chips: int = 4,
    lanes_per_chip: int = 64,
    pool_workers: int = 4,
    pool_solver: str = "cobi",
    mcmc_workers: int = 0,
    mcmc_quality_derate: float = 0.85,
    seed0: int = 6000,
    device=None,
) -> CalibrationProfile:
    """Fit a profile with the TTS/ETS methodology of ``benchmarks/tts_ets.py``.

    Per instance size: run the iterative stochastic-rounding pipeline on a
    synthetic benchmark suite, record (a) the host wall seconds per solver
    invocation (the pool latency samples) and (b) the first-success
    iteration at the 0.9-normalized threshold, whose MLE geometric success
    probability (Eq. 14) becomes the quality knot p(n).  Farm latency/energy
    need no fitting -- the simulated hardware constants are exact -- and the
    farm's quality knots always come from a COBI sweep (shared with the pool
    only when the pool runs the same solver).  ``mcmc_workers > 0`` adds the
    MCMC annealer-bank model with ITS OWN quality knots (a sweep with
    ``solver="mcmc"``): latency and energy are the Snowball-class hardware
    constants, but search quality must be measured.  The measured mcmc p(n)
    is multiplied by ``mcmc_quality_derate``: the bit-exact synchronous
    Metropolis simulation is an UPPER BOUND on the asynchronous hardware it
    stands in for (shared RNG lanes, racing asynchronous updates, reduced
    precision all cost success probability on the physical chip), so the
    checked-in model derates it -- that derated gap is what a router
    ``quality_floor`` genuinely trades against the annealer's energy edge.
    The sweeps run on ``device`` (``None``: the card).
    """
    import time

    from repro_torch import prng
    from repro_torch.core import SolveConfig, solve_es
    from repro_torch.core.metrics import (
        first_success_iteration,
        normalized_objective,
        reference_bounds,
        success_probability,
    )
    from repro_torch.data.synthetic import benchmark_suite

    def sweep(solver: str) -> Tuple[List[Tuple[int, float]], List[int],
                                    List[float]]:
        lat_samples: List[Tuple[int, float]] = []
        quality_n: List[int] = []
        quality_p: List[float] = []
        for n in sizes:
            m = max(2, min(6, n // 3))
            suite = benchmark_suite(n_benchmarks, n, m, lam=0.5, device=device)
            bounds = [reference_bounds(x) for x in suite]
            cfg = SolveConfig(
                solver=solver, formulation="improved", iterations=iterations,
                reads=reads, steps=steps, int_range=14, rounding="stochastic",
            )
            firsts, walls = [], []
            for i, (p, b) in enumerate(zip(suite, bounds)):
                t0 = time.perf_counter()
                rep = solve_es(p, prng.key(seed0 + i), cfg, device=device)
                walls.append((time.perf_counter() - t0) / iterations)
                curve = normalized_objective(rep.curve, b)
                firsts.append(first_success_iteration(curve, 0.9))
            lat_samples.append((n, float(np.median(walls))))
            quality_n.append(int(n))
            quality_p.append(float(success_probability(firsts)))
        return lat_samples, quality_n, quality_p

    lat_samples, quality_n, quality_p = sweep(pool_solver)

    prof = default_profile(
        n_chips=n_chips, lanes_per_chip=lanes_per_chip,
        pool_workers=pool_workers, pool_solver=pool_solver,
    )
    pool = prof.models["pool"]
    pool.lat_coef = fit_host_latency(lat_samples)
    pool.reads_ref = reads
    pool.steps_ref = steps
    pool.quality_n = tuple(quality_n)
    pool.quality_p = tuple(quality_p)
    farm = prof.models["farm"]
    if pool_solver == "cobi":
        farm.quality_n = tuple(quality_n)
        farm.quality_p = tuple(quality_p)
    else:
        # The farm runs COBI regardless of what the pool runs: its quality
        # knots need their own COBI sweep.
        _, farm_n, farm_p = sweep("cobi")
        farm.quality_n = tuple(farm_n)
        farm.quality_p = tuple(farm_p)
    if mcmc_workers > 0:
        _, mc_n, mc_p = sweep("mcmc")
        prof.models["mcmc"] = mcmc_model(
            workers=mcmc_workers, quality_n=mc_n,
            quality_p=[min(max(p * mcmc_quality_derate, 0.0), 1.0)
                       for p in mc_p],
        )
    prof.meta = {
        "source": "calibrate_profile", "fitted": True,
        "sizes": list(sizes), "n_benchmarks": n_benchmarks,
        "iterations": iterations, "reads": reads, "steps": steps,
        "pool_solver": pool_solver, "mcmc_workers": mcmc_workers,
        "mcmc_quality_derate": mcmc_quality_derate,
    }
    return prof
