"""End-to-end ES solve pipeline (paper Sec. V): improved formulation ->
stochastic rounding -> integer Ising -> solver -> best-of-iterations under
the FP objective -> optional decomposition driver.

Twin of ``repro.core.pipeline``.  Per-iteration solver dispatch goes through
the :mod:`repro_torch.solvers.base` registry.  The formulation, rounding and
anneals run on the card (``device=None``, the default) or, when the caller
asks for it, on the CPU with the kernels' plain versions.  Greedy repair and
the best-of reduce run in host numpy, as in the reference.

The generator drivers at the bottom of this module run against any
:class:`repro_torch.solvers.base.SolverBackend` (the COBI chip farm):
iterations submit as jobs, a driver interleaves many requests' rounds, and
futures reduce back into a :class:`SolveReport` that carries the backend's
receipt accounting (chip time, energy, attributed host<->device bytes,
sim-clock completion).  For the same key they are bit-identical to the
inline path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import decomposition as decomp
from repro_torch.core.formulation import (
    EsProblem,
    IsingProblem,
    es_objective,
    improved_ising,
    original_ising,
)
from repro_torch.core.rounding import COBI_RANGE, quantize_ising, quantize_ising_many
from repro_torch.device import resolve_device
from repro_torch.solvers import base as solver_base
from repro_torch.solvers import brute as brute_solver


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Knobs of the hardware-aware ES pipeline."""

    solver: str = "cobi"  # cobi | brute | exact
    formulation: str = "improved"  # improved | original
    rounding: str = "stochastic"  # deterministic | stochastic_5050 | stochastic
    int_range: Optional[int] = COBI_RANGE  # None -> no quantization (FP solve)
    bits: Optional[int] = None  # overrides int_range when set
    iterations: int = 10  # solver invocations (paper's definition)
    reads: int = 8  # anneals / restarts per invocation
    gamma: Optional[float] = None  # None -> gamma_auto
    repair: bool = True  # greedy-repair cardinality before evaluating
    steps: int = 400  # COBI anneal steps
    decompose: bool = False
    p: int = 20
    q: int = 10
    # Backend-scheduled decomposition only: plan all windows of one oversized
    # request ahead (speculating on survivors) so they pack into the same
    # drains as other traffic, instead of one window per round.  Results are
    # bit-identical either way; see core.decomposition.PipelinedDecomposition.
    # Firm (guess-invariant) windows always submit immediately; windows whose
    # membership rests on speculated survivors submit only within
    # `speculate_depth` of the resolve frontier, bounding the anneals a wrong
    # guess can waste.
    pipeline_windows: bool = True
    speculate_windows: bool = True
    speculate_depth: int = 2


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """Per-submission-unit routing attribution (one per routed window, or
    one for the whole request on the direct path).

    ``realized_seconds`` is the window's receipt-metered hardware time
    (chip + host) and ``realized_energy`` its receipt joules."""

    backend: Optional[str]
    predicted_seconds: float
    realized_seconds: float
    realized_energy: float
    jobs: int


@dataclasses.dataclass
class SolveReport:
    selection: np.ndarray  # (N,) {0,1}
    objective: float  # FP Eq. (3) objective of `selection`
    curve: np.ndarray  # best-so-far FP objective after each iteration
    solver_invocations: int
    # Backend-scheduled solves carry simulated-hardware accounting from their
    # job receipts; the inline paths leave these at 0.
    chip_seconds: float = 0.0
    chip_energy_joules: float = 0.0
    # Host<->device traffic the solve's jobs were billed for (per-job lane
    # share of each drain launch) and the absolute sim-clock time the last
    # consumed job finished.
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    sim_completed: float = 0.0
    # Measured host worker wall time billed by host-pool receipts (0 for
    # farm-only solves).
    host_seconds: float = 0.0
    # Routed solves: solve jobs per backend name ({} when no route hook ran).
    backend_jobs: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Routed solves: one WindowRecord per reduced submission unit.
    windows: List[WindowRecord] = dataclasses.field(default_factory=list)
    # Readout-level fault events absorbed by completed jobs (repaired
    # bit-flips, stuck lanes), counted from receipt fault tags.
    faults_seen: int = 0


@dataclasses.dataclass
class _Acct:
    """Receipt accumulator threaded through the backend reduce paths."""

    chip_seconds: float = 0.0
    energy_joules: float = 0.0
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    sim_completed: float = 0.0
    host_seconds: float = 0.0
    backend_jobs: Dict[str, int] = dataclasses.field(default_factory=dict)
    faults_seen: int = 0

    def add(self, other) -> None:
        """Fold in a receipt or another accumulator (same field names;
        receipts missing a field -- farm receipts carry no host_seconds --
        contribute 0)."""
        self.chip_seconds += other.chip_seconds
        self.host_seconds += getattr(other, "host_seconds", 0.0)
        self.energy_joules += other.energy_joules
        self.bytes_h2d += other.bytes_h2d
        self.bytes_d2h += other.bytes_d2h
        self.sim_completed = max(self.sim_completed, other.sim_completed)
        # Receipts carry per-job fault tags; accumulators carry a count.
        self.faults_seen += (getattr(other, "faults_seen", 0)
                             + len(getattr(other, "faults", ()) or ()))
        for name, jobs in getattr(other, "backend_jobs", {}).items():
            self.backend_jobs[name] = self.backend_jobs.get(name, 0) + jobs

    def tally(self, backend_name: Optional[str], jobs: int) -> None:
        if backend_name is not None:
            self.backend_jobs[backend_name] = (
                self.backend_jobs.get(backend_name, 0) + jobs
            )

    def report(self, selection, objective, curve, invocations, windows) -> SolveReport:
        return SolveReport(
            selection, objective, np.asarray(curve), invocations,
            self.chip_seconds, self.energy_joules, self.bytes_h2d,
            self.bytes_d2h, self.sim_completed, host_seconds=self.host_seconds,
            backend_jobs=self.backend_jobs, faults_seen=self.faults_seen,
            windows=windows,
        )


def repair_selection(problem: EsProblem, x: np.ndarray) -> np.ndarray:
    """Greedy add/remove to reach cardinality M (marginal-gain ordered), with
    the gain vector updated incrementally by one O(N) axpy per flip."""
    x = np.asarray(x, np.int32).copy()
    k = int(x.sum())
    if k == problem.m:
        return x
    mu = problem.mu.detach().cpu().numpy().astype(np.float64)
    beta = problem.beta.detach().cpu().numpy().astype(np.float64)
    lam2 = 2.0 * problem.lam
    # score_i = mu_i - 2*lam*(beta x)_i: removing selected i loses score_i,
    # adding unselected i gains score_i (beta has zero diagonal).
    score = mu - lam2 * (beta @ x)
    buf = np.empty_like(score)
    if k > problem.m:
        contrib = np.where(x > 0, score, np.inf)
        while k > problem.m:
            i = int(np.argmin(contrib))
            x[i] = 0
            k -= 1
            np.multiply(beta[i], lam2, out=buf)  # symmetric: row i == col i
            contrib += buf  # every remaining red_j drops by beta_ij
            contrib[i] = np.inf
    else:
        gain = np.where(x > 0, -np.inf, score)
        while k < problem.m:
            i = int(np.argmax(gain))
            x[i] = 1
            k += 1
            np.multiply(beta[i], lam2, out=buf)
            gain -= buf  # every remaining red_j grows by beta_ij
            gain[i] = -np.inf
    return x


def _build_ising(problem: EsProblem, cfg: SolveConfig) -> IsingProblem:
    if cfg.formulation == "improved":
        return improved_ising(problem, gamma=cfg.gamma)
    if cfg.formulation == "original":
        return original_ising(problem, gamma=cfg.gamma)
    raise ValueError(f"unknown formulation {cfg.formulation!r}")


def _objective_np(problem: EsProblem, x: np.ndarray) -> float:
    """Eq. (3) in host float32, as the reference's per-iteration reduce."""
    mu = problem.mu.detach().cpu().numpy().astype(np.float32)
    beta = problem.beta.detach().cpu().numpy().astype(np.float32)
    xf = x.astype(np.float32)
    return float(xf @ mu - np.float32(problem.lam) * (xf @ (beta @ xf)))


def _best_selection(result) -> np.ndarray:
    """argmin-energy read (first on ties) -> {0,1} selection, in host numpy."""
    energies = result.energies.detach().cpu().numpy()
    spins = result.spins.detach().cpu().numpy()[int(np.argmin(energies))]
    return ((spins.astype(np.int32) + 1) // 2).astype(np.int32)


def _iteration_keys(key: torch.Tensor, iterations: int):
    """Per-iteration (k_quant, k_solve) pairs, split as the reference does."""
    out = []
    for _ in range(iterations):
        key, k_quant, k_solve = prng.split(key, 3)
        out.append((k_quant, k_solve))
    return out


def _quantized_instance(ising_fp: IsingProblem, cfg: SolveConfig, k_quant):
    if cfg.int_range is None and cfg.bits is None:
        return ising_fp
    return quantize_ising(
        ising_fp, cfg.rounding, int_range=cfg.int_range or COBI_RANGE,
        bits=cfg.bits, key=k_quant,
    ).ising


def solve_es(
    problem: EsProblem,
    key: torch.Tensor,
    cfg: SolveConfig = SolveConfig(),
    *,
    device=None,
    backend=None,
    farm=None,
    priority: int = 0,
) -> SolveReport:
    """Solve one ES instance per the paper's iterative workflow (Sec. IV-A).

    ``device=None`` runs on the card and raises where there is none;
    ``device="cpu"`` runs the kernels' plain versions on the CPU.  For the
    same key the per-iteration keys, rounded instances and initial phases
    are the reference's bit for bit.

    With ``backend`` (any :class:`repro_torch.solvers.base.SolverBackend` --
    the COBI chip farm; ``farm=`` is the reference's older spelling of the
    same parameter), all of the instance's stochastic-rounding iterations
    (and, when decomposing, each window's iterations) go through the backend
    as one submission round instead of one inline solver call per iteration.
    Results are bit-identical to the inline path for the same key.
    """
    device = resolve_device(device)
    problem = problem.to(device)
    backend = backend if backend is not None else farm
    if backend is not None and cfg.solver in solver_base.ISING_SOLVER_NAMES:
        return drive_with_backend(
            iter_solve_es(problem, key, cfg, backend=backend, priority=priority),
            backend,
        )
    if cfg.decompose:
        return _solve_decomposed(problem, key, cfg, device)
    if cfg.solver == "brute":
        x, obj, count = brute_solver.brute_force_select(problem)
        return SolveReport(x.astype(np.int32), obj, np.array([obj]), count)
    if cfg.solver == "exact":
        obj, x, _, _ = brute_solver.exact_constrained_bounds(problem)
        return SolveReport(x.astype(np.int32), obj, np.array([obj]), 1)
    if cfg.solver in solver_base.NOT_PORTED:
        raise solver_base.not_ported(cfg.solver)

    ising_fp = _build_ising(problem, cfg)
    solve = solver_base.ising_solver(cfg.solver)
    check = cfg.int_range is not None or cfg.bits is not None
    results = (
        solve(_quantized_instance(ising_fp, cfg, k_quant), k_solve,
              reads=cfg.reads, steps=cfg.steps, check=check)
        for k_quant, k_solve in _iteration_keys(key, cfg.iterations)
    )
    best_x, best_obj, curve = _best_of(problem, cfg, results)
    return SolveReport(best_x, best_obj, np.asarray(curve), cfg.iterations)


def make_subsolver(cfg: SolveConfig, device=None) -> decomp.SubSolver:
    """Adapter: run the iterative pipeline on a decomposition subproblem."""
    sub_cfg = dataclasses.replace(cfg, decompose=False)

    def solve(sub: EsProblem, m: int, key: torch.Tensor) -> np.ndarray:
        return solve_es(sub.with_m(m), key, sub_cfg, device=device).selection

    return solve


def _solve_decomposed(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, device
) -> SolveReport:
    k_dec, _ = prng.split(key)
    selection, trace = decomp.decompose_solve(
        problem, make_subsolver(cfg, device), k_dec, p=cfg.p, q=cfg.q
    )
    if cfg.repair:
        selection = repair_selection(problem, selection)
    obj = float(es_objective(problem, torch.as_tensor(selection)))
    return SolveReport(
        selection, obj, np.asarray([obj]), trace.num_solves * cfg.iterations
    )


# ---------------------------------------------------------------------------
# Backend-scheduled solving: generators that submit whole rounds of jobs to a
# SolverBackend (the COBI chip farm), yield so a driver can interleave jobs
# ACROSS requests, then consume the futures.  Protocol: each `yield` marks
# "submissions for this round done"; the driver calls backend.drain() (once,
# for all concurrently active generators, when the backend's policy is
# "manual") and resumes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Round:
    """One submission round plus the recipe to resubmit any iteration.

    ``resubmit(i, backend=None)`` re-submits iteration ``i``'s EXACT
    (quantized instance, solve key) -- to the original backend or to a
    failover one -- so a retried job is bit-identical to the original
    wherever it lands (results depend only on instance and key).
    """

    futures: list
    resubmit: Callable


def _submit_iterations(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, backend, priority: int,
    deadline: Optional[float] = None, tag: Optional[int] = None,
) -> _Round:
    """Submit the instance's cfg.iterations solve jobs; returns a _Round.

    Jobs go in with ``reduce="best"``: the per-iteration argmin-energy read is
    the ONLY thing the reduce consumes, so the farm's fused epilogue keeps
    replica spins/energies on the device and each future resolves to just the
    winner (bit-identical to all-reads + host argmin on integer instances).
    """
    ising_fp = _build_ising(problem, cfg)
    check = cfg.int_range is not None or cfg.bits is not None
    keypairs = _iteration_keys(key, cfg.iterations)
    if check:
        # Same per-iteration keys as the sequential path.
        quantized = quantize_ising_many(
            ising_fp, [kq for kq, _ in keypairs], cfg.rounding,
            int_range=cfg.int_range or COBI_RANGE, bits=cfg.bits,
        )
        instances = [q.ising for q in quantized]
    else:
        instances = [ising_fp] * cfg.iterations

    def submit_one(i: int, be=None, dl=deadline):
        # Failover resubmits drop the deadline: it lives on the PRIMARY
        # backend's clock and recovery already budgeted the move against it.
        return (be or backend).submit(
            instances[i], keypairs[i][1], reads=cfg.reads, steps=cfg.steps,
            priority=priority, deadline=dl if be is None else None,
            check=check, reduce="best", tag=tag,
        )

    return _Round([submit_one(i) for i in range(cfg.iterations)], submit_one)


def _best_of(problem: EsProblem, cfg: SolveConfig, results):
    """Best-of-iterations under the FP objective (strict ``>``: the earliest
    iteration wins ties), as the inline loop reduces."""
    best_x, best_obj, curve = None, -np.inf, []
    for result in results:
        x = _best_selection(result)
        if cfg.repair:
            x = repair_selection(problem, x)
        obj = _objective_np(problem, x)
        if obj > best_obj:
            best_obj, best_x = obj, x
        curve.append(best_obj)
    return best_x, best_obj, curve


def _reduce_iterations(problem: EsProblem, cfg: SolveConfig, futures):
    """Consume one instance's iteration futures -> best-of + accounting.

    Each future is released after its result AND receipt are consumed, so a
    long-lived backend's completed-job buffers stay bounded.
    """
    acct = _Acct()
    results = []
    for fut in futures:
        results.append(fut.result())
        acct.add(fut.receipt())
        fut.release()
    return (*_best_of(problem, cfg, results), acct)


def _reduce_with_recovery(problem: EsProblem, cfg: SolveConfig, rnd: _Round,
                          recovery):
    """Fault-tolerant variant of :func:`_reduce_iterations` (generator).

    ``recovery`` is any object with the reference recovery context's surface:
    ``retryable`` (an exception class or tuple, e.g.
    :class:`repro_torch.farm.faults.FarmFault`), ``note_fault(exc)``,
    ``decide(attempt, exc, failed_over=) -> backend or None`` (None: retry on
    the same backend; it raises to give up) and ``failover_name``.  Each pass
    that resubmitted anything ``yield``s the fresh futures -- the round
    barrier, after which the next drain runs them.  Results are collected per
    iteration index and reduced in INDEX order, so the best-of tie-break
    matches the fault-free run bit for bit no matter which attempt finally
    succeeded.  On any terminal error every remaining future is
    cancelled/released.
    """
    futures = list(rnd.futures)
    k = len(futures)
    attempts = [0] * k
    moved = [False] * k          # already failed over?
    results: list = [None] * k
    pending = set(range(k))
    acct = _Acct()
    try:
        while pending:
            retried: list = []
            for i in sorted(pending):
                fut = futures[i]
                try:
                    result = fut.result()
                except recovery.retryable as exc:
                    recovery.note_fault(exc)
                    fut.release()
                    be = recovery.decide(attempts[i], exc, failed_over=moved[i])
                    attempts[i] += 1
                    if be is not None:
                        moved[i] = True
                        acct.tally(recovery.failover_name, 1)
                    futures[i] = rnd.resubmit(i, be)
                    retried.append(i)
                    continue
                acct.add(fut.receipt())
                fut.release()
                results[i] = result
                pending.discard(i)
            if retried:
                # Round barrier: the driver drains before resuming, so the
                # resubmitted futures are resolvable on the next pass.
                yield [futures[i] for i in retried]
    except BaseException:
        for i in sorted(pending):
            fut = futures[i]
            if fut.done():
                fut.release()
            else:
                fut.cancel()
                fut.add_done_callback(lambda f: f.release())
        raise
    return (*_best_of(problem, cfg, results), acct)


def _iter_iterations(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, backend, priority: int,
    deadline: Optional[float] = None, tag: Optional[int] = None,
    recovery=None,
):
    """Submit the instance's iteration jobs, yield (round barrier), reduce."""
    rnd = _submit_iterations(problem, key, cfg, backend, priority,
                             deadline, tag)
    yield rnd.futures
    if recovery is None:
        return _reduce_iterations(problem, cfg, rnd.futures)
    return (yield from _reduce_with_recovery(problem, cfg, rnd, recovery))


# Per-window backend picker for routed serving: ``route(n, reads) ->
# (backend_name, backend, deadline, predicted_seconds)``.  The deadline comes
# back from the route because backends keep independent clocks; whoever
# converts the request deadline must know which backend won.
# ``predicted_seconds`` lands (with the realized receipts) in
# ``SolveReport.windows``; ``backend_name`` in ``SolveReport.backend_jobs``;
# ``None`` disables tagging.
RouteFn = Callable[
    [int, int], Tuple[Optional[str], object, Optional[float], float]
]


def iter_solve_es(
    problem: EsProblem,
    key: torch.Tensor,
    cfg: SolveConfig = SolveConfig(),
    *,
    backend=None,
    farm=None,
    priority: int = 0,
    deadline: Optional[float] = None,
    tag: Optional[int] = None,
    route: Optional[RouteFn] = None,
    recovery=None,
):
    """Generator form of :func:`solve_es` over a :class:`SolverBackend`.

    ``backend`` is any submit->future backend (``farm=`` is the older
    spelling of the same parameter); the solver must be in the
    ``repro_torch.solvers.base`` registry.  The formulation and rounding run
    on the problem's device.  Yields once per submission round (one round
    for a direct solve; a decomposed solve yields once per window under
    ``pipeline_windows=False`` and only on unresolved frontiers under the
    default pipelined driver); returns a :class:`SolveReport` whose
    chip_seconds / chip_energy_joules / bytes / sim_completed come from the
    backend's job receipts.  ``deadline`` (absolute simulated time) is
    stamped on every submitted job (the farm's ``policy="deadline"``
    watermark keys on it); ``tag`` is echoed on every receipt.

    ``route`` (see :data:`RouteFn`) overrides the backend per submission
    unit -- once for a direct solve, per window for a decomposed one;
    results stay bit-identical and ``SolveReport.backend_jobs`` records the
    split.  ``recovery`` (see :func:`_reduce_with_recovery`) turns typed farm
    faults into retries and failover instead of propagating them; without it
    the first fault raises.
    """
    backend = backend if backend is not None else farm
    if backend is None:
        raise ValueError("iter_solve_es requires a backend (or farm) argument")
    if cfg.solver not in solver_base.ISING_SOLVER_NAMES:
        raise ValueError(
            f"backend scheduling requires a registry solver "
            f"{solver_base.ISING_SOLVER_NAMES}, got {cfg.solver!r}"
        )
    if cfg.decompose:
        driver = _iter_decomposed if cfg.pipeline_windows else _iter_decomposed_lockstep
        return (yield from driver(
            problem, key, cfg, backend, priority, deadline, tag, route, recovery
        ))
    name, predicted = None, 0.0
    if route is not None:
        name, backend, deadline, predicted = route(problem.n, cfg.reads)
    best_x, best_obj, curve, acct = yield from _iter_iterations(
        problem, key, cfg, backend, priority, deadline, tag, recovery
    )
    acct.tally(name, cfg.iterations)
    windows = []
    if route is not None:
        windows.append(WindowRecord(
            name, predicted, acct.chip_seconds + acct.host_seconds,
            acct.energy_joules, cfg.iterations,
        ))
    return acct.report(best_x, best_obj, curve, cfg.iterations, windows)


def _decomposed_report(problem, cfg, selection, invocations, acct, windows):
    if cfg.repair:
        selection = repair_selection(problem, selection)
    obj = float(es_objective(problem, torch.as_tensor(selection)))
    return acct.report(selection, obj, [obj], invocations, windows)


def _iter_decomposed_lockstep(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, backend, priority: int,
    deadline: Optional[float] = None, tag: Optional[int] = None,
    route: Optional[RouteFn] = None, recovery=None,
):
    """Decomposed backend driver with ONE window in flight at a time (the
    ``pipeline_windows=False`` fallback, and the reference the pipelined
    driver is held against): each window submits, yields a round, reduces,
    and only then is the next window's membership computed.
    """
    k_dec, _ = prng.split(key)
    sub_cfg = dataclasses.replace(cfg, decompose=False)
    steps = decomp.decompose_steps(problem, k_dec, p=cfg.p, q=cfg.q)
    acct = _Acct()
    windows: List[WindowRecord] = []
    item = next(steps)
    while True:
        sub, m, k_sub = item
        w_name, w_backend, w_deadline, w_pred = None, backend, deadline, 0.0
        if route is not None:
            w_name, w_backend, w_deadline, w_pred = route(sub.n, sub_cfg.reads)
        sel, _, _, sub_acct = yield from _iter_iterations(
            sub.with_m(m), k_sub, sub_cfg, w_backend, priority, w_deadline,
            tag, recovery
        )
        acct.add(sub_acct)
        acct.tally(w_name, sub_cfg.iterations)
        if route is not None:
            windows.append(WindowRecord(
                w_name, w_pred,
                sub_acct.chip_seconds + sub_acct.host_seconds,
                sub_acct.energy_joules, sub_cfg.iterations,
            ))
        try:
            item = steps.send(sel)
        except StopIteration as done:
            selection, trace = done.value
            break
    return _decomposed_report(problem, cfg, selection,
                              trace.num_solves * cfg.iterations, acct, windows)


def _iter_decomposed(
    problem: EsProblem, key: torch.Tensor, cfg: SolveConfig, backend, priority: int,
    deadline: Optional[float] = None, tag: Optional[int] = None,
    route: Optional[RouteFn] = None, recovery=None,
):
    """Pipelined decomposed backend driver: ALL planned windows in flight.

    Plans every window of the request up front via
    :class:`repro_torch.core.decomposition.PipelinedDecomposition`
    (speculating on survivors when ``cfg.speculate_windows``), submits each
    planned window's stochastic-rounding iterations immediately, and
    reconciles as real window outcomes arrive: windows whose speculated
    membership survives keep their in-flight futures, invalidated ones are
    re-planned and re-submitted under the same per-window key.  The final
    selection is bit-identical to the lockstep driver.

    Yields only when the frontier window's futures are not yet resolved --
    under ``policy="manual"`` lockstep driving that is the round barrier the
    driver drains behind; under background drain policies the reduce blocks
    on the futures directly and the generator may never yield at all.
    """
    k_dec, _ = prng.split(key)
    sub_cfg = dataclasses.replace(cfg, decompose=False)
    plan = decomp.PipelinedDecomposition(
        problem, k_dec, p=cfg.p, q=cfg.q, speculate=cfg.speculate_windows
    )
    inflight: dict = {}  # (seq, indices) -> (sub, round, name, predicted)
    windows_submitted = 0
    acct = _Acct()
    windows: List[WindowRecord] = []
    consumed: set = set()
    while not plan.done():
        for spec in plan.pending_specs():
            if (spec.speculative
                    and spec.seq - plan.n_resolved() > cfg.speculate_depth):
                # Membership rests on guessed survivors and is far from the
                # frontier: hold it back until more outcomes are real.
                continue
            fkey = (spec.seq, spec.indices)
            if fkey not in inflight:
                sub = problem.subproblem(np.asarray(spec.indices)).with_m(spec.m)
                w_name, w_backend, w_deadline, w_pred = (
                    None, backend, deadline, 0.0)
                if route is not None:
                    w_name, w_backend, w_deadline, w_pred = route(
                        sub.n, sub_cfg.reads)
                inflight[fkey] = (
                    sub,
                    _submit_iterations(
                        sub, spec.key, sub_cfg, w_backend, priority,
                        w_deadline, tag
                    ),
                    w_name,
                    w_pred,
                )
                acct.tally(w_name, sub_cfg.iterations)
                windows_submitted += 1
        spec = plan.next_spec()
        fkey = (spec.seq, spec.indices)
        sub, rnd, w_name, w_pred = inflight[fkey]
        if not all(f.done() for f in rnd.futures):
            yield rnd.futures
        if recovery is None:
            sel, _, _, sub_acct = _reduce_iterations(sub, sub_cfg, rnd.futures)
        else:
            sel, _, _, sub_acct = yield from _reduce_with_recovery(
                sub, sub_cfg, rnd, recovery)
        acct.add(sub_acct)
        if route is not None:
            windows.append(WindowRecord(
                w_name, w_pred,
                sub_acct.chip_seconds + sub_acct.host_seconds,
                sub_acct.energy_joules, sub_cfg.iterations,
            ))
        consumed.add(fkey)
        plan.resolve(sel)
    # Mis-speculated windows that already annealed burned real chip time
    # (and transfer bytes): bill them to this request, but do NOT let them
    # move sim_completed -- the answer was available without them.
    # Still-queued orphans are cancelled so they never pollute a later
    # drain; either way the job's buffers are released.
    for fkey, (_, rnd, _, _) in inflight.items():
        if fkey in consumed:
            continue
        for fut in rnd.futures:
            if fut.done():
                receipt = fut.receipt()
                acct.chip_seconds += receipt.chip_seconds
                acct.host_seconds += getattr(receipt, "host_seconds", 0.0)
                acct.energy_joules += receipt.energy_joules
                acct.bytes_h2d += receipt.bytes_h2d
                acct.bytes_d2h += receipt.bytes_d2h
                fut.release()
            else:
                fut.cancel()
                # Cancelled -> done now, the callback releases at once; a job
                # MID-DRAIN (cancel refused) releases from the drain thread's
                # commit.
                fut.add_done_callback(lambda f: f.release())
    selection, _trace = plan.final
    return _decomposed_report(problem, cfg, selection,
                              windows_submitted * cfg.iterations, acct, windows)


def drive_with_backend(gen, backend) -> SolveReport:
    """Run one backend generator to completion, draining between rounds.

    Only a ``policy="manual"`` backend needs the caller-side round barrier;
    self-draining backends (background farm policies) resolve futures on
    their own and the drain call is a harmless flush.  For cross-request
    packing, drive many generators in lockstep instead and drain once per
    round.
    """
    try:
        next(gen)
        while True:
            backend.drain()
            gen.send(None)
    except StopIteration as done:
        return done.value
