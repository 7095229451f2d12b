"""SLO-aware admission control for the continuous serving engine.

The drain policies (``repro_torch.farm``) decide WHEN queued work launches; this
module decides WHETHER work is allowed to queue at all.  An
:class:`AdmissionController` sits between ``SummarizationEngine.submit()``
and the solver backend and applies two checks per request:

* **Queue depth** -- ``max_queue_depth`` is a hard cap on requests admitted
  but not yet finished.  At the cap, submission raises
  :class:`EngineOverloadedError` with ``reason="depth"`` (load shedding: the
  caller retries or routes elsewhere), which is what lets the deadline drain
  policy actually meet its watermarks at saturation -- an unbounded queue
  makes every deadline infeasible eventually no matter how drains are
  scheduled.  Under ``shed="evict-lowest"`` the engine responds to a depth
  rejection by evicting the lowest-priority / slackest-deadline QUEUED
  request instead of shedding the newcomer (see
  ``SummarizationEngine._evict_for``); the controller just counts the
  eviction (``note_eviction``).

* **Deadline feasibility** -- for requests carrying a deadline, the
  controller estimates the completion time of everything already admitted
  plus this request, reusing the farm's shape-only packing estimator
  (:func:`repro_torch.farm.packing.estimate_packing` over per-job lane counts,
  replica-tiered exactly like a real drain) against the simulated hardware
  clock.  An infeasible request is rejected (``reason="deadline"``) -- or,
  under ``overload="degrade"``, retried at ``reads_floor`` anneal reads
  (less chip time per job, a cheaper but lower-quality solve) and admitted
  degraded if that fits.

When a :class:`repro_torch.serving.router.BackendRouter` is attached, feasibility
consults the router's cost models instead of assuming the farm: the router
predicts completion on EVERY routable backend (given the per-backend work
this controller has already admitted) and the request is admitted onto the
cheapest feasible one -- farm overload SPILLS onto the host pool before any
degrade/reject.  The chosen backend and predicted latency ride on the
:class:`AdmissionTicket`.

``overload="degrade"`` also floors the reads of any request admitted while
the queue sits above ``degrade_depth`` (default: half the cap), trading
summary quality for sustained goodput before the hard cap starts shedding.
Both checks are estimates on the SIMULATED clock -- they bound queued chip
work, not host wall time.  Admission never changes results of admitted
requests beyond the ``reads`` knob: jobs draw from their own keys, so a
request admitted with its requested reads is bit-identical under any
admission configuration (and under any routing decision, when the routable
backends run the same solver).

The controller also audits itself: ``on_done(request_id, realized=...)``
records realized-minus-estimated completion errors (a bounded deque), the
distribution is exposed via ``estimate_errors()``, and with
``auto_watermark=True`` the effective deadline watermark widens by the 90th
percentile of observed lateness -- the estimate's optimism about drain
slicing becomes a measured margin instead of a hand-tuned constant.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.farm.packing import estimate_packing, replica_tiers
from repro_torch.obs import Observability, TraceContext

# Minimum recorded lateness samples before auto_watermark starts widening;
# below this the quantile is noise.
_AUTO_WATERMARK_MIN_SAMPLES = 4


class EngineOverloadedError(RuntimeError):
    """Submission rejected by admission control.

    ``reason`` distinguishes the failing check: ``"depth"`` (the hard
    ``max_queue_depth`` cap -- under ``shed="evict-lowest"`` the engine may
    evict a lower-priority queued request and retry) vs ``"deadline"`` (no
    backend or degrade level makes the deadline feasible)."""

    def __init__(self, message: str, *, reason: str = "depth"):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs of the admission layer (``None`` depth = no bound).

    ``overload`` picks the response when a check fails: ``"reject"`` raises
    :class:`EngineOverloadedError`; ``"degrade"`` first retries the request
    at ``reads_floor`` reads and only rejects if even that cannot meet the
    deadline (the depth cap always rejects -- shrinking reads cannot shrink
    the queue).  ``shed`` picks the depth-cap policy: ``"reject-new"`` sheds
    the newcomer, ``"evict-lowest"`` lets the engine evict the
    lowest-priority / slackest-deadline QUEUED request to make room.
    ``deadline_watermark`` is the safety margin (simulated seconds) the
    completion estimate must clear; generous margins absorb the estimate's
    optimism about drain slicing -- or set ``auto_watermark=True`` to widen
    the margin from the measured estimate-error distribution instead."""

    max_queue_depth: Optional[int] = None
    overload: str = "reject"  # "reject" | "degrade"
    reads_floor: int = 2
    degrade_depth: Optional[int] = None  # default: max_queue_depth // 2
    deadline_watermark: float = 0.0
    # Gate deadline-carrying requests on the packing-estimate feasibility
    # check.  Off for the engine's default (admit-everything) controller:
    # stamping a deadline on a request must not start shedding load unless
    # the operator opted into admission control.
    deadline_feasibility: bool = True
    shed: str = "reject-new"  # "reject-new" | "evict-lowest"
    auto_watermark: bool = False

    def __post_init__(self):
        if self.overload not in ("reject", "degrade"):
            raise ValueError(
                f"overload must be 'reject' or 'degrade', got {self.overload!r}"
            )
        if self.shed not in ("reject-new", "evict-lowest"):
            raise ValueError(
                f"shed must be 'reject-new' or 'evict-lowest', got {self.shed!r}"
            )
        if self.reads_floor < 1:
            raise ValueError(f"reads_floor must be >= 1, got {self.reads_floor}")


@dataclasses.dataclass(frozen=True)
class AdmissionTicket:
    """Outcome of one admitted request."""

    request_id: int
    reads: int  # effective reads (== requested unless degraded)
    degraded: bool
    est_completion: float  # estimated sim-clock completion (0 if unknown)
    backend: Optional[str] = None  # router-chosen backend name (None = default)
    predicted_seconds: float = 0.0  # router-predicted latency incl. queue wait
    sim_at_admit: float = 0.0  # backend sim clock when admitted
    # Trace propagation: the engine's root-span context rides the ticket so
    # downstream layers can parent to the request without a side lookup.
    ctx: Optional[TraceContext] = None


@dataclasses.dataclass
class AdmissionStats:
    admitted: int = 0
    rejected: int = 0
    degraded: int = 0
    depth: int = 0  # requests currently admitted-but-unfinished
    peak_depth: int = 0
    evicted: int = 0  # queued requests evicted to make room (shed="evict-lowest")
    spilled: int = 0  # requests routed off the primary backend


@dataclasses.dataclass
class _Inflight:
    """Admitted-but-unfinished bookkeeping for one request."""

    jobs: List[tuple]  # (lanes, reads) per planned solve job
    backend: Optional[str] = None
    work_seconds: float = 0.0  # predicted request work (excl. queue wait)
    est_completion: float = 0.0
    priority: int = 0


class AdmissionController:
    """Tracks admitted-but-unfinished work and gates new submissions.

    ``lanes_per_chip`` / ``n_chips`` / ``seconds_per_solve`` describe the
    backend's packing geometry (taken from the farm; ``None`` for host
    backends, which disables the deadline-feasibility estimate and leaves
    only the depth cap).  ``router`` (a
    :class:`repro_torch.serving.router.BackendRouter`) replaces the farm-only
    estimate with per-backend cost-model feasibility + spill.  Thread-safe:
    ``admit`` may race with ``on_done`` from the engine's driver thread.
    """

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        *,
        lanes_per_chip: Optional[int] = None,
        n_chips: int = 1,
        seconds_per_solve: float = 0.0,
        replica_bucket: int = 8,
        tier_ratio: float = 2.0,
        router=None,
        chips_available: Optional[Callable[[], int]] = None,
        obs=None,
    ):
        self.config = config or AdmissionConfig()
        self.lanes_per_chip = lanes_per_chip
        self.n_chips = max(1, n_chips)
        # Live health-aware chip count (e.g. CobiFarm.available_chips):
        # quarantined chips shrink the feasibility estimate's parallelism so
        # a degraded farm admits less, not the same.
        self.chips_available = chips_available
        self.seconds_per_solve = seconds_per_solve
        self.replica_bucket = replica_bucket
        self.tier_ratio = tier_ratio
        self.router = router
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Inflight] = {}
        # realized - estimated completion, most recent requests only.
        self._est_errors: deque = deque(maxlen=256)
        self.obs = None
        self.attach_obs(obs if obs is not None else Observability.disabled())

    def attach_obs(self, obs) -> None:
        """Bind (or rebind) admission counters to an ``Observability``
        bundle; counter values carry over on rebind."""
        carry = None
        if self.obs is not None:
            carry = {
                "admitted": self._m_admitted.value,
                "rejected": self._m_rejected.children(),
                "degraded": self._m_degraded.value,
                "evicted": self._m_evicted.value,
                "spilled": self._m_spilled.value,
                "peak": self._m_peak.value,
            }
        self.obs = obs
        reg = obs.registry
        self._m_admitted = reg.counter(
            "admission_admitted_total", "requests admitted")
        self._m_rejected = reg.counter(
            "admission_rejected_total", "requests shed by admission",
            labels=("reason",))
        self._m_degraded = reg.counter(
            "admission_degraded_total", "requests admitted at floored reads")
        self._m_evicted = reg.counter(
            "admission_evicted_total",
            "queued requests evicted to make room")
        self._m_spilled = reg.counter(
            "admission_spilled_total",
            "requests routed off the primary backend at admission")
        self._m_depth = reg.gauge(
            "admission_depth", "requests admitted but unfinished")
        self._m_peak = reg.gauge(
            "admission_peak_depth", "high-water admitted depth")
        if carry:
            self._m_admitted.inc(carry["admitted"])
            for (reason,), child in carry["rejected"]:
                if child.value:
                    self._m_rejected.labels(reason=reason).inc(child.value)
            self._m_degraded.inc(carry["degraded"])
            self._m_evicted.inc(carry["evicted"])
            self._m_spilled.inc(carry["spilled"])
            self._m_peak.set(max(self._m_peak.value, carry["peak"]))
        with self._lock:
            self._m_depth.set(len(self._inflight))

    # ------------------------------------------------------------------ API

    def admit(
        self,
        request_id: int,
        job_lanes: Sequence[int],
        reads: int,
        deadline: Optional[float],
        sim_now: float,
        *,
        priority: int = 0,
        steps: int = 400,
        iterations: int = 1,
        quality_floor: Optional[float] = None,
        extra_seconds: float = 0.0,
        ctx: Optional[TraceContext] = None,
    ) -> AdmissionTicket:
        """Gate one request carrying ``len(job_lanes)`` planned solve jobs.

        Returns a ticket with the effective ``reads`` (and, with a router,
        the chosen ``backend`` + predicted latency) or raises
        :class:`EngineOverloadedError`.  ``job_lanes`` are the estimated spin
        counts of the request's solve jobs (iterations x decomposition
        windows); ``sim_now`` is the primary backend's current clock.
        ``extra_seconds`` is pre-solve pipeline time the request must spend
        before its first job can launch (the engine passes the encoder
        stage's EWMA encode estimate) -- it eats deadline slack in the
        feasibility check but never counts as backend work.
        """
        cfg = self.config
        with self._lock:
            depth = len(self._inflight)
            if cfg.max_queue_depth is not None and depth >= cfg.max_queue_depth:
                self._reject(request_id, "depth", ctx)
                raise EngineOverloadedError(
                    f"admission queue full: {depth} requests in flight "
                    f"(max_queue_depth={cfg.max_queue_depth})",
                    reason="depth",
                )
            eff_reads, degraded = reads, False
            if cfg.overload == "degrade":
                # degrade_depth works standalone: an operator may want
                # quality degradation with no hard shedding cap at all.
                soft = (cfg.degrade_depth if cfg.degrade_depth is not None
                        else (cfg.max_queue_depth or 0) // 2)
                if soft > 0 and depth >= soft:
                    eff_reads = min(reads, cfg.reads_floor)
                    degraded = eff_reads < reads
            # Encoder time spends the same deadline slack a wider watermark
            # would; folding it in keeps both feasibility branches honest.
            watermark = self._effective_watermark_locked() + max(
                extra_seconds, 0.0
            )
            backend = None
            predicted = 0.0
            est = 0.0
            work = 0.0
            if self.router is not None:
                decision, eff_reads, degraded = self._route_locked(
                    job_lanes, eff_reads, degraded, deadline, sim_now,
                    steps=steps, iterations=iterations, watermark=watermark,
                    quality_floor=quality_floor, depth=depth,
                    request_id=request_id, ctx=ctx,
                )
                backend = decision.backend
                predicted = decision.predicted_seconds
                work = max(predicted - decision.queue_seconds, 0.0)
                est = sim_now + predicted
                if decision.reason == "spill":
                    self._m_spilled.inc()
            elif (deadline is not None and cfg.deadline_feasibility
                    and self.lanes_per_chip):
                est = self._estimate_completion_locked(
                    job_lanes, eff_reads, sim_now
                )
                if est > deadline - watermark:
                    if cfg.overload == "degrade" and eff_reads > cfg.reads_floor:
                        eff_reads = cfg.reads_floor
                        est = self._estimate_completion_locked(
                            job_lanes, eff_reads, sim_now
                        )
                        degraded = est <= deadline - watermark
                    if est > deadline - watermark:
                        self._reject(request_id, "deadline", ctx)
                        raise EngineOverloadedError(
                            f"deadline infeasible: estimated completion "
                            f"{est:.6f}s (sim) > deadline {deadline:.6f}s - "
                            f"watermark {watermark:.6f}s with "
                            f"{depth} requests in flight",
                            reason="deadline",
                        )
                work = max(est - sim_now, 0.0)
            self._inflight[request_id] = _Inflight(
                jobs=[(int(n), eff_reads) for n in job_lanes],
                backend=backend,
                work_seconds=work,
                est_completion=est,
                priority=priority,
            )
            self._m_admitted.inc()
            if degraded:
                self._m_degraded.inc()
            new_depth = len(self._inflight)
            self._m_depth.set(new_depth)
            self._m_peak.set(max(self._m_peak.value, new_depth))
            tracer = self.obs.tracer
            if tracer.enabled:
                tracer.event(
                    "admission.admit", trace_id=request_id,
                    parent=(ctx.span_id if ctx is not None
                            else tracer.root_id(request_id)),
                    track="admission", reads=eff_reads, degraded=degraded,
                    backend=backend, predicted_seconds=predicted,
                    est_completion=est, depth=new_depth)
            return AdmissionTicket(
                request_id, eff_reads, degraded, est,
                backend=backend, predicted_seconds=predicted,
                sim_at_admit=sim_now, ctx=ctx,
            )

    def on_done(self, request_id: int,
                realized: Optional[float] = None) -> None:
        """Release a request's admitted work (completion, failure, cancel).

        ``realized`` is the request's actual sim-clock completion time; when
        given (and the request carried a completion estimate) the
        estimate error is recorded for ``estimate_errors()`` /
        ``auto_watermark``.
        """
        with self._lock:
            rec = self._inflight.pop(request_id, None)
            self._m_depth.set(len(self._inflight))
            if (rec is not None and realized is not None
                    and rec.est_completion > 0.0):
                self._est_errors.append(realized - rec.est_completion)

    def note_eviction(self, request_id: int) -> None:
        """Record that the engine evicted queued ``request_id`` to make room
        (``shed="evict-lowest"``); releases its admitted work."""
        with self._lock:
            self._inflight.pop(request_id, None)
            self._m_evicted.inc()
            self._m_depth.set(len(self._inflight))
        tracer = self.obs.tracer
        if tracer.enabled:
            tracer.event("admission.evict", trace_id=request_id,
                         parent=tracer.root_id(request_id),
                         track="admission")

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def is_active(self, request_id: int) -> bool:
        """True while ``request_id`` is admitted-but-unfinished (used by the
        engine to keep batch ids from colliding with live submit() traffic)."""
        with self._lock:
            return request_id in self._inflight

    def stats(self) -> AdmissionStats:
        """Registry view: rebuilds the legacy :class:`AdmissionStats` shape
        from the ``admission_*`` metric families."""
        return AdmissionStats(
            admitted=int(self._m_admitted.value),
            rejected=int(self._m_rejected.total()),
            degraded=int(self._m_degraded.value),
            depth=int(self._m_depth.value),
            peak_depth=int(self._m_peak.value),
            evicted=int(self._m_evicted.value),
            spilled=int(self._m_spilled.value),
        )

    def estimate_errors(self) -> dict:
        """Distribution of realized-minus-estimated completion (seconds).

        Positive = the request finished LATER than admission estimated (the
        dangerous direction for deadlines).  ``watermark_extra`` is the
        widening ``auto_watermark`` currently applies."""
        with self._lock:
            errs = sorted(self._est_errors)
            extra = (self._effective_watermark_locked()
                     - self.config.deadline_watermark)
        if not errs:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                    "max": 0.0, "watermark_extra": extra}
        def q(frac):
            return errs[min(len(errs) - 1, int(frac * len(errs)))]
        return {
            "n": len(errs),
            "mean": sum(errs) / len(errs),
            "p50": q(0.5),
            "p90": q(0.9),
            "max": errs[-1],
            "watermark_extra": extra,
        }

    def effective_watermark(self) -> float:
        """The deadline margin feasibility currently enforces (config
        watermark + any auto-widening)."""
        with self._lock:
            return self._effective_watermark_locked()

    # ------------------------------------------------------------ internals

    def _effective_watermark_locked(self) -> float:
        wm = self.config.deadline_watermark
        if not self.config.auto_watermark:
            return wm
        late = sorted(e for e in self._est_errors if e > 0.0)
        if len(late) < _AUTO_WATERMARK_MIN_SAMPLES:
            return wm
        # Widen by the 90th percentile of observed lateness: 9 out of 10
        # historical estimate misses would have fit inside the margin.
        return wm + late[min(len(late) - 1, int(0.9 * len(late)))]

    def _reject(self, request_id: int, reason: str,
                ctx: Optional[TraceContext]) -> None:
        """Count (and trace) one shed request."""
        self._m_rejected.labels(reason=reason).inc()
        tracer = self.obs.tracer
        if tracer.enabled:
            tracer.event(
                "admission.reject", trace_id=request_id,
                parent=(ctx.span_id if ctx is not None
                        else tracer.root_id(request_id)),
                track="admission", reason=reason)

    def _route_locked(self, job_lanes, eff_reads, degraded, deadline,
                      sim_now, *, steps, iterations, watermark,
                      quality_floor, depth, request_id=0, ctx=None):
        """Router-backed feasibility: per-backend predictions over the work
        already admitted; degrade-retry on infeasibility.  Returns
        ``(RouteDecision, eff_reads, degraded)`` or raises."""
        from repro_torch.serving.router import InfeasibleRoute

        cfg = self.config
        queued = self._queued_seconds_locked()
        slack = None
        if deadline is not None and cfg.deadline_feasibility:
            slack = deadline - sim_now - watermark
        jobs = [(int(n), eff_reads) for n in job_lanes]
        try:
            decision = self.router.decide(
                jobs, steps=steps, iterations=iterations,
                deadline_slack=slack, queued_seconds=queued,
                quality_floor=quality_floor, tag=request_id,
            )
            return decision, eff_reads, degraded
        except InfeasibleRoute as exc:
            if cfg.overload == "degrade" and eff_reads > cfg.reads_floor:
                floored = [(int(n), cfg.reads_floor) for n in job_lanes]
                try:
                    decision = self.router.decide(
                        floored, steps=steps, iterations=iterations,
                        deadline_slack=slack, queued_seconds=queued,
                        quality_floor=quality_floor, tag=request_id,
                    )
                    return decision, cfg.reads_floor, True
                except InfeasibleRoute:
                    pass
            self._reject(request_id, "deadline", ctx)
            raise EngineOverloadedError(
                f"no routable backend is feasible with {depth} requests in "
                f"flight: {exc}",
                reason="deadline",
            ) from exc

    def _queued_seconds_locked(self) -> Dict[str, float]:
        """Predicted seconds of already-admitted work, per backend -- the
        router's queue-wait input (the admission-side view of load, coherent
        with the sequential per-request model of the estimator below)."""
        queued: Dict[str, float] = {}
        for rec in self._inflight.values():
            if rec.backend is None:
                continue
            queued[rec.backend] = (
                queued.get(rec.backend, 0.0) + rec.work_seconds
            )
        return queued

    def _estimate_completion_locked(
        self, job_lanes: Sequence[int], reads: int, sim_now: float
    ) -> float:
        """Sim-clock completion estimate for admitted work + this request.

        Mirrors a drain PER REQUEST: each request's jobs tier by read count
        (``replica_tiers``), each tier BFD-packs (``estimate_packing``), bins
        round-robin over chips, a bin occupies its chip for ``tier_reads *
        seconds_per_solve``; the per-request latencies then SUM.  Assuming
        every inflight request drains alone is deliberately pessimistic: the
        engine's continuous driver adopts arrivals between rounds, so a
        burst's drains slice the queue into arrival-order fragments, and any
        cross-request packing a real drain achieves only finishes earlier
        than this bound.  (Decomposed requests submit window waves that can
        fragment further; ``deadline_watermark`` is the margin for that.)
        """
        chips = self.n_chips
        if self.chips_available is not None:
            try:
                chips = max(1, min(int(self.chips_available()), self.n_chips))
            except Exception:
                chips = self.n_chips
        per_request = [list(rec.jobs) for rec in self._inflight.values()]
        per_request.append([(int(n), reads) for n in job_lanes])
        total = 0.0
        for jobs in per_request:
            if not jobs:
                continue
            sizes = [n for n, _ in jobs]
            tiers = replica_tiers([r for _, r in jobs],
                                  bucket=self.replica_bucket,
                                  ratio=self.tier_ratio)
            for tier_reads, idxs in tiers:
                est = estimate_packing([sizes[i] for i in idxs],
                                       self.lanes_per_chip)
                cycles = math.ceil(est.n_bins / chips)
                total += cycles * tier_reads * self.seconds_per_solve
        return sim_now + total
