"""Cost-model-driven backend routing: quality / latency / energy frontier.

The ``SolverBackend`` registry serves COBI, tabu, SA and brute through one
``submit()`` surface, but something has to PICK the backend.  The
:class:`BackendRouter` sits between the admission layer and the backends and
turns admission "degrade" into "degrade OR re-route": for each admitted
request (and, on the decomposed driver, each decomposition window) it

1. predicts latency, energy and quality gap on every routable backend from
   a :class:`repro_torch.serving.calibration.CalibrationProfile`,
2. filters to backends whose predicted quality gap clears the request's
   quality floor and whose predicted completion (queue wait + request
   latency) meets the deadline slack, then
3. picks the cheapest survivor under a configurable objective --
   ``"min-energy"`` (the paper's 100-1000x ETS edge says: stay on the chip
   farm until it cannot meet the deadline), ``"min-latency"``, or
   ``"weighted"``.

Farm overload therefore SPILLS onto the host thread pool (same solver, same
keys -> bit-identical results, host watts instead of chip milliwatts)
instead of shedding the request; only when no backend is feasible does
admission fall back to degrade/reject.  Decisions are pure functions of the
profile and the queue state, so a checked-in profile reproduces them
exactly; realized receipts stream back through ``observe()`` into the
profile's EWMA corrections so predictions track the live farm.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import Observability
from repro_torch.serving.calibration import BackendCostModel, CalibrationProfile

OBJECTIVES = ("min-energy", "min-latency", "weighted")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing knobs.

    ``objective`` orders feasible backends; ``"weighted"`` minimizes
    ``latency_weight * seconds + energy_weight * joules``.  ``spill=False``
    restricts routing to ``primary`` (admission-only behaviour with router
    bookkeeping -- the A/B baseline of the routed benchmark).
    ``quality_floor`` is the default maximum acceptable predicted quality
    gap (probability of missing the 0.9-normalized threshold); ``None``
    accepts any.  ``deadline_watermark`` is the safety margin predictions
    must clear, over and above the admission layer's own watermark.
    """

    objective: str = "min-energy"
    latency_weight: float = 1.0
    energy_weight: float = 1.0
    quality_floor: Optional[float] = None
    spill: bool = True
    primary: Optional[str] = None  # default: profile order
    deadline_watermark: float = 0.0

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"objective must be one of {OBJECTIVES}, got {self.objective!r}"
            )


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routing outcome: where the work goes and what the model expects.

    ``predicted_seconds`` includes the predicted queue wait
    (``queue_seconds``); ``reason`` is ``"objective"`` when the cheapest
    backend was feasible outright and ``"spill"`` when the objective winner
    failed feasibility and the work re-routed to a pricier survivor.
    """

    backend: str
    predicted_seconds: float
    predicted_energy: float
    predicted_quality_gap: float
    queue_seconds: float = 0.0
    reason: str = "objective"


class InfeasibleRoute(RuntimeError):
    """No routable backend meets the deadline slack and quality floor."""


class BackendRouter:
    """Routes solve work across a named set of ``SolverBackend``s.

    ``backends`` maps profile model names to live backend objects; the
    profile supplies the cost models.  Thread-safe: ``decide``/``observe``
    may race between the submit path and the engine driver.
    """

    def __init__(
        self,
        backends: Dict[str, object],
        profile: CalibrationProfile,
        config: Optional[RouterConfig] = None,
        *,
        obs=None,
    ):
        if not backends:
            raise ValueError("router needs at least one backend")
        for name in backends:
            profile.model(name)  # raises on an unprofiled backend
        self.backends = dict(backends)
        self.profile = profile
        self.config = config or RouterConfig()
        self._lock = threading.Lock()
        self._order = [n for n in profile.models if n in self.backends]
        primary = self.config.primary or self._order[0]
        if primary not in self.backends:
            raise ValueError(f"primary backend {primary!r} not registered")
        self.primary = primary
        self.obs = None
        self.attach_obs(obs if obs is not None else Observability.disabled())

    def attach_obs(self, obs) -> None:
        """Bind (or rebind) routing counters to an ``Observability``
        bundle; counter values carry over on rebind."""
        carry = []
        spills = failovers = 0.0
        if self.obs is not None:
            carry = self._m_decisions.children()
            spills = self._m_spills.value
            failovers = self._m_failovers.value
        self.obs = obs
        reg = obs.registry
        self._m_decisions = reg.counter(
            "router_decisions_total", "routing decisions by backend",
            labels=("backend", "reason"))
        self._m_spills = reg.counter(
            "router_spills_total",
            "decisions where the objective winner failed feasibility")
        self._m_failovers = reg.counter(
            "router_failovers_total", "recovery failovers folded in")
        for (backend, reason), child in carry:
            if child.value:
                self._m_decisions.labels(
                    backend=backend, reason=reason).inc(child.value)
        if spills:
            self._m_spills.inc(spills)
        if failovers:
            self._m_failovers.inc(failovers)

    # --------------------------------------------------------------- route

    def decide(
        self,
        jobs: Sequence[Tuple[int, int]],
        *,
        steps: int = 400,
        iterations: int = 1,
        deadline_slack: Optional[float] = None,
        queued_seconds: Optional[Dict[str, float]] = None,
        quality_floor: Optional[float] = None,
        tag: Optional[int] = None,
    ) -> RouteDecision:
        """Pick a backend for one request's ``(n, reads)`` solve jobs.

        ``deadline_slack`` is seconds-from-now until the deadline (``None``
        = no deadline); ``queued_seconds`` maps backend name -> predicted
        seconds of already-committed work (the admission layer's view --
        when omitted, live ``capacity_hint()``s are consulted); ``tag`` is
        the request id, used only to correlate the decision's trace event.
        Raises :class:`InfeasibleRoute` when no backend qualifies;
        admission then degrades or rejects exactly as it would without a
        router.
        """
        floor = quality_floor if quality_floor is not None \
            else self.config.quality_floor
        names = self._order if self.config.spill else [self.primary]
        candidates = []
        for name in names:
            model = self.profile.model(name)
            self._refresh_fault_rate(name, model)
            gap = max(
                (model.quality_gap(n, iterations) for n, _ in jobs),
                default=0.0,
            )
            if floor is not None and gap > floor:
                continue
            wait = self._queue_seconds(name, model, queued_seconds)
            lat = wait + model.request_seconds(jobs, steps)
            energy = model.request_energy(jobs, steps)
            candidates.append((self._score(lat, energy), name, lat, energy,
                               gap, wait))
        if not candidates:
            raise InfeasibleRoute(
                f"no backend within quality floor {floor!r} "
                f"(routable: {names})"
            )
        candidates.sort(key=lambda c: (c[0], self._order.index(c[1])))
        margin = self.config.deadline_watermark
        for rank, (_, name, lat, energy, gap, wait) in enumerate(candidates):
            if deadline_slack is not None and lat > deadline_slack - margin:
                continue
            reason = "objective" if rank == 0 else "spill"
            self._m_decisions.labels(backend=name, reason=reason).inc()
            if reason == "spill":
                self._m_spills.inc()
            tracer = self.obs.tracer
            if tracer.enabled:
                tracer.event(
                    "router.decide", trace_id=tag,
                    parent=tracer.root_id(tag), track="router",
                    backend=name, reason=reason, predicted_seconds=lat,
                    predicted_energy=energy, queue_seconds=wait)
            return RouteDecision(
                backend=name, predicted_seconds=lat, predicted_energy=energy,
                predicted_quality_gap=gap, queue_seconds=wait, reason=reason,
            )
        raise InfeasibleRoute(
            f"no backend meets deadline slack {deadline_slack:.6f}s "
            f"(best predictions: "
            + ", ".join(f"{c[1]}={c[2]:.6f}s" for c in candidates)
            + ")"
        )

    def route_window(
        self,
        n: int,
        reads: int,
        *,
        steps: int = 400,
        iterations: int = 1,
        deadline_slack: Optional[float] = None,
        quality_floor: Optional[float] = None,
    ) -> Tuple[str, object]:
        """Per-decomposition-window routing against LIVE capacity hints.

        Same policy as :meth:`decide` but for one window's job batch;
        returns ``(name, backend)``.  Falls back to the primary backend
        when nothing is feasible -- mid-request windows must run somewhere;
        the admission layer already vouched for the request as a whole.
        """
        name, backend, _ = self.route_window_info(
            n, reads, steps=steps, iterations=iterations,
            deadline_slack=deadline_slack, quality_floor=quality_floor)
        return name, backend

    def route_window_info(
        self,
        n: int,
        reads: int,
        *,
        steps: int = 400,
        iterations: int = 1,
        deadline_slack: Optional[float] = None,
        quality_floor: Optional[float] = None,
        tag: Optional[int] = None,
    ) -> Tuple[str, object, float]:
        """:meth:`route_window` plus the decision's predicted seconds.

        The prediction rides the window so its realized receipts can feed
        ``observe()`` PER WINDOW -- including spilled windows, whose
        realized/predicted ratio would otherwise never reach the spilled
        backend's calibration EWMA.  The infeasible fallback still returns
        the primary's model prediction, so even forced windows calibrate.

        The returned prediction is WORK-ONLY (queue wait stripped): a
        window's realized side is its metered chip/host seconds, so the
        calibration ratio must compare like with like.
        """
        jobs = [(n, reads)] * max(iterations, 1)
        try:
            d = self.decide(jobs, steps=steps, iterations=iterations,
                            deadline_slack=deadline_slack,
                            quality_floor=quality_floor, tag=tag)
            work = max(d.predicted_seconds - d.queue_seconds, 0.0)
            return d.backend, self.backends[d.backend], work
        except InfeasibleRoute:
            model = self.profile.model(self.primary)
            lat = model.request_seconds(jobs, steps)
            return self.primary, self.backends[self.primary], lat

    # ------------------------------------------------------------ feedback

    def observe(self, name: str, *, predicted_seconds: float,
                realized_seconds: float, predicted_energy: float = 0.0,
                realized_energy: float = 0.0) -> None:
        """Fold one request's realized receipts into the profile's EWMA."""
        with self._lock:
            self.profile.observe(
                name,
                predicted_seconds=predicted_seconds,
                realized_seconds=realized_seconds,
                predicted_energy=predicted_energy,
                realized_energy=realized_energy,
            )

    def note_failover(self, name: str) -> None:
        """Record a recovery failover onto ``name`` (a job moved there after
        its retry budget ran out -- distinct from an admission-time spill)."""
        if name in self.backends:
            self._m_decisions.labels(backend=name, reason="failover").inc()
        self._m_failovers.inc()

    def stats(self) -> dict:
        """Registry view over the ``router_*`` counter families."""
        decisions = {n: 0 for n in self.backends}
        for (backend, _reason), child in self._m_decisions.children():
            decisions[backend] = decisions.get(backend, 0) + int(child.value)
        return {
            "decisions": decisions,
            "spills": int(self._m_spills.value),
            "failovers": int(self._m_failovers.value),
        }

    # ------------------------------------------------------------ internal

    def _score(self, seconds: float, joules: float) -> float:
        cfg = self.config
        if cfg.objective == "min-energy":
            return joules
        if cfg.objective == "min-latency":
            return seconds
        return cfg.latency_weight * seconds + cfg.energy_weight * joules

    def _refresh_fault_rate(self, name: str,
                            model: BackendCostModel) -> None:
        """Overwrite the model's fault-rate prior with the live backend's
        observed rate (``backend.fault_rate()`` -- the breaker bank's fault
        EWMA on the farm).  The profile value is a fit-time prior; once the
        backend reports its own health, routing scores its EFFECTIVE
        latency (expected retries x clean latency), so a flaky-but-fast
        backend loses to a clean one."""
        live = getattr(self.backends[name], "fault_rate", None)
        if live is None:
            return
        try:
            model.fault_rate = min(max(float(live()), 0.0), 1.0)
        except Exception:
            pass  # an unhealthy hint must never fail routing

    def _queue_seconds(self, name: str, model: BackendCostModel,
                       queued: Optional[Dict[str, float]]) -> float:
        backend = self.backends[name]
        hint = getattr(backend, "capacity_hint", None)
        live = 0.0
        if hint is not None:
            try:
                live = max(hint().est_queue_seconds, 0.0)
            except Exception:
                live = 0.0
        if queued is None:
            return live
        # Reconcile the two views of load: the admission ledger knows about
        # admitted-but-not-yet-submitted work, the scheduler's capacity hint
        # knows about queued jobs AND health-quarantined chips shrinking the
        # effective parallelism.  Taking the max means a burst can never
        # over-admit past what the scheduler itself says is queued, and a
        # degraded farm looks as slow to admission as it does to itself.
        return max(max(queued.get(name, 0.0), 0.0), live)
