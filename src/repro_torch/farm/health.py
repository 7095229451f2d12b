"""Per-chip health tracking: circuit breakers and quarantine-aware placement.

Each chip gets a three-state breaker driven by drain outcomes:

* **closed** -- healthy, takes regular traffic;
* **open** -- quarantined after consecutive failures or a high EWMA
  fault rate; takes no traffic until a sim-clock cooldown elapses
  (cooldown escalates on every re-open);
* **half-open** -- cooldown elapsed; the chip is eligible for a single
  probe bin per drain (taken from the *end* of the drain so urgent bins
  stay on healthy chips).  A clean probe closes the breaker; a faulted
  probe re-opens it with a longer cooldown.

All timing uses the farm's sim clock so chaos tests are deterministic.
:class:`FarmHealth` is deliberately lock-free: the scheduler already
serializes ``schedule()``/``record()`` under its own state lock.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["BreakerConfig", "ChipBreaker", "FarmHealth"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclass(frozen=True)
class BreakerConfig:
    """Trip/cooldown policy shared by all chips of a farm."""

    consecutive_failures: int = 3     # hard trips regardless of rate
    ewma_alpha: float = 0.25          # fault-rate smoothing
    ewma_threshold: float = 0.5       # trip when smoothed rate exceeds this
    min_events: int = 4               # EWMA needs this many samples to trip
    cooldown: float = 0.01            # sim seconds before half-open
    cooldown_factor: float = 2.0      # escalation on every re-open
    cooldown_max: float = 1.0


@dataclass
class ChipBreaker:
    """Circuit breaker for one chip (sim-clock driven)."""

    cfg: BreakerConfig
    _state: str = CLOSED
    consecutive: int = 0
    ewma: float = 0.0
    events: int = 0
    opened_at: float = 0.0
    open_count: int = 0
    trips: int = 0

    def state(self, now: float) -> str:
        """Current state; promotes open -> half-open once cooled down."""
        if self._state == OPEN and now >= self.opened_at + self._cooldown():
            self._state = HALF_OPEN
        return self._state

    def _cooldown(self) -> float:
        esc = self.cfg.cooldown * (self.cfg.cooldown_factor ** max(0, self.open_count - 1))
        return min(self.cfg.cooldown_max, esc)

    def _open(self, now: float) -> None:
        self._state = OPEN
        self.opened_at = now
        self.open_count += 1
        self.trips += 1
        self.consecutive = 0

    def record(self, outcome: str, now: float) -> None:
        """Fold in one drain outcome: ``ok`` | ``degraded`` | ``failed``.

        ``degraded`` means the chip produced repairable corruption: it
        raises the fault rate but does not count as a hard failure.
        """
        state = self.state(now)
        bad = outcome != "ok"
        self.events += 1
        self.ewma += self.cfg.ewma_alpha * ((1.0 if bad else 0.0) - self.ewma)
        if state == HALF_OPEN:
            # Probe verdict: any fault re-opens (escalated), success closes
            # with partial memory so a flapping chip re-trips quickly.
            if bad:
                self._open(now)
            else:
                self._state = CLOSED
                self.consecutive = 0
                self.ewma *= 0.5
            return
        if outcome == "failed":
            self.consecutive += 1
        elif outcome == "ok":
            self.consecutive = 0
        if state == CLOSED and (
            self.consecutive >= self.cfg.consecutive_failures
            or (self.events >= self.cfg.min_events
                and self.ewma > self.cfg.ewma_threshold)
        ):
            self._open(now)


@dataclass
class FarmHealth:
    """Breaker bank for a farm; owns quarantine-aware bin placement."""

    n_chips: int
    cfg: BreakerConfig = field(default_factory=BreakerConfig)
    breakers: List[ChipBreaker] = field(default_factory=list)

    # Metrics handles; bound by attach_obs (plain class attrs, not fields).
    _m_outcomes = None
    _m_trips = None
    _m_quarantined = None

    def __post_init__(self):
        if not self.breakers:
            self.breakers = [ChipBreaker(self.cfg) for _ in range(self.n_chips)]

    def attach_obs(self, obs) -> None:
        """Mirror breaker activity into a metrics registry.  The farm
        scheduler calls this with its shared ``Observability`` bundle, so
        per-chip outcomes / trips / quarantine depth show up next to every
        other serving metric."""
        reg = obs.registry
        self._m_outcomes = reg.counter(
            "chip_drain_outcomes_total",
            "per-chip drain outcomes folded into breakers",
            labels=("chip", "outcome"))
        self._m_trips = reg.counter(
            "chip_breaker_trips_total", "breaker open transitions per chip",
            labels=("chip",))
        self._m_quarantined = reg.gauge(
            "chips_quarantined", "chips currently quarantined (breaker open)")

    # -- views ---------------------------------------------------------

    def states(self, now: float) -> List[str]:
        return [b.state(now) for b in self.breakers]

    def available_chips(self, now: float) -> int:
        """Chips that can take work (closed + half-open); floored at 1.

        The floor keeps capacity/latency estimates finite when every
        breaker is open -- ``schedule()`` force-probes in that case, so
        the farm never deadlocks.
        """
        n = sum(1 for s in self.states(now) if s != OPEN)
        return max(1, n)

    def quarantined(self, now: float) -> List[int]:
        return [c for c, s in enumerate(self.states(now)) if s == OPEN]

    # -- placement -----------------------------------------------------

    def schedule(self, n_bins: int, now: float) -> List[int]:
        """Assign each of ``n_bins`` drain bins to a chip.

        Closed chips take the head of the drain round-robin; each
        half-open chip steals at most one probe bin from the tail.  With
        no closed chips, half-open chips carry the drain; with every
        breaker open, the chip closest to re-admission is force-probed
        (its cooldown is treated as elapsed) so work always lands.
        """
        states = self.states(now)
        closed = [c for c, s in enumerate(states) if s == CLOSED]
        half = [c for c, s in enumerate(states) if s == HALF_OPEN]
        if not closed and not half:
            # Everything is quarantined: force-probe the earliest reopener.
            probe = min(range(self.n_chips),
                        key=lambda c: self.breakers[c].opened_at
                        + self.breakers[c]._cooldown())
            self.breakers[probe]._state = HALF_OPEN
            half = [probe]
        if not closed:
            return [half[b % len(half)] for b in range(n_bins)]
        assign = [closed[b % len(closed)] for b in range(n_bins)]
        # One probe bin per half-open chip, stolen from the tail.
        for i, chip in enumerate(half):
            pos = n_bins - 1 - i
            if pos < 0:
                break
            assign[pos] = chip
        return assign

    # -- outcomes ------------------------------------------------------

    def record(self, chip: int, outcome: str, now: float) -> None:
        b = self.breakers[chip]
        trips_before = b.trips
        b.record(outcome, now)
        if self._m_outcomes is not None:
            self._m_outcomes.labels(chip=chip, outcome=outcome).inc()
            if b.trips > trips_before:
                self._m_trips.labels(chip=chip).inc()
            self._m_quarantined.set(len(self.quarantined(now)))

    def stats(self, now: float) -> Dict[str, object]:
        states = self.states(now)
        return {
            "states": list(states),
            "quarantined": [c for c, s in enumerate(states) if s == OPEN],
            "trips": sum(b.trips for b in self.breakers),
            "available": self.available_chips(now),
        }
