"""Per-request fault recovery: deadline-budgeted retry, failover, typed failure.

The farm surfaces faults as typed exceptions on individual job futures
(:class:`repro_torch.farm.faults.FarmFault` subclasses: drain timeouts, chip
failures, corrupt readouts).  This module decides what a serving request
does about them:

* **retry** the job on the same backend while the attempt count is under
  ``max_retries`` AND the request's remaining deadline slack covers a
  capped exponential backoff margin plus the job's estimated run time.
  The backoff is expressed as *required slack* rather than a wall-clock
  sleep: the farm's next drain is the earliest retry opportunity anyway,
  so the margin models "a retry this late must still leave room to run";
* **fail over** to the pool backend (the router's existing spill target)
  once the retry budget is exhausted -- same instance, same key, so a
  same-solver pool returns bit-identical spins;
* **fail typed**: when neither is possible, raise :class:`RequestFailed`
  carrying the partial receipts of every faulted attempt, so the caller
  gets a terminal, inspectable error instead of a stranded future.

Bit-identity: a retried or failed-over job resubmits the SAME quantized
instance under the SAME solve key, and each job's result depends only on
(instance, key) -- never on drain composition -- so any job that
eventually succeeds contributes exactly the spins the fault-free run
would have produced.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.farm.faults import FarmFault
from repro_torch.obs import Observability

__all__ = ["RetryPolicy", "RecoveryContext", "RequestFailed"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/failover budget for one serving engine (per-request contexts
    are cheap and derived from this)."""

    max_retries: int = 2              # per-job retry attempts on the primary
    backoff_base: float = 0.0005      # sim-seconds slack margin, attempt 0
    backoff_factor: float = 2.0       # margin escalation per attempt
    backoff_cap: float = 0.01         # margin ceiling
    failover: bool = True             # spill to the pool when budget runs out

    def margin(self, attempt: int) -> float:
        """Required slack margin before retry ``attempt`` is allowed."""
        return min(self.backoff_cap,
                   self.backoff_base * (self.backoff_factor ** attempt))


class RequestFailed(RuntimeError):
    """Terminal, typed failure of one serving request.

    Carries everything the caller needs for a post-mortem: the request id,
    how many recovery attempts were burned, the fault classes seen, the
    partial receipts of work that WAS billed, and the final causal fault.
    """

    def __init__(self, msg: str, *, request_id: Optional[int] = None,
                 attempts: int = 0, faults: Optional[Dict[str, int]] = None,
                 receipts: Tuple = (), cause: Optional[BaseException] = None,
                 flight_log: Optional[Tuple] = None):
        super().__init__(msg)
        self.request_id = request_id
        self.attempts = attempts
        self.faults = dict(faults or {})
        self.receipts = tuple(receipts)
        self.cause = cause
        # Flight-recorder dump: the request's last-N trace records (spans +
        # events, oldest first), attached by the engine at resolve time when
        # tracing is enabled; () when it was disabled.
        self.flight_log = tuple(flight_log or ())


class RecoveryContext:
    """Per-request recovery state machine, consumed by the pipeline reduce.

    The pipeline calls ``decide(attempts)`` after each retryable fault:
    ``None`` means "retry on the same backend", a backend object means
    "resubmit there" (failover), and :class:`RequestFailed` means the
    request is out of options.  ``clock`` and ``deadline`` live on the
    PRIMARY backend's clock (the farm's simulated time).
    """

    retryable = (FarmFault,)

    def __init__(self, policy: RetryPolicy, *,
                 clock: Callable[[], float],
                 deadline: Optional[float] = None,
                 failover: object = None,
                 failover_name: Optional[str] = None,
                 on_failover: Optional[Callable[[], None]] = None,
                 est_job_seconds: float = 0.0,
                 request_id: Optional[int] = None,
                 obs=None):
        self.policy = policy
        self.clock = clock
        self.deadline = deadline
        self.failover = failover
        self.failover_name = failover_name
        self.on_failover = on_failover
        self.est_job_seconds = float(est_job_seconds)
        self.request_id = request_id
        self.obs = obs if obs is not None else Observability.disabled()
        self.retries = 0
        self.failed_over = 0
        self.faults: Dict[str, int] = {}
        self.receipts: list = []

    # -- bookkeeping ---------------------------------------------------

    def _event(self, name: str, **attrs) -> None:
        tracer = self.obs.tracer
        if tracer.enabled:
            tracer.event(name, trace_id=self.request_id,
                         parent=tracer.root_id(self.request_id),
                         track="recovery", sim_t=self.clock(), **attrs)

    def note_fault(self, exc: BaseException) -> None:
        kind = type(exc).__name__
        self.faults[kind] = self.faults.get(kind, 0) + 1
        receipt = getattr(exc, "receipt", None)
        if receipt is not None:
            self.receipts.append(receipt)
        self._event("recovery.fault", kind=kind,
                    job_id=getattr(exc, "job_id", None),
                    chip_id=getattr(exc, "chip_id", None))

    @property
    def faults_seen(self) -> int:
        return sum(self.faults.values())

    # -- the decision --------------------------------------------------

    def _budget_ok(self, attempt: int) -> bool:
        if self.deadline is None:
            return True
        remaining = self.deadline - self.clock()
        return remaining > self.policy.margin(attempt) + self.est_job_seconds

    def decide(self, attempts: int, cause: Optional[BaseException] = None,
               *, failed_over: bool = False):
        """Pick the next move after a retryable fault on one job.

        ``attempts`` is how many recovery attempts this JOB already burned
        (0 on its first fault); ``failed_over`` is whether the job already
        moved to the failover backend (a second fault there is terminal).
        Returns ``None`` (retry same backend) or a failover backend;
        raises :class:`RequestFailed` when out of options.
        """
        if (not failed_over and attempts < self.policy.max_retries
                and self._budget_ok(attempts)):
            self.retries += 1
            self._event("recovery.retry", attempt=attempts + 1)
            return None
        if self.policy.failover and self.failover is not None and not failed_over:
            self.failed_over += 1
            if self.on_failover is not None:
                self.on_failover()
            self._event("recovery.failover", backend=self.failover_name)
            return self.failover
        raise RequestFailed(
            f"request {self.request_id}: job out of recovery options after "
            f"{attempts} attempt(s) (faults: {self.faults}); no failover "
            f"backend available",
            request_id=self.request_id, attempts=attempts,
            faults=self.faults, receipts=tuple(self.receipts), cause=cause,
        )
