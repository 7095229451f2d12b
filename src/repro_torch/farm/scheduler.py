"""COBI chip-farm scheduler: packed, prioritized, batched Ising solving.

``CobiFarm`` simulates a farm of ``n_chips`` COBI chips, each with
``lanes_per_chip`` spin lanes.  Jobs (one ≤59-spin integer Ising instance
each) are submitted with a priority/deadline and return a :class:`FarmFuture`.
A drain flushes (part of) the queue:

  1. jobs are grouped by anneal schedule ``(steps, dt, ks_max, reduce)`` --
     packed instances share one trajectory, so the schedule must match --
     and, within a schedule group, into read-count tiers
     (:func:`repro_torch.farm.packing.replica_tiers`): jobs with similar read
     counts share a tier's replica schedule (per-slot read budgets mask the
     surplus), jobs with very different read counts anneal in separate tiers
     instead of all running the largest job's count;
  2. within a tier, jobs are sorted (priority desc, deadline asc, size desc,
     FIFO) and best-fit-decreasing packed into block-diagonal
     super-instances (:mod:`repro_torch.farm.packing`);
  3. the super-instance stack is padded to a batch bucket, moved to the
     farm's device once, and annealed by ONE batched CUDA launch, grid =
     (replica-block, instance).  ``reduce="best"`` jobs take the fused
     anneal→readout→best-of epilogue (`ops.cobi_anneal_packed_best`): spins
     are signed, scored against the ORIGINAL coefficients, and reduced to
     each slot's best read on the device, so only O(lanes) per
     super-instance comes back to the host.  ``reduce="none"`` jobs keep the
     legacy two-launch path (full phases, separate batched energy scoring)
     and return every read;
  4. futures resolve to :class:`repro_torch.solvers.base.SolverResult` plus a
     :class:`JobReceipt` carrying the paper's latency/energy accounting,
     the job's lane-share of its drain's h2d/d2h bytes (exact integer
     apportionment -- a launch group's receipts sum to the bytes it moved),
     the absolute sim-clock completion time, and the caller's opaque
     ``tag`` (e.g. the serving engine's request id).  A long-lived consumer
     calls ``future.release()`` after reducing to keep the completed-job
     buffers bounded without the batch-scoped ``clear_completed`` sweep.

``CobiFarm`` satisfies the :class:`repro_torch.solvers.base.SolverBackend`
protocol (structurally), so the pipeline's backend drivers
(``core.pipeline.iter_solve_es`` / ``drive_with_backend``) run through it.

Device: the farm runs on the card unless constructed with ``device="cpu"``
(the kernels' plain versions); without a card ``CobiFarm()`` raises.

Drain-policy state machine (``policy=`` at construction)::

                    submit()                    drain trigger
    job:  SUBMITTED ---------> QUEUED ------------------------> RUNNING -> DONE
                                  |                                ^
                                  | (job result/receipt stored,    |
                                  v  future._finish())        one batched
                               cleared by clear_completed()    CUDA launch

    policy="manual"   : the only trigger is a caller-side ``drain()``; a
                        ``result()`` on a QUEUED job raises
                        :class:`FarmPendingError` instead of blocking forever.
    policy="timer"    : a background drive loop drains EVERYTHING pending
                        every ``timer_interval`` wall seconds.
    policy="bin-full" : after every submission the drive loop re-estimates,
                        per (schedule, tier) group, how the group would
                        best-fit pack (:func:`repro_torch.farm.packing.
                        estimate_packing`).  Estimated bins at or above
                        ``bin_full_target`` lane occupancy launch in chunks
                        of ``bin_full_min_bins`` (default ``n_chips`` -- one
                        chip cycle; constant launch width = a stable
                        shape set) while a burst is arriving; once the queue
                        has been still for a short debounce, closed bins
                        launch regardless of count.  Partial bins keep
                        accumulating pack-mates until the ``linger``
                        quiescence fallback flushes everything pending.
    policy="deadline" : a (schedule, tier) group is drained as soon as any of
                        its jobs has ``deadline - sim_now - estimated group
                        latency <= deadline_watermark`` (latency estimate:
                        estimated BFD bin count, round-robin over chips,
                        ``tier_reads * seconds_per_solve`` per bin cycle --
                        conservative: the whole-group worst case).  Same
                        ``linger`` quiescence fallback as bin-full.

All non-manual policies run drains on ONE background daemon thread, and
every drain -- background or caller-side -- serializes on an execution
lock, so kernel launches never interleave; the state lock guarding shared
state (queue, results, receipts, chip stats, the simulated clock) is held
only to dequeue due jobs and to commit their results, NEVER across a
kernel launch, so submissions and result reads proceed while a drain's
anneal is still running (the overlap that makes background drains pay for
themselves on burst traffic).  ``FarmFuture`` is therefore thread-safe
(``result(timeout=)`` blocks on an event set by the draining thread) and
awaitable (``__await__`` bridges the done-callback onto the running asyncio
loop with ``call_soon_threadsafe``).  Bit-exactness across policies: each
job's initial phases are drawn from its OWN key at its OWN bucketed read
count and packed blocks do not interact, so *which* drain a job lands in
changes accounting (cycles, receipts, sim clock) but never its spins or
energies.

Hardware-time model: each super-instance occupies one chip for
``tier_reads * seconds_per_solve`` (sequential 200 us executions of the
programmed array).  Bins are assigned round-robin to chips; a drain advances
the simulated clock by the number of serialized cycles on the busiest chip.
Job energy is the chip energy of its bin, attributed by lane share.
Host↔device traffic of every launch is metered into ``FarmStats.bytes_h2d``
/ ``bytes_d2h`` (the benchmark's bytes-per-request figure).
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import math
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.formulation import IsingProblem
from repro_torch.core.hardware import COBI, SolverHardware
from repro_torch.farm.faults import (
    ChipFailure,
    CorruptReadout,
    DrainTimeout,
    FaultPlan,
    validate_readout,
)
from repro_torch.farm.health import BreakerConfig, FarmHealth
from repro_torch.farm.packing import (
    LANE,
    bucket_to,
    estimate_packing,
    pack_instances,
    replica_tiers,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.obs import NULL_SPAN, Observability
from repro_torch.solvers.base import CapacityHint, SolverResult
from repro_torch.solvers.cobi import COBI_MAX_SPINS, check_programmable

BATCH_BUCKET = 4  # super-instance batches are padded to a multiple of this
REPLICA_BUCKET = 8  # read counts are padded to a multiple of this
REPLICA_TIER_RATIO = 2.0  # max/min read ratio allowed to share a tier
REDUCE_MODES = ("none", "best")
DRAIN_POLICIES = ("manual", "bin-full", "deadline", "timer")


def _batch_pad(b_real: int) -> int:
    """Super-instance batch padding: powers of two below BATCH_BUCKET, then
    BATCH_BUCKET multiples.  Small drains (common under bin-full/deadline
    policies, which launch single closed bins) pay for the bins they have
    instead of a full bucket of zero-padded anneals; the launches still see
    a bounded shape set {1, 2, 4, 8, 12, ...}."""
    if b_real >= BATCH_BUCKET:
        return bucket_to(b_real, BATCH_BUCKET)
    pad = 1
    while pad < b_real:
        pad *= 2
    return pad


class FarmPendingError(RuntimeError):
    """``result()``/``receipt()``/``await`` on a job nothing will ever drain.

    Raised instead of blocking forever when the farm's drain policy is
    ``"manual"`` and the job is still queued: under manual policy only a
    caller-side ``drain()`` resolves futures.
    """


class FarmJobCancelled(RuntimeError):
    """The job was cancelled (``FarmFuture.cancel``) before it ran."""


@dataclasses.dataclass(frozen=True)
class FarmJob:
    job_id: int
    ising: IsingProblem
    key: torch.Tensor  # (2,) int64 key words
    reads: int
    steps: int
    dt: float
    ks_max: float
    priority: int
    deadline: Optional[float]
    submit_sim_time: float
    reduce: str = "none"
    # Opaque caller metadata (e.g. the serving engine's request id, stamped
    # by its admission layer) echoed on the job's receipt, so per-request
    # SLO accounting can group farm receipts without a side table.
    tag: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class JobReceipt:
    """Simulated-hardware accounting for one completed job."""

    job_id: int
    chip_id: int
    cycle: int  # global chip cycle the job's bin ran in
    lanes: int  # spin lanes the job occupied
    bin_occupancy: float  # lane utilization of its super-instance
    sim_latency_seconds: float  # submit -> bin completion on the sim clock
    chip_seconds: float  # chip busy time attributed to this job (lane share)
    energy_joules: float  # chip energy attributed to this job
    # Drain-level host<->device traffic attributed to this job by lane share
    # (exact integer split: a launch group's per-job bytes sum to the bytes
    # the group actually moved), so serving SLOs can bill transfer.
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    sim_completed: float = 0.0  # absolute sim-clock time the job's bin finished
    tag: Optional[int] = None  # caller metadata echoed from submit()
    # Fault/repair events that touched this job's readout ("repaired:<k>",
    # "stuck-lane", ...) -- empty for a clean drain.  Terminal failures carry
    # their receipt on the exception instead (``FarmFault.receipt``).
    faults: Tuple[str, ...] = ()


@dataclasses.dataclass
class ChipStats:
    chip_id: int
    solves: int = 0  # super-instance anneals executed
    busy_seconds: float = 0.0
    jobs: int = 0
    lanes_used: int = 0  # summed over executed super-instances
    lanes_capacity: int = 0

    @property
    def occupancy(self) -> float:
        return self.lanes_used / self.lanes_capacity if self.lanes_capacity else 0.0


@dataclasses.dataclass
class FarmStats:
    jobs_completed: int
    super_instances: int
    drains: int
    sim_seconds: float
    energy_joules: float
    chips: List[ChipStats]
    bytes_h2d: int = 0  # host->device traffic of every drain launch
    bytes_d2h: int = 0  # device->host result traffic
    # Injected/detected fault events by class (empty without a FaultPlan).
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    quarantined: Tuple[int, ...] = ()  # chips with an OPEN breaker right now

    @property
    def mean_occupancy(self) -> float:
        used = sum(c.lanes_used for c in self.chips)
        cap = sum(c.lanes_capacity for c in self.chips)
        return used / cap if cap else 0.0


def _wake_waiter(waiter: "asyncio.Future") -> None:
    if not waiter.done():
        waiter.set_result(None)


class FarmFuture:
    """Thread-safe, awaitable handle to a submitted job.

    ``result(timeout=)`` / ``receipt(timeout=)`` block until a drain (manual
    or background, depending on the farm's policy) completes the job;
    ``add_done_callback`` fires from the draining thread (callbacks must be
    quick and must not block -- ``loop.call_soon_threadsafe`` is the intended
    kind of payload); ``await future`` suspends the current asyncio task
    until the job completes, without tying up the event loop.
    """

    __slots__ = ("_farm", "job_id", "_event", "_callbacks")

    def __init__(self, farm: "CobiFarm", job_id: int):
        self._farm = farm
        self.job_id = job_id
        self._event = threading.Event()
        self._callbacks: List[Callable[["FarmFuture"], None]] = []

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SolverResult:
        self._wait(timeout)
        self._farm._raise_job_error(self.job_id)
        return self._farm._take(self.job_id, self._farm._results)

    def receipt(self, timeout: Optional[float] = None) -> JobReceipt:
        self._wait(timeout)
        self._farm._raise_job_error(self.job_id)
        return self._farm._take(self.job_id, self._farm._receipts)

    def cancel(self) -> bool:
        """Dequeue the job if it has not started; returns True on success.

        A cancelled future is done; ``result()``/``receipt()`` raise
        :class:`FarmJobCancelled`.  Jobs already running (or finished)
        are not interrupted and False is returned."""
        farm = self._farm
        with farm._lock:
            for i, job in enumerate(farm._pending):
                if job.job_id == self.job_id:
                    del farm._pending[i]
                    farm._jobs.pop(self.job_id, None)
                    farm._futures.pop(self.job_id, None)
                    farm._errors[self.job_id] = FarmJobCancelled(
                        f"farm job {self.job_id} was cancelled before running"
                    )
                    self._finish()
                    return True
        return False

    def add_done_callback(self, fn: Callable[["FarmFuture"], None]) -> None:
        """Run ``fn(self)`` once the job completes (immediately if it has)."""
        with self._farm._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def release(self) -> None:
        """Drop this job's stored result/receipt/error from the farm.

        The per-job form of ``clear_completed``: a long-lived consumer (the
        serving engine) releases each future right after reducing it, so
        sustained continuous load stays memory-bounded without nuking the
        buffers of unrelated in-flight requests.  Idempotent; after release
        the future stays ``done()`` but is no longer readable."""
        farm = self._farm
        with farm._lock:
            farm._results.pop(self.job_id, None)
            farm._receipts.pop(self.job_id, None)
            farm._errors.pop(self.job_id, None)
            farm._jobs.pop(self.job_id, None)

    def __await__(self):
        if not self._event.is_set():
            self._raise_if_never_drained()
            loop = asyncio.get_running_loop()
            waiter = loop.create_future()
            self.add_done_callback(
                lambda _fut: loop.call_soon_threadsafe(_wake_waiter, waiter)
            )
            yield from waiter.__await__()
        return self.result()

    # ------------------------------------------------------------ internals

    def _wait(self, timeout: Optional[float]) -> None:
        if self._event.is_set():
            return
        self._raise_if_never_drained()
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"farm job {self.job_id} did not complete within {timeout}s "
                f"(policy={self._farm.policy!r})"
            )

    def _raise_if_never_drained(self) -> None:
        farm = self._farm
        if farm.policy != "manual":
            return
        with farm._lock:
            if self._event.is_set():
                return
            if any(j.job_id == self.job_id for j in farm._pending):
                raise FarmPendingError(
                    f"farm job {self.job_id} is still queued and the farm's "
                    f"drain policy is 'manual': no background loop will run "
                    f"it -- call farm.drain(), or construct the farm with "
                    f"policy='bin-full', 'deadline', or 'timer'"
                )

    def _finish(self) -> None:
        """Mark done + fire callbacks; called by the farm with its lock held,
        after the job's result AND receipt (or error) are stored.  Callback
        exceptions are reported and swallowed -- one broken callback must
        not leave sibling futures of the same drain unresolved or kill the
        background drive thread."""
        self._event.set()
        callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 -- deliberate isolation
                traceback.print_exc()


class CobiFarm:
    """A virtual multi-chip COBI farm (see module docstring)."""

    def __init__(
        self,
        n_chips: int = 4,
        *,
        lanes_per_chip: int = LANE,
        max_spins: int = COBI_MAX_SPINS,
        device=None,
        hardware: SolverHardware = COBI,
        check: bool = True,
        policy: str = "manual",
        timer_interval: float = 0.02,
        linger: float = 0.02,
        bin_full_target: float = 0.9,
        bin_full_min_bins: Optional[int] = None,
        deadline_watermark: float = 0.0,
        faults: Optional[FaultPlan] = None,
        health: object = None,
        validate: Optional[bool] = None,
        obs=None,
    ):
        if n_chips < 1:
            raise ValueError(f"need >= 1 chip, got {n_chips}")
        if lanes_per_chip % LANE != 0:
            raise ValueError(f"lanes_per_chip must be a multiple of {LANE}")
        if policy not in DRAIN_POLICIES:
            raise ValueError(f"policy must be one of {DRAIN_POLICIES}, got {policy!r}")
        if timer_interval <= 0 or linger <= 0:
            raise ValueError("timer_interval and linger must be positive")
        if not 0.0 < bin_full_target <= 1.0:
            raise ValueError(f"bin_full_target must be in (0, 1], got {bin_full_target}")
        self.device = resolve_device(device)
        self.n_chips = n_chips
        self.lanes_per_chip = lanes_per_chip
        self.max_spins = max_spins
        self.hardware = hardware
        self.check = check
        self.policy = policy
        self.timer_interval = timer_interval
        self.linger = linger
        self.bin_full_target = bin_full_target
        # Launch closed bins only once a full chip cycle's worth are ready:
        # n_chips bins anneal in parallel on the simulated hardware, and
        # same-sized launches amortize per-launch dispatch.  Stragglers ride
        # the linger flush.
        self.bin_full_min_bins = (
            n_chips if bin_full_min_bins is None else max(1, bin_full_min_bins)
        )
        self.deadline_watermark = deadline_watermark
        # Fault tolerance: a seeded FaultPlan injects faults at the drain
        # boundary (kernels untouched); host-side readout validation is on
        # whenever faults can occur (override with validate=); a breaker
        # bank quarantines sick chips and steers placement around them.
        self.faults = faults
        self._validate = (faults is not None) if validate is None else bool(validate)
        if isinstance(health, FarmHealth):
            self.health: Optional[FarmHealth] = health
        elif isinstance(health, BreakerConfig):
            self.health = FarmHealth(n_chips, health)
        elif health or faults is not None:
            self.health = FarmHealth(n_chips)
        else:
            self.health = None
        # Observability: spans from receipts + registry-backed counters.
        # A standalone farm gets a private disabled bundle; the serving
        # engine rebinds its shared one via attach_obs().
        self.obs = None
        self.attach_obs(obs if obs is not None else Observability.disabled())
        self._ids = itertools.count()
        self._pending: List[FarmJob] = []
        self._jobs: Dict[int, FarmJob] = {}
        self._futures: Dict[int, FarmFuture] = {}
        self._results: Dict[int, SolverResult] = {}
        self._receipts: Dict[int, JobReceipt] = {}
        self._errors: Dict[int, BaseException] = {}
        self._sim_time = 0.0
        self._cycle = 0  # global chip-cycle counter
        # Wall-clock (t0, t1) of recent drain executions: the overlap
        # denominator's counterpart -- an encoder stage intersects these
        # with its own launch intervals to measure encode-vs-anneal
        # concurrency (same time.monotonic domain).
        self._busy_intervals: deque = deque(maxlen=4096)
        self._chips = [ChipStats(chip_id=c) for c in range(n_chips)]
        self._lock = threading.RLock()
        self._exec_lock = threading.Lock()  # serializes kernel execution
        self._wakeup = threading.Condition(self._lock)
        self._driver: Optional[threading.Thread] = None
        self._closed = False
        self._last_submit = time.monotonic()
        self._last_drain = time.monotonic()
        self._lanes_since_wake = 0
        self._flush_requested = False
        # Background evaluation cadence: half the relevant trigger horizon.
        horizon = timer_interval if policy == "timer" else linger
        self._tick = max(1e-3, horizon / 2.0)
        self._debounce = min(5e-3, linger / 2.0)

    def attach_obs(self, obs) -> None:
        """Bind an :class:`repro_torch.obs.Observability` bundle.

        Receipt-driven spans go to its tracer; the farm's cumulative
        meters (jobs completed, drains, h2d/d2h bytes, fault counts) live
        as counters in its metrics registry, and :meth:`stats` is a view
        over those series.  A standalone farm binds a private disabled
        bundle at construction; the serving engine rebinds its shared one
        (before traffic -- cumulative counts carry over regardless).
        """
        carry_faults: Dict[str, float] = {}
        carry = {"jobs": 0.0, "drains": 0.0, "h2d": 0.0, "d2h": 0.0}
        if self.obs is not None:
            carry = {"jobs": self._m_jobs.value,
                     "drains": self._m_drains.value,
                     "h2d": self._m_h2d.value, "d2h": self._m_d2h.value}
            carry_faults = {k: c.value for (k,), c in self._m_faults.children()}
        self.obs = obs
        reg = obs.registry
        self._m_jobs = reg.counter(
            "farm_jobs_total", "jobs completed by the chip farm")
        self._m_drains = reg.counter(
            "farm_drains_total", "drain executions")
        bytes_fam = reg.counter(
            "farm_bytes_total", "host<->device traffic of drain launches",
            labels=("direction",))
        self._m_h2d = bytes_fam.labels(direction="h2d")
        self._m_d2h = bytes_fam.labels(direction="d2h")
        self._m_faults = reg.counter(
            "farm_faults_total", "injected/detected fault events by class",
            labels=("kind",))
        self._m_job_latency = reg.histogram(
            "farm_job_sim_latency_seconds",
            "submit -> bin completion per job on the sim clock",
            labels=("policy",)).labels(policy=self.policy)
        self._m_job_energy = reg.histogram(
            "farm_job_energy_joules", "chip energy attributed per job")
        self._m_job_chip_seconds = reg.histogram(
            "farm_job_chip_seconds", "chip busy time attributed per job")
        self._m_jobs.inc(carry["jobs"])
        self._m_drains.inc(carry["drains"])
        self._m_h2d.inc(carry["h2d"])
        self._m_d2h.inc(carry["d2h"])
        for kind, v in carry_faults.items():
            self._m_faults.labels(kind=kind).inc(v)
        if self.health is not None:
            self.health.attach_obs(obs)

    # ------------------------------------------------------------------ API

    def submit(
        self,
        ising: IsingProblem,
        key: torch.Tensor,
        *,
        reads: int = 8,
        steps: int = 400,
        dt: float = 0.35,
        ks_max: float = 1.2,
        priority: int = 0,
        deadline: Optional[float] = None,
        check: Optional[bool] = None,
        reduce: str = "none",
        tag: Optional[int] = None,
    ) -> FarmFuture:
        """Queue one anneal job; rejects instances the chip cannot hold.

        ``reduce="best"`` resolves the future to only the job's best read
        (SolverResult with (1, N) spins / (1,) energy) through the fused
        on-device epilogue; ``"none"`` returns every read.  Under non-manual
        drain policies the background drive loop is nudged after every
        submission, so triggers (a bin estimated full, a deadline inside its
        watermark) fire without any caller involvement.  The instance is
        copied to the host once here: packing, re-scoring and validation
        read it there.
        """
        if ising.n > self.max_spins:
            raise ValueError(
                f"COBI farm chips hold <= {self.max_spins} spins, got {ising.n}; "
                "decompose first (core.decomposition)"
            )
        if reduce not in REDUCE_MODES:
            raise ValueError(f"reduce must be one of {REDUCE_MODES}, got {reduce!r}")
        ising = IsingProblem(h=ising.h.detach().to("cpu", torch.float32),
                             j=ising.j.detach().to("cpu", torch.float32))
        do_check = self.check if check is None else check
        if do_check:
            check_programmable(ising, max_spins=self.max_spins)
        with self._wakeup:
            if self._closed:
                raise RuntimeError("farm is closed")
            job = FarmJob(
                job_id=next(self._ids),
                ising=ising,
                key=key,
                reads=int(reads),
                steps=int(steps),
                dt=float(dt),
                ks_max=float(ks_max),
                priority=int(priority),
                deadline=deadline,
                submit_sim_time=self._sim_time,
                reduce=reduce,
                tag=tag,
            )
            self._pending.append(job)
            self._jobs[job.job_id] = job
            future = FarmFuture(self, job.job_id)
            self._futures[job.job_id] = future
            self._last_submit = time.monotonic()
            if self.policy != "manual":
                if self._driver is None:
                    self._driver = threading.Thread(
                        target=self._drive_loop,
                        name="cobi-farm-drive",
                        daemon=True,
                    )
                    self._driver.start()
                # Wake the drive loop only when this submission could have
                # changed a trigger: a bin-full estimate cannot close a NEW
                # bin until ~a chip's worth of fresh lanes arrived, and a
                # deadline trigger only moves on deadline-carrying jobs.
                # Waking (and re-estimating) on every submission measurably
                # slows the submitting thread on small hosts; the periodic
                # tick covers everything else.
                self._lanes_since_wake += ising.n
                wake = (
                    self._lanes_since_wake
                    >= self.bin_full_target * self.lanes_per_chip
                )
                if self.policy == "deadline":
                    wake = wake or deadline is not None
                elif self.policy == "timer":
                    wake = False  # pure tick cadence
                if wake:
                    self._lanes_since_wake = 0
                    self._wakeup.notify_all()
        return future

    def drain(self) -> int:
        """Pack and execute every pending job; returns the number completed.

        Always available -- under non-manual policies this is a manual flush
        on top of whatever the background loop is doing (the execution lock
        keeps the two from interleaving kernel launches).
        """
        with self._exec_lock:
            with self._lock:
                if not self._pending:
                    return 0
                pending, self._pending = self._pending, []
            return self._execute(pending)

    def flush_hint(self) -> None:
        """Signal that no more traffic is imminent (end of a burst).

        Non-blocking and advisory: the background drive loop treats the
        queue as already quiescent and flushes pending work on its next
        wakeup (notified immediately) instead of waiting out ``linger``.
        The producer-side flush of serving systems (Kafka's
        ``producer.flush``, TCP's PSH): a batch driver that KNOWS its round
        of submissions is complete conveys exactly the information the
        quiescence timer would otherwise have to infer -- but unlike a
        manual ``drain()`` the caller never blocks and never executes
        kernels.  No-op under ``policy="manual"`` or with nothing pending.
        """
        with self._wakeup:
            if self.policy == "manual" or not self._pending:
                return
            # Flag, not just a notify: if the drive loop is mid-evaluation
            # (not waiting) the notification would be lost and the flush
            # would slip a full tick.
            self._flush_requested = True
            self._wakeup.notify_all()

    def close(self, *, drain: bool = True) -> None:
        """Stop the background drive loop (if any); optionally flush first.

        Safe to call multiple times.  After closing, ``submit`` raises.
        No future is ever stranded by a close: if the final drain raises,
        the affected futures already carry the original error (``_execute``
        fails them before re-raising), and any job still queued afterwards
        -- including every queued job under ``drain=False`` -- is failed
        with :class:`FarmPendingError` so ``result()`` callers get a typed
        error instead of blocking forever."""
        with self._wakeup:
            self._closed = True
            driver, self._driver = self._driver, None
            self._wakeup.notify_all()
        if driver is not None:
            driver.join(timeout=60.0)
        try:
            if drain:
                self.drain()
        finally:
            with self._lock:
                leftover, self._pending = self._pending, []
                for job in leftover:
                    self._errors[job.job_id] = FarmPendingError(
                        f"farm closed with job {job.job_id} still queued "
                        f"(close(drain={drain})); nothing will ever run it"
                    )
                    future = self._futures.pop(job.job_id, None)
                    if future is not None:
                        future._finish()

    def __enter__(self) -> "CobiFarm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def prewarm(
        self,
        *,
        reads: Sequence[int] = (8,),
        steps: int = 400,
        dt: float = 0.35,
        ks_max: float = 1.2,
        max_bins: Optional[int] = None,
        max_slots: Optional[int] = None,
        reduce: str = "best",
    ) -> int:
        """Build the kernel libraries and launch each reachable drain shape
        once.

        Background drain policies launch timing-dependent SUBSETS of the
        queue, so the batched kernels see a traffic-dependent set of
        (batch-pad, slot-pad, replica-tier) shapes.  On the card the first
        use of a kernel builds its library (``nvcc``, seconds), and the
        first launch of a shape sets its shared-memory attribute and fills
        the caching allocator; this sweep does all of that at startup: one
        launch per lattice point (zero coefficients -- shapes are all that
        matter).  Returns the number of launches.  Size the lattice from
        expected traffic: ``max_bins`` ~ peak pending lanes /
        ``lanes_per_chip``, ``max_slots`` ~ the most jobs that share one
        bin.
        """
        L = self.lanes_per_chip
        max_bins = 2 * self.n_chips if max_bins is None else max_bins
        max_slots = 2 * ops.SLOT_PAD if max_slots is None else max_slots
        b_pads = sorted({_batch_pad(b) for b in range(1, max_bins + 1)})
        s_pads = sorted({
            bucket_to(s, ops.SLOT_PAD)
            for s in range(1, max_slots + 1)
        })
        r_tiers = sorted({bucket_to(max(int(r), 1), REPLICA_BUCKET)
                          for r in reads})
        dev = self.device
        launches = 0
        for r in r_tiers:
            k_pad = REPLICA_BUCKET
            while True:  # power-of-two key-count lattice of _run_group
                _phi0_from_keys(torch.stack([prng.key(0)] * k_pad), r=r,
                                lanes=L, device=dev)
                launches += 1
                if k_pad >= b_pads[-1] * s_pads[-1]:
                    break
                k_pad *= 2
            for b in b_pads:
                jp = torch.zeros((b, L, L), dtype=torch.float32, device=dev)
                hp = torch.zeros((b, L), dtype=torch.float32, device=dev)
                phi0 = torch.zeros((b, r, L), dtype=torch.float32, device=dev)
                if reduce == "best":
                    for s in s_pads:
                        mask = torch.zeros((b, L, s), dtype=torch.float32, device=dev)
                        budgets = torch.ones((b, s), dtype=torch.float32, device=dev)
                        ops.cobi_anneal_packed_best(
                            jp, hp, jp, hp, mask, budgets, phi0,
                            steps=steps, dt=dt, ks_max=ks_max,
                        )
                        launches += 1
                else:
                    ops.cobi_trajectory_batch(
                        jp, hp, phi0, steps=steps, dt=dt, ks_max=ks_max,
                    )
                    launches += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return launches

    def clear_completed(self) -> None:
        """Drop results/receipts of completed jobs (chip stats are kept).

        Futures of cleared jobs can no longer be read; callers that own a
        long-lived farm (the serving engine) call this once per batch after
        consuming every future, so sustained load stays memory-bounded.
        """
        with self._lock:
            self._results.clear()
            self._receipts.clear()
            self._errors.clear()
            pending_ids = {j.job_id for j in self._pending}
            self._jobs = {
                jid: j for jid, j in self._jobs.items() if jid in pending_ids
            }

    def sim_now(self) -> float:
        """Current simulated-hardware clock (advanced by drains)."""
        with self._lock:
            return self._sim_time

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Wall-clock (start, end) of recent drain executions
        (``time.monotonic`` domain) -- intersect with an encoder stage's
        intervals to measure encode-vs-anneal pipeline overlap."""
        with self._lock:
            return list(self._busy_intervals)

    def stats(self) -> FarmStats:
        """Registry view: cumulative meters are read back from the shared
        metrics registry (see :meth:`attach_obs`), so this dataclass can
        never drift from what the registry exports."""
        with self._lock:
            quarantined: Tuple[int, ...] = ()
            if self.health is not None:
                quarantined = tuple(self.health.quarantined(self._sim_time))
            fault_counts = {k: int(c.value)
                            for (k,), c in self._m_faults.children()
                            if c.value}
            return FarmStats(
                jobs_completed=int(self._m_jobs.value),
                super_instances=sum(c.solves for c in self._chips),
                drains=int(self._m_drains.value),
                sim_seconds=self._sim_time,
                energy_joules=sum(c.busy_seconds for c in self._chips)
                * self.hardware.solver_power_w,
                chips=list(self._chips),
                bytes_h2d=int(self._m_h2d.value),
                bytes_d2h=int(self._m_d2h.value),
                fault_counts=fault_counts,
                quarantined=quarantined,
            )

    def available_chips(self) -> int:
        """Chips currently taking traffic (breaker-aware; n_chips without
        health tracking).  Admission's completion estimator consults this
        so a quarantined chip shrinks BOTH the router's capacity hint and
        the inflight-ledger view of the same backend."""
        with self._lock:
            if self.health is None:
                return self.n_chips
            return self.health.available_chips(self._sim_time)

    def fault_rate(self) -> float:
        """Observed per-job fault probability: the mean of the breaker
        bank's per-chip fault EWMAs (0.0 without health tracking).  The
        router folds this into the farm's cost model as an expected-retry
        latency multiplier, so a farm that is fast-but-flaky loses routing
        decisions to a clean backend on EFFECTIVE latency."""
        with self._lock:
            if self.health is None or not self.health.breakers:
                return 0.0
            bank = self.health.breakers
            return float(sum(b.ewma for b in bank) / len(bank))

    def pending_jobs(self) -> int:
        with self._lock:
            return len(self._pending)

    def capacity_hint(self) -> CapacityHint:
        """Predicted sim-seconds to clear the CURRENT queue (for routing).

        Same estimate the deadline drain policy uses: group pending jobs by
        anneal schedule, tier by read count, best-fit estimate the packing,
        then charge ``ceil(bins / n_chips)`` chip cycles of
        ``tier_reads * seconds_per_solve`` per (schedule, tier) group --
        conservative (groups are charged sequentially, as drains run them).
        Quarantined chips are excluded: an open breaker shrinks the hint,
        steering the router away from a sick farm.
        """
        with self._lock:
            pending = list(self._pending)
            avail = (self.health.available_chips(self._sim_time)
                     if self.health is not None else self.n_chips)
        total = 0.0
        groups: Dict[Tuple[int, float, float, str], List[FarmJob]] = {}
        for job in pending:
            gkey = (job.steps, job.dt, job.ks_max, job.reduce)
            groups.setdefault(gkey, []).append(job)
        for jobs in groups.values():
            tiers = replica_tiers(
                [j.reads for j in jobs],
                bucket=REPLICA_BUCKET, ratio=REPLICA_TIER_RATIO,
            )
            for tier_reads, idxs in tiers:
                est = estimate_packing(
                    [jobs[i].ising.n for i in idxs], self.lanes_per_chip
                )
                total += (
                    math.ceil(est.n_bins / avail)
                    * tier_reads
                    * self.hardware.seconds_per_solve
                )
        return CapacityHint(
            pending_jobs=len(pending),
            est_queue_seconds=total,
            parallelism=avail,
            kind="sim",
        )

    # ------------------------------------------------------------ internals

    def _raise_job_error(self, job_id: int) -> None:
        with self._lock:
            exc = self._errors.get(job_id)
        if exc is not None:
            raise exc

    def _take(self, job_id: int, table: Dict[int, object]):
        with self._lock:
            try:
                return table[job_id]
            except KeyError:
                raise KeyError(
                    f"farm job {job_id} was cleared (clear_completed); its "
                    f"future is no longer readable"
                ) from None

    def _drive_loop(self) -> None:
        """Background drain driver (daemon thread, non-manual policies).

        Woken by every submission and at least every ``_tick`` seconds;
        evaluates the policy trigger under the state lock, then executes due
        drains under the execution lock only -- submitters never wait on a
        running kernel.
        """
        while True:
            with self._wakeup:
                if self._closed:
                    return
                self._wakeup.wait(self._tick)
                if self._closed:
                    return
            with self._exec_lock:
                with self._lock:
                    due = self._due_locked(time.monotonic())
                if due:
                    try:
                        self._execute(due)
                    except Exception:  # noqa: BLE001
                        # The affected futures were already failed by
                        # _execute; the drive loop itself must outlive any
                        # single bad drain or every later job wedges silently.
                        traceback.print_exc()
                    except BaseException:
                        # A non-Exception (KeyboardInterrupt/SystemExit in a
                        # hook, MemoryError) kills this thread; _execute
                        # already failed the drained jobs' futures.  Clear
                        # the driver slot so a later submit restarts the
                        # loop instead of queuing into a dead farm.
                        with self._lock:
                            if self._driver is threading.current_thread():
                                self._driver = None
                        raise

    def _due_locked(self, now: float) -> List[FarmJob]:
        """Select (and dequeue) the jobs the drain policy says are due."""
        if not self._pending:
            self._flush_requested = False
            return []
        if self._flush_requested:
            self._flush_requested = False
            due, self._pending = self._pending, []
            return due
        if self.policy == "timer":
            if now - self._last_drain >= self.timer_interval:
                due, self._pending = self._pending, []
                return due
            return []
        # bin-full / deadline: quiescence fallback -- nothing new arrived for
        # `linger` seconds, so waiting longer cannot improve packing.
        since_submit = now - self._last_submit
        if since_submit >= self.linger:
            due, self._pending = self._pending, []
            return due
        due_ids: set = set()
        groups: Dict[Tuple[int, float, float, str], List[FarmJob]] = {}
        for job in self._pending:
            gkey = (job.steps, job.dt, job.ks_max, job.reduce)
            groups.setdefault(gkey, []).append(job)
        for gkey, jobs in groups.items():
            tiers = replica_tiers(
                [j.reads for j in jobs],
                bucket=REPLICA_BUCKET, ratio=REPLICA_TIER_RATIO,
            )
            for tier_reads, idxs in tiers:
                tier_jobs = [jobs[i] for i in idxs]
                est = estimate_packing(
                    [j.ising.n for j in tier_jobs], self.lanes_per_chip
                )
                if self.policy == "bin-full":
                    # While a burst is still arriving (queue not yet still
                    # for `_debounce`), launch only FULL chip cycles of
                    # closed bins -- constant launch width keeps background
                    # drains on one launch shape instead of a new (batch,
                    # slot) pad combination per timing-dependent queue
                    # snapshot.  Once the queue goes briefly still,
                    # whatever is closed launches (low traffic must not wait
                    # out the full linger); partial bins always do.
                    closed = est.closed_bins(self.bin_full_target)
                    if closed and (len(closed) >= self.bin_full_min_bins
                                   or since_submit >= self._debounce):
                        for b in closed[: self.bin_full_min_bins]:
                            due_ids.update(
                                tier_jobs[i].job_id for i in est.bins[b]
                            )
                else:  # deadline
                    bin_seconds = tier_reads * self.hardware.seconds_per_solve
                    avail = (self.health.available_chips(self._sim_time)
                             if self.health is not None else self.n_chips)
                    latency = math.ceil(est.n_bins / avail) * bin_seconds
                    urgent = any(
                        j.deadline is not None
                        and j.deadline - self._sim_time - latency
                        <= self.deadline_watermark
                        for j in tier_jobs
                    )
                    if urgent:
                        # The whole tier rides along: binmates cost nothing
                        # extra (the urgent job's bin runs regardless).
                        due_ids.update(j.job_id for j in tier_jobs)
        if not due_ids:
            return []
        due = [j for j in self._pending if j.job_id in due_ids]
        self._pending = [j for j in self._pending if j.job_id not in due_ids]
        return due

    def _execute(self, pending: List[FarmJob]) -> int:
        """Group, pack and execute ``pending``; caller holds the EXECUTION
        lock (not the state lock -- launches run concurrently with
        submissions, and each group commits its results under the state
        lock as it finishes)."""
        with self._lock:
            # Counted up front: a future resolving (per-group commit) must
            # never be observable before the drain that produced it.
            self._m_drains.inc()
            self._last_drain = time.monotonic()
        groups: Dict[Tuple[int, float, float, str], List[FarmJob]] = {}
        for job in pending:
            gkey = (job.steps, job.dt, job.ks_max, job.reduce)
            groups.setdefault(gkey, []).append(job)
        first_exc: Optional[BaseException] = None
        t_exec0 = time.monotonic()
        for gkey in sorted(groups):
            jobs = groups[gkey]
            tiers = replica_tiers(
                [j.reads for j in jobs],
                bucket=REPLICA_BUCKET, ratio=REPLICA_TIER_RATIO,
            )
            for tier_reads, idxs in tiers:
                tier_jobs = [jobs[i] for i in idxs]
                gspan = self.obs.tracer.span(
                    "farm.group", track="farm", sim_t0=self.sim_now(),
                    jobs=len(tier_jobs), reads=tier_reads, steps=gkey[0],
                    reduce=gkey[3])
                try:
                    self._run_group(tier_reads, gkey, tier_jobs, span=gspan)
                except BaseException as exc:  # noqa: BLE001 -- never strand futures
                    # Fail THIS group's futures (waiters see the original
                    # error instead of hanging forever).  Plain Exceptions
                    # let the remaining groups execute and are re-raised at
                    # the end (a manual drain's caller still sees the
                    # first); a non-Exception (KeyboardInterrupt, ...) also
                    # fails every not-yet-run group and propagates
                    # immediately -- a dying drain must not leave ANY of its
                    # dequeued jobs' result() callers hanging.
                    gspan.set(outcome="error", error=type(exc).__name__)
                    self._fail_jobs(tier_jobs, exc)
                    if not isinstance(exc, Exception):
                        done = {j.job_id for j in tier_jobs}
                        self._fail_jobs(
                            [j for j in pending
                             if j.job_id not in done and not self._is_done(j.job_id)],
                            exc,
                        )
                        raise
                    if first_exc is None:
                        first_exc = exc
                finally:
                    gspan.end(sim_t1=self.sim_now())
        with self._lock:
            self._busy_intervals.append((t_exec0, time.monotonic()))
        if first_exc is not None:
            raise first_exc
        return len(pending)

    def _is_done(self, job_id: int) -> bool:
        with self._lock:
            return (job_id in self._results or job_id in self._errors
                    or job_id not in self._futures)

    def _fail_jobs(self, jobs: Sequence[FarmJob], exc: BaseException) -> None:
        """Store ``exc`` as every job's error and resolve its future."""
        with self._lock:
            for job in jobs:
                self._errors[job.job_id] = exc
                future = self._futures.pop(job.job_id, None)
                if future is not None:
                    future._finish()

    def _run_group(
        self, r_tier: int, gkey: Tuple[int, float, float, str],
        jobs: List[FarmJob], span=NULL_SPAN,
    ):
        steps, dt, ks_max, reduce = gkey
        with span.child("farm.pack") as p_pack:
            # Priority/deadline first (urgent jobs reach the earliest chip
            # cycles), then size-decreasing: best-fit-decreasing within a
            # priority class packs the lanes measurably denser.
            order = sorted(
                jobs,
                key=lambda j: (-j.priority, j.deadline if j.deadline is not None
                               else math.inf, -j.ising.n, j.job_id),
            )
            bins = pack_instances([(j.job_id, j.ising) for j in order],
                                  capacity=self.lanes_per_chip)
            by_id = {j.job_id: j for j in jobs}

            b_real = len(bins)
            b_pad = _batch_pad(b_real)
            L = self.lanes_per_chip
            slots = [(b, si, slot) for b, inst in enumerate(bins)
                     for si, slot in enumerate(inst.slots)]
            hp = np.zeros((b_pad, L), np.float32)
            jp = np.zeros((b_pad, L, L), np.float32)
            # The phases are drawn on the farm's device and assembled there.
            phi0 = torch.zeros((b_pad, r_tier, L), dtype=torch.float32,
                               device=self.device)
            for b, inst in enumerate(bins):
                hp[b] = inst.h_scaled
                jp[b] = inst.j_scaled
            # Per-job phases from the job's own key -- results are
            # reproducible regardless of binmates, tier, or WHICH drain the
            # job landed in (manual vs any background policy): each job
            # draws at its OWN bucketed read count (rows past it are inert:
            # zero-phase anneals excluded by the read budget / slicing).
            # One draw per distinct bucket (key count bucketed to keep the
            # draw shapes few).
            by_rj: Dict[int, List[int]] = {}
            for idx, (b, si, slot) in enumerate(slots):
                rj = bucket_to(max(by_id[slot.job_id].reads, 1), REPLICA_BUCKET)
                by_rj.setdefault(rj, []).append(idx)
            for rj, idxs in sorted(by_rj.items()):
                keys = [by_id[slots[i][2].job_id].key for i in idxs]
                # Power-of-two key-count bucket: each row's draw depends
                # only on its own key, so padding is inert, and background
                # drains (whose job counts are timing-dependent) stay
                # within a handful of draw shapes instead of one per
                # distinct count.
                k_pad = REPLICA_BUCKET
                while k_pad < len(keys):
                    k_pad *= 2
                keys += [prng.key(0)] * (k_pad - len(keys))
                draws = _phi0_from_keys(torch.stack(keys), r=rj, lanes=L,
                                        device=self.device)
                for pos, i in enumerate(idxs):
                    b, _, slot = slots[i]
                    phi0[b, :rj, slot.offset : slot.offset + slot.n] = (
                        draws[pos, :, : slot.n]
                    )
            p_pack.set(bins=b_real, slots=len(slots), batch_pad=b_pad)

        # Placement is snapshotted BEFORE the launch (breaker states only
        # move at commit time, and drains serialize on the execution lock,
        # so the snapshot stays valid): healthy chips take the drain's head
        # round-robin, half-open chips get one probe bin each from the
        # tail, open chips get nothing.
        with span.child("farm.place") as p_place:
            with self._lock:
                cycle0 = self._cycle
                if self.health is not None:
                    chip_of = self.health.schedule(b_real, self._sim_time)
                else:
                    chip_of = [b % self.n_chips for b in range(b_real)]
            bin_cycle, _ = _chip_cycles(chip_of)
            p_place.set(chips=list(chip_of), cycle0=cycle0)

        plan = self.faults
        if plan is not None and plan.drain_timeout(sorted(by_id)):
            # The whole drain "hung": chips ran and time passed, but every
            # readout was lost.  Bill the hardware, fail every future with
            # a typed DrainTimeout (retryable -- a resubmit draws fresh job
            # ids), and skip the actual kernel launch.  No breaker events:
            # a hung drain is an infrastructure fault, not attributable to
            # any one chip.
            exc = DrainTimeout(
                f"injected drain timeout: {len(slots)} job(s) in "
                f"{b_real} bin(s) lost their readout"
            )
            with self._lock:
                self._bill_chips(bins, chip_of, bin_cycle, r_tier)
                self._count_fault("drain_timeout", len(slots))
            span.set(outcome="drain_timeout")
            self._fail_jobs(jobs, exc)
            return

        with span.child("farm.launch") as p_launch:
            if reduce == "best":
                results, h2d, d2h = self._execute_fused(
                    bins, slots, by_id, hp, jp, phi0,
                    steps=steps, dt=dt, ks_max=ks_max)
            else:
                results, h2d, d2h = self._execute_full(
                    bins, slots, by_id, hp, jp, phi0,
                    steps=steps, dt=dt, ks_max=ks_max)
            p_launch.set(bytes_h2d=h2d, bytes_d2h=d2h)

        # Fault injection + host-side validation, still outside the state
        # lock (pure numpy on this group's local results).
        with span.child("farm.readout") as p_readout:
            faults_by_job: Dict[int, Tuple[str, ...]] = {}
            failed: Dict[int, BaseException] = {}
            chip_outcome: Dict[int, str] = {}
            if plan is not None:
                self._inject_faults(plan, bins, slots, by_id, chip_of,
                                    bin_cycle, cycle0, results, faults_by_job,
                                    failed, chip_outcome)
            if self._validate:
                self._validate_results(bins, slots, by_id, chip_of, results,
                                       faults_by_job, failed, chip_outcome)
            p_readout.set(faulted=len(faults_by_job), failed=len(failed))

        with self._lock:
            self._m_h2d.inc(h2d)
            self._m_d2h.inc(d2h)
            ok = {jid: r for jid, r in results.items() if jid not in failed}
            self._results.update(ok)
            self._m_jobs.inc(len(ok))
            self._account(bins, slots, by_id, r_tier, h2d, d2h,
                          chip_of=chip_of, faults=faults_by_job)
            for jid, exc in failed.items():
                # The chip time WAS spent: the receipt rides the exception
                # (partial accounting for the recovery layer) instead of
                # the receipts table.
                exc.receipt = self._receipts.pop(jid, None)
                self._errors[jid] = exc
                self.obs.tracer.event(
                    "farm.job.failed", trace_id=by_id[jid].tag,
                    track=f"chip{getattr(exc, 'chip_id', None)}",
                    sim_t=self._sim_time, job_id=jid,
                    kind=type(exc).__name__)
            for kind, jids in _group_fault_kinds(faults_by_job, failed).items():
                self._count_fault(kind, len(jids))
            if self.health is not None:
                for chip, outcome in sorted(chip_outcome.items()):
                    self.health.record(chip, outcome, self._sim_time)
            # Results AND receipts (or errors) are stored: resolve the
            # futures (fires done-callbacks from this -- possibly
            # background -- thread).
            for _, _, slot in slots:
                future = self._futures.pop(slot.job_id, None)
                if future is not None:
                    future._finish()

    def _count_fault(self, kind: str, n: int = 1) -> None:
        if n:
            self._m_faults.labels(kind=kind).inc(n)

    def _inject_faults(self, plan, bins, slots, by_id, chip_of, bin_cycle,
                       cycle0, results, faults_by_job, failed, chip_outcome):
        """Apply chip failures, stuck lanes and readout corruption to the
        group's local ``results`` (copies only; kernel outputs committed for
        other jobs are never touched)."""
        # Chip failures: every slot of a bin on a failed chip loses its
        # readout.  Keyed on (chip, global cycle), so transients are
        # replayable and a retry on the same chip in a later cycle draws
        # fresh.
        failed_bins = set()
        for b in range(len(bins)):
            chip = chip_of[b]
            if plan.chip_failed(chip, cycle0 + bin_cycle[b]):
                failed_bins.add(b)
                chip_outcome[chip] = "failed"
            else:
                chip_outcome.setdefault(chip, "ok")
        for b, _, slot in slots:
            if b in failed_bins:
                results.pop(slot.job_id, None)
                failed[slot.job_id] = ChipFailure(
                    f"chip {chip_of[b]} failed during cycle "
                    f"{cycle0 + bin_cycle[b]}; job {slot.job_id} readout lost",
                    job_id=slot.job_id, chip_id=chip_of[b],
                )
        # Stuck lanes: persistent per-(chip, lane) spins forced to a value
        # in the readout copy; validation downstream repairs (one stuck
        # lane in a slot) or condemns (several) the affected jobs.
        stuck_by_chip = {c: plan.stuck_lanes(c, self.lanes_per_chip)
                         for c in set(chip_of)}
        for b, _, slot in slots:
            if b in failed_bins or slot.job_id not in results:
                continue
            stuck = [la for la in stuck_by_chip.get(chip_of[b], ())
                     if slot.offset <= la < slot.offset + slot.n]
            if not stuck:
                continue
            res = results[slot.job_id]
            spins = res.spins.numpy().copy()
            for la in stuck:
                spins[..., la - slot.offset] = plan.stuck_value
            results[slot.job_id] = _host_result(spins, res.energies.numpy())
            faults_by_job[slot.job_id] = faults_by_job.get(slot.job_id, ()) + (
                "stuck-lane",)
        # Per-job readout corruption (bit flips / energy scrambles).
        for b, _, slot in slots:
            if slot.job_id not in results:
                continue
            res = results[slot.job_id]
            spins, energies, kind = plan.corrupt_readout(
                slot.job_id, res.spins.numpy(), res.energies.numpy())
            if kind != "none":
                results[slot.job_id] = _host_result(spins, energies)

    def _validate_results(self, bins, slots, by_id, chip_of, results,
                          faults_by_job, failed, chip_outcome):
        """Host-side detection: recompute each surviving readout's energy
        and classify clean / repaired / corrupt (see farm.faults)."""
        outcome_rank = {"ok": 0, "degraded": 1, "failed": 2}
        for b, _, slot in slots:
            res = results.get(slot.job_id)
            if res is None:
                continue
            job = by_id[slot.job_id]
            verdict = validate_readout(
                res.spins.numpy(), res.energies.numpy(),
                job.ising.h.numpy(), job.ising.j.numpy())
            chip = chip_of[b]
            if verdict.status == "clean":
                chip_outcome.setdefault(chip, "ok")
                continue
            if verdict.status == "repaired":
                results[slot.job_id] = _host_result(
                    verdict.spins.astype(res.spins.numpy().dtype),
                    res.energies.numpy(),
                )
                faults_by_job[slot.job_id] = faults_by_job.get(
                    slot.job_id, ()) + (f"repaired:{verdict.repaired_reads}",)
                if outcome_rank[chip_outcome.get(chip, "ok")] < 1:
                    chip_outcome[chip] = "degraded"
                continue
            # corrupt: never committed as a result.
            results.pop(slot.job_id, None)
            failed[slot.job_id] = CorruptReadout(
                f"job {slot.job_id} readout failed validation on chip "
                f"{chip}: {verdict.detail}",
                job_id=slot.job_id, chip_id=chip,
            )
            chip_outcome[chip] = "failed"

    def _bill_chips(self, bins, chip_of, bin_cycle, r_tier: int) -> None:
        """Advance chip busy-time and the sim clock for a drain whose
        readouts were lost (drain timeout): the hardware ran, the caller
        gets nothing.  Caller holds the state lock."""
        bin_seconds = r_tier * self.hardware.seconds_per_solve
        cycles = (max(bin_cycle) + 1) if bin_cycle else 0
        for b, inst in enumerate(bins):
            chip = self._chips[chip_of[b]]
            chip.solves += 1
            chip.busy_seconds += bin_seconds
            chip.lanes_capacity += inst.capacity
        self._sim_time += cycles * bin_seconds
        self._cycle += cycles

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _execute_fused(self, bins, slots, by_id, hp, jp, phi0, *, steps, dt, ks_max):
        """Fused drain: ONE launch; per-job winners come back, nothing else.
        The host operands move to the device once and the winners come back
        once.  Runs without the state lock; returns (results, bytes_h2d,
        bytes_d2h) for the caller to commit.  Bytes are metered from the
        operands' host shapes, as the reference counts them."""
        b_pad, _, L = phi0.shape
        s_pad = bucket_to(max(len(inst.slots) for inst in bins), ops.SLOT_PAD)
        hu = np.zeros((b_pad, L), np.float32)
        ju = np.zeros((b_pad, L, L), np.float32)
        mask = np.zeros((b_pad, L, s_pad), np.float32)
        reads = np.zeros((b_pad, s_pad), np.float32)
        for b, inst in enumerate(bins):
            hu[b] = inst.h_orig
            ju[b] = inst.j_orig
            for si, slot in enumerate(inst.slots):
                mask[b, slot.offset : slot.offset + slot.n, si] = 1.0
                reads[b, si] = max(by_id[slot.job_id].reads, 1)
        h2d = (jp.nbytes + hp.nbytes + ju.nbytes + hu.nbytes
               + mask.nbytes + reads.nbytes + _nbytes(phi0))
        best_e, best_s = ops.cobi_anneal_packed_best(
            *self._to_device(jp, hp, ju, hu, mask, reads), phi0,
            steps=steps, dt=dt, ks_max=ks_max,
        )
        best_e = best_e.cpu().numpy()  # (B, S) f32
        best_s = best_s.cpu().numpy()  # (B, S, L) int8
        results = {}
        for b, si, slot in slots:
            results[slot.job_id] = _host_result(
                best_s[b, si : si + 1, slot.offset : slot.offset + slot.n],
                best_e[b, si : si + 1],
            )
        return results, h2d, best_e.nbytes + best_s.nbytes

    def _execute_full(self, bins, slots, by_id, hp, jp, phi0, *, steps, dt, ks_max):
        """Legacy two-launch drain: full trajectories, separate re-scoring;
        every read of every job comes back to the host.  Runs without the
        state lock; returns (results, bytes_h2d, bytes_d2h) to commit."""
        h2d = jp.nbytes + hp.nbytes + _nbytes(phi0)
        phi = ops.cobi_trajectory_batch(
            *self._to_device(jp, hp), phi0, steps=steps, dt=dt, ks_max=ks_max,
        )
        spins_packed = kref.ref_cobi_spins(phi).cpu().numpy()  # (B, R, L) int8
        d2h = spins_packed.nbytes

        # One batched energy launch scores every job against its ORIGINAL
        # (h, J); per-job spins sit at lane offset 0, exactly like the solo
        # ops.ising_energy padding path, so scores match solo bit-for-bit.
        n_jobs = len(slots)
        r_tier = phi0.shape[1]
        # Pad scoring to the same lane multiple the solo ops.ising_energy
        # path would use for the group's largest job (usually one 128-lane
        # tile; more when the farm is configured for >128-spin chips).
        score_n = bucket_to(max(max(s.n for _, _, s in slots), LANE), LANE)
        s_stack = np.zeros((n_jobs, r_tier, score_n), np.float32)
        h_stack = np.zeros((n_jobs, score_n), np.float32)
        j_stack = np.zeros((n_jobs, score_n, score_n), np.float32)
        for k, (b, _, slot) in enumerate(slots):
            job = by_id[slot.job_id]
            s_stack[k, :, : slot.n] = spins_packed[b, :, slot.offset : slot.offset + slot.n]
            h_stack[k, : slot.n] = job.ising.h.numpy()
            j_stack[k, : slot.n, : slot.n] = job.ising.j.numpy()
        h2d += s_stack.nbytes + h_stack.nbytes + j_stack.nbytes
        energies = ops.ising_energy(
            *self._to_device(s_stack, h_stack, j_stack)
        ).cpu().numpy()  # (n_jobs, r_tier)
        d2h += energies.nbytes

        results = {}
        for k, (b, _, slot) in enumerate(slots):
            job = by_id[slot.job_id]
            # Host tensors: the reduce that consumes these is numpy.  Copies,
            # not views -- a view would pin the whole packed batch in memory
            # for as long as the result is retained.
            results[job.job_id] = _host_result(
                spins_packed[b, : job.reads, slot.offset : slot.offset + slot.n],
                energies[k, : job.reads],
            )
        return results, h2d, d2h

    def _account(self, bins, slots, by_id, r_tier: int, h2d: int, d2h: int,
                 *, chip_of: Optional[List[int]] = None,
                 faults: Optional[Dict[int, Tuple[str, ...]]] = None):
        """Simulated hardware accounting: bins occupy their assigned chip
        (round-robin when no placement was computed; health-aware otherwise)
        for the tier's sequential executions.  The launch group's
        host<->device bytes are attributed per job by lane share."""
        hw = self.hardware
        bin_seconds = r_tier * hw.seconds_per_solve
        b_real = len(bins)
        if chip_of is None:
            chip_of = [b % self.n_chips for b in range(b_real)]
        faults = faults or {}
        bin_cycle, cycles = _chip_cycles(chip_of)
        t0 = self._sim_time
        cycle0 = self._cycle
        bin_completion = {}
        for b, inst in enumerate(bins):
            chip = self._chips[chip_of[b]]
            bin_completion[b] = t0 + (bin_cycle[b] + 1) * bin_seconds
            chip.solves += 1
            chip.busy_seconds += bin_seconds
            chip.jobs += len(inst.slots)
            chip.lanes_used += inst.lanes_used
            chip.lanes_capacity += inst.capacity
        self._sim_time = t0 + cycles * bin_seconds
        self._cycle += cycles

        lanes = [slot.n for _, _, slot in slots]
        job_h2d = _attribute_bytes(h2d, lanes)
        job_d2h = _attribute_bytes(d2h, lanes)
        tracer = self.obs.tracer
        for k, (b, _, slot) in enumerate(slots):
            job = by_id[slot.job_id]
            inst = bins[b]
            share = slot.n / inst.lanes_used
            receipt = JobReceipt(
                job_id=job.job_id,
                chip_id=chip_of[b],
                cycle=cycle0 + bin_cycle[b],
                lanes=slot.n,
                bin_occupancy=inst.occupancy,
                sim_latency_seconds=bin_completion[b] - job.submit_sim_time,
                chip_seconds=bin_seconds * share,
                energy_joules=bin_seconds * share * hw.solver_power_w,
                bytes_h2d=job_h2d[k],
                bytes_d2h=job_d2h[k],
                sim_completed=bin_completion[b],
                tag=job.tag,
                faults=faults.get(job.job_id, ()),
            )
            self._receipts[job.job_id] = receipt
            self._m_job_latency.observe(receipt.sim_latency_seconds)
            self._m_job_energy.observe(receipt.energy_joules)
            self._m_job_chip_seconds.observe(receipt.chip_seconds)
            if tracer.enabled:
                # The receipt IS the span's meter set (copied verbatim, so
                # span sums equal FarmStats meters bit-for-bit); the sim
                # track shows the bin's occupancy window on its chip.
                tracer.emit_span(
                    "farm.job", trace_id=job.tag,
                    parent=tracer.root_id(job.tag),
                    track=f"chip{chip_of[b]}",
                    sim_t0=bin_completion[b] - bin_seconds,
                    sim_t1=bin_completion[b],
                    job_id=job.job_id, chip_id=receipt.chip_id,
                    cycle=receipt.cycle, lanes=receipt.lanes,
                    bin_occupancy=receipt.bin_occupancy,
                    sim_latency_seconds=receipt.sim_latency_seconds,
                    chip_seconds=receipt.chip_seconds,
                    energy_joules=receipt.energy_joules,
                    bytes_h2d=receipt.bytes_h2d,
                    bytes_d2h=receipt.bytes_d2h,
                    faults=receipt.faults,
                )


def _chip_cycles(chip_of: Sequence[int]) -> Tuple[List[int], int]:
    """Per-bin serialized position on its chip, plus the drain's total
    cycle count (the busiest chip's bin count)."""
    pos: Dict[int, int] = {}
    bin_cycle: List[int] = []
    for chip in chip_of:
        k = pos.get(chip, 0)
        bin_cycle.append(k)
        pos[chip] = k + 1
    return bin_cycle, (max(pos.values()) if pos else 0)


def _group_fault_kinds(faults_by_job: Dict[int, Tuple[str, ...]],
                       failed: Dict[int, BaseException]) -> Dict[str, List[int]]:
    """Fold per-job fault tags + terminal failures into counter buckets."""
    kinds: Dict[str, List[int]] = {}
    for jid, tags in faults_by_job.items():
        for tag in tags:
            kinds.setdefault(tag.split(":", 1)[0], []).append(jid)
    for jid, exc in failed.items():
        if isinstance(exc, ChipFailure):
            kinds.setdefault("chip_failure", []).append(jid)
        elif isinstance(exc, CorruptReadout):
            kinds.setdefault("corrupt", []).append(jid)
        else:
            kinds.setdefault("fault", []).append(jid)
    return kinds


def _attribute_bytes(total: int, weights: Sequence[int]) -> List[int]:
    """Split ``total`` bytes over jobs proportional to ``weights`` (lanes),
    exactly: integer largest-remainder apportionment, so the per-job bytes of
    one launch group always sum to the bytes the group actually moved."""
    s = sum(weights)
    if s <= 0 or total <= 0:
        return [0] * len(weights)
    floors = [(total * w) // s for w in weights]
    remainder = total - sum(floors)
    # Largest fractional parts (total*w mod s) get the leftover bytes;
    # deterministic tie-break on position.
    order = sorted(range(len(weights)),
                   key=lambda i: (-((total * weights[i]) % s), i))
    for i in order[:remainder]:
        floors[i] += 1
    return floors


def _host_result(spins: np.ndarray, energies: np.ndarray) -> SolverResult:
    """A job's result as host tensors owning copies of ``spins``/``energies``."""
    return SolverResult(spins=torch.from_numpy(np.array(spins, copy=True)),
                        energies=torch.from_numpy(np.array(energies, copy=True)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _phi0_from_keys(keys: torch.Tensor, *, r: int, lanes: int, device) -> torch.Tensor:
    """(K, 2) key words -> (K, r, lanes) uniform phases on ``device``; job k
    uses [:, :n_k].  ``jax.vmap(jax.random.uniform)`` of the reference, bit
    for bit."""
    return prng.uniform_many(keys, (r, lanes), 0.0, 2.0 * math.pi, device=device)


def solve_many(
    instances: Sequence[IsingProblem],
    keys: Sequence[torch.Tensor],
    *,
    n_chips: int = 4,
    reads: int = 8,
    steps: int = 400,
    dt: float = 0.35,
    ks_max: float = 1.2,
    device=None,
    check: bool = True,
    reduce: str = "none",
    policy: str = "manual",
) -> List[SolverResult]:
    """One-shot convenience: pack + solve a list of instances on a fresh farm.

    ``policy`` selects the drain policy; with the default ``"manual"`` one
    explicit drain flushes everything, with any background policy the futures
    resolve on their own and are simply awaited (results are bit-identical
    either way -- only accounting differs).  ``device=None`` means the card;
    without one only ``device="cpu"`` runs."""
    with CobiFarm(n_chips, device=device, check=check, policy=policy) as farm:
        futures = [
            farm.submit(ising, key, reads=reads, steps=steps, dt=dt, ks_max=ks_max,
                        reduce=reduce)
            for ising, key in zip(instances, keys)
        ]
        if policy == "manual":
            farm.drain()
        return [f.result(timeout=600.0) for f in futures]
