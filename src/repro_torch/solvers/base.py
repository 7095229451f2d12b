"""Common solver interface: results, the per-iteration solver registry, the
``SolverBackend`` serving protocol and a thread-pool backend.

Every solver consumes an :class:`repro_torch.core.formulation.IsingProblem`
and returns a :class:`SolverResult`.  Two call surfaces build on that:

* **Registry** -- :func:`ising_solver` maps a solver name (``"cobi"``,
  ``"tabu"``, ``"sa"``, ``"mcmc"``, ``"brute"``: the reference's five) to a
  uniform callable ``solve(ising, key, *, reads, steps, check, reduce)``, so
  the pipeline's per-iteration invoke needs no per-solver branching;
  solvers that ignore a knob (tabu has no anneal ``steps``) accept and drop
  it.

* **Backend protocol** -- :class:`SolverBackend` is the continuous serving
  surface: ``submit()`` enqueues one job and returns a :class:`SolverFuture`
  (``result(timeout=)`` / ``receipt()`` / ``cancel()`` /
  ``add_done_callback`` / ``release``), and the pipeline's backend drivers
  reduce futures instead of calling solvers inline.
  ``repro_torch.farm.CobiFarm`` implements it with packed batched anneals
  and simulated-hardware receipts; :class:`ThreadPoolBackend` implements it
  by running a registry solver on worker threads (futures resolve as
  workers finish, so its drain policy is the self-draining ``"pool"``), and
  ``repro_torch.farm.McmcPoolBackend`` builds the MCMC annealer bank on it.
  Results through any backend are bit-identical to calling the solver
  inline with the same key.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@dataclasses.dataclass
class SolverResult:
    spins: torch.Tensor  # (R, N) int8 in {-1, +1}
    energies: torch.Tensor  # (R,) f32 -- energy of the instance that was solved

    def best(self) -> tuple[torch.Tensor, torch.Tensor]:
        i = int(torch.argmin(self.energies))
        return self.spins[i], self.energies[i]

    def reduced(self, reduce: str = "best") -> "SolverResult":
        """Host-side replica reduction, matching the farm's fused epilogue:
        ``"best"`` keeps only the argmin-energy read ((1, N) spins / (1,)
        energies, first minimum on ties -- the ``np.argmin`` convention every
        consumer uses); ``"none"`` returns self unchanged."""
        if reduce == "none":
            return self
        if reduce != "best":
            raise ValueError(f"unknown reduce {reduce!r}")
        i = int(np.argmin(self.energies.detach().cpu().numpy()))
        return SolverResult(
            spins=self.spins[i : i + 1], energies=self.energies[i : i + 1]
        )


# --------------------------------------------------------------- registry

# Solver name -> (module, attr) of the uniform Ising entry point.
_ISING_SOLVERS = {
    "cobi": ("repro_torch.solvers.cobi", "solve"),
    "tabu": ("repro_torch.solvers.tabu", "solve_ising"),
    "sa": ("repro_torch.solvers.sa", "solve_ising"),
    "mcmc": ("repro_torch.solvers.mcmc", "solve_ising"),
    "brute": ("repro_torch.solvers.brute", "solve_ising"),
}

ISING_SOLVER_NAMES = tuple(sorted(_ISING_SOLVERS))


def ising_solver(name: str) -> Callable[..., SolverResult]:
    """Uniform per-iteration solver entry point for ``name``: a callable
    ``(ising, key, *, reads=8, steps=400, check=False, reduce="none")``."""
    try:
        module, attr = _ISING_SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown Ising solver {name!r}; known: {ISING_SOLVER_NAMES}"
        ) from None
    return getattr(importlib.import_module(module), attr)


# ---------------------------------------------------------------- protocol


@runtime_checkable
class SolverFuture(Protocol):
    """Handle to one submitted solve job (the ``FarmFuture`` contract)."""

    def done(self) -> bool: ...

    def result(self, timeout: Optional[float] = None) -> SolverResult: ...

    def receipt(self, timeout: Optional[float] = None) -> Any: ...

    def cancel(self) -> bool: ...

    def add_done_callback(self, fn: Callable[[Any], None]) -> None: ...

    def release(self) -> None: ...


@runtime_checkable
class SolverBackend(Protocol):
    """Continuous serving surface every solver is driven through.

    ``submit`` enqueues one job and returns a :class:`SolverFuture`;
    ``policy`` names the drain policy (``"manual"`` backends resolve futures
    only on a caller-side ``drain()``; any other value means futures resolve
    on their own and ``flush_hint()`` is at most an end-of-burst nudge).
    ``repro_torch.farm.CobiFarm`` and :class:`ThreadPoolBackend` both
    satisfy this structurally.
    """

    policy: str

    def submit(
        self,
        ising,
        key: torch.Tensor,
        *,
        reads: int = 8,
        steps: int = 400,
        priority: int = 0,
        deadline: Optional[float] = None,
        check: Optional[bool] = None,
        reduce: str = "none",
        tag: Optional[int] = None,
    ) -> SolverFuture: ...

    def drain(self) -> int: ...

    def flush_hint(self) -> None: ...

    def pending_jobs(self) -> int: ...

    def sim_now(self) -> float: ...

    def capacity_hint(self) -> "CapacityHint": ...

    def close(self) -> None: ...


@dataclasses.dataclass(frozen=True)
class PoolReceipt:
    """Host-side accounting for jobs run by :class:`ThreadPoolBackend`.

    ``host_seconds`` is the MEASURED worker wall time of the solve and
    ``energy_joules`` the simple host energy model (``host_power_w`` watts x
    wall time), so mixed-backend serving bills chip jobs and host jobs
    through one receipt stream.  ``chip_seconds`` stays 0 (there is no chip)
    and bytes are 0 because host solvers never cross a device boundary.
    ``sim_completed``/``sim_latency_seconds`` are on the pool's own clock
    (wall seconds since backend construction), matching the farm receipt's
    submit->done semantics.
    """

    job_id: int
    tag: Optional[int] = None
    chip_seconds: float = 0.0
    host_seconds: float = 0.0  # measured worker wall time of the solve
    energy_joules: float = 0.0
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    sim_latency_seconds: float = 0.0
    sim_completed: float = 0.0


@dataclasses.dataclass(frozen=True)
class CapacityHint:
    """A backend's live-load snapshot for routers and admission layers.

    ``est_queue_seconds`` is the backend's own estimate of how long a job
    submitted NOW waits before service begins (farm: chip cycles of queued
    tiers; pool: queued jobs x observed mean job seconds / workers);
    ``parallelism`` is the number of concurrent service slots (chips or
    worker threads); ``kind`` tells consumers which clock the estimate lives on
    (``"sim"`` chips vs ``"host"`` wall time).
    """

    pending_jobs: int
    est_queue_seconds: float
    parallelism: int
    kind: str = "host"  # "sim" | "host"


class PoolJobCancelled(RuntimeError):
    """The pool job was cancelled before a worker picked it up."""


class AwaitableFuture:
    """Event-backed, thread-safe, awaitable future: the machinery of
    :class:`PoolFuture` (``FarmFuture`` keeps its own variant -- its payloads
    live in the farm's tables, not on the future).

    The ``FarmFuture`` contract: ``result(timeout=)`` blocks until a
    producer thread calls ``_finish``; ``add_done_callback`` fires from that
    thread (immediately if already done, exceptions isolated); ``await
    future`` suspends the running asyncio task via
    ``loop.call_soon_threadsafe``.
    """

    __slots__ = ("_event", "_lock", "_value", "_error", "_callbacks")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable] = []

    def _describe(self) -> str:  # subclasses name themselves in timeouts
        return "future"

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block up to ``timeout`` seconds; True once done.  Unlike
        ``result()`` this never raises."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        self._wait(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._wait(timeout)
        return self._error

    def add_done_callback(self, fn: Callable) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def release(self) -> None:
        """Per-job cleanup hook (no-op: this future owns its own payload)."""

    def __await__(self):
        if not self._event.is_set():
            import asyncio

            loop = asyncio.get_running_loop()
            waiter = loop.create_future()

            def _wake(w):
                if not w.done():
                    w.set_result(None)

            self.add_done_callback(lambda _f: loop.call_soon_threadsafe(_wake, waiter))
            yield from waiter.__await__()
        return self.result()

    def _wait(self, timeout: Optional[float]) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self._describe()} did not complete within {timeout}s")

    def _finish(self, value=None, error: Optional[BaseException] = None) -> None:
        with self._lock:
            self._value = value
            self._error = error
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 -- isolate broken callbacks
                traceback.print_exc()


class PoolFuture(AwaitableFuture):
    """Thread-safe, awaitable future for one :class:`ThreadPoolBackend` job.

    ``receipt(timeout=)`` complements ``result``; ``cancel()`` succeeds only
    while the job is still queued behind busy workers.
    """

    __slots__ = ("job_id", "tag", "_receipt", "_cf")

    def __init__(self, job_id: int, tag: Optional[int] = None):
        super().__init__()
        self.job_id = job_id
        self.tag = tag
        self._receipt: Optional[PoolReceipt] = None
        self._cf = None  # concurrent.futures handle, set by the backend

    def _describe(self) -> str:
        return f"pool job {self.job_id}"

    def receipt(self, timeout: Optional[float] = None) -> PoolReceipt:
        self._wait(timeout)
        if self._error is not None:
            raise self._error
        return self._receipt

    def cancel(self) -> bool:
        """Cancel if no worker has started the job; True on success."""
        if self._cf is None or not self._cf.cancel():
            return False
        self._finish(error=PoolJobCancelled(
            f"pool job {self.job_id} was cancelled before running"
        ))
        return True

    def _finish(self, result: Optional[SolverResult] = None,
                receipt: Optional[PoolReceipt] = None,
                error: Optional[BaseException] = None) -> None:
        self._receipt = receipt
        super()._finish(result, error)


class ThreadPoolBackend:
    """``SolverBackend`` adapter running a registry solver on worker threads.

    Gives a registry solver the same submit->future->reduce serving surface
    as the chip farm.  Futures resolve as workers finish -- the backend is
    self-draining (``policy="pool"``); ``drain()`` is therefore a blocking
    flush (wait for everything in flight) and ``flush_hint()`` a no-op.
    Receipts carry host accounting: measured worker wall time per job plus
    the W x wall-time host energy model (``host_power_w``), on the pool's own
    clock (wall seconds since construction).  Results are bit-identical to
    the inline path (each job solves from its own key; worker scheduling
    cannot reorder anything a result depends on).  Jobs run on the device
    their instance lies on.
    """

    def __init__(self, solver: str = "tabu", *, workers: int = 4,
                 solve_fn: Optional[Callable[..., SolverResult]] = None,
                 host_power_w: float = 20.0, obs=None):
        from repro_torch.obs import Observability

        self.solver = solver
        self.policy = "pool"
        self.workers = max(1, workers)
        self.host_power_w = host_power_w
        self.obs = obs if obs is not None else Observability.disabled()
        self._fn = solve_fn if solve_fn is not None else ising_solver(solver)
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix=f"{solver}-pool"
        )
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: set = set()
        self._closed = False
        self._t0 = time.monotonic()
        # Observed mean worker seconds per job (EWMA), feeding the
        # capacity_hint queue estimate; 0 until the first job completes.
        self._avg_job_seconds = 0.0
        reg = self.obs.registry
        self._m_jobs = reg.counter(
            "pool_jobs_total", "jobs completed by host pool backends",
            labels=("solver",)).labels(solver=solver)
        self._m_secs = reg.histogram(
            "pool_job_seconds", "measured worker wall seconds per pool job",
            labels=("solver",)).labels(solver=solver)

    def submit(
        self,
        ising,
        key: torch.Tensor,
        *,
        reads: int = 8,
        steps: int = 400,
        priority: int = 0,
        deadline: Optional[float] = None,
        check: Optional[bool] = None,
        reduce: str = "none",
        tag: Optional[int] = None,
        **solve_kwargs,
    ) -> PoolFuture:
        """Queue one solve; ``priority``/``deadline`` are accepted for
        protocol compatibility (a thread pool has no packing to order)."""
        del priority, deadline
        with self._lock:
            if self._closed:
                raise RuntimeError("backend is closed")
            job_id = next(self._ids)
            fut = PoolFuture(job_id, tag)
            self._inflight.add(job_id)
        submitted = self.sim_now()

        def run():
            try:
                t0 = time.perf_counter()
                res = self._solve_job(
                    ising, key, reads=reads, steps=steps, check=check,
                    reduce=reduce, **solve_kwargs,
                )
                wall = time.perf_counter() - t0
                done = self.sim_now()
                with self._lock:
                    self._avg_job_seconds = (
                        wall if self._avg_job_seconds == 0.0
                        else 0.8 * self._avg_job_seconds + 0.2 * wall
                    )
                receipt = self._make_receipt(
                    job_id, tag, ising=ising, reads=reads, wall=wall,
                    submitted=submitted, done=done,
                )
                self._m_jobs.inc()
                self._m_secs.observe(wall)
                tracer = self.obs.tracer
                if tracer.enabled:
                    t1 = tracer.now()
                    tracer.emit_span(
                        "pool.job", trace_id=tag,
                        parent=tracer.root_id(tag),
                        track=f"pool:{self.solver}",
                        t0=t1 - wall, t1=t1,
                        sim_t0=submitted, sim_t1=done,
                        job_id=job_id, n=int(ising.n),
                        host_seconds=receipt.host_seconds,
                        chip_seconds=receipt.chip_seconds,
                        energy_joules=receipt.energy_joules,
                        bytes_h2d=receipt.bytes_h2d,
                        bytes_d2h=receipt.bytes_d2h,
                        sim_latency_seconds=receipt.sim_latency_seconds,
                    )
                fut._finish(res, receipt)
            except BaseException as exc:  # noqa: BLE001 -- fail the future
                fut._finish(error=exc)
            finally:
                self._job_finished(job_id)

        fut._cf = self._pool.submit(run)
        # Cancelled jobs never reach run(); the done-callback retires them.
        fut.add_done_callback(lambda _f: self._job_finished(job_id))
        return fut

    # Worker-side hooks subclasses override to change how a job solves or
    # how it is billed (see repro_torch.farm.McmcPoolBackend, which bills a
    # simulated CMOS-annealer hardware model instead of measured host watts).

    def _solve_job(self, ising, key, *, reads, steps, check, reduce,
                   **solve_kwargs) -> SolverResult:
        """Run one job on the worker thread; returns the reduced result."""
        res = self._fn(ising, key, reads=reads, steps=steps,
                       check=bool(check), reduce="none", **solve_kwargs)
        return res.reduced(reduce)

    def _make_receipt(self, job_id, tag, *, ising, reads, wall, submitted,
                      done) -> PoolReceipt:
        """Bill one completed job (measured wall time x host watts)."""
        del ising, reads
        return PoolReceipt(
            job_id, tag,
            host_seconds=wall,
            energy_joules=wall * self.host_power_w,
            sim_latency_seconds=done - submitted,
            sim_completed=done,
        )

    def drain(self) -> int:
        """Block until every in-flight job resolved; returns 0 (the pool
        completes jobs continuously -- nothing is 'released' by a drain)."""
        with self._idle:
            while self._inflight:
                self._idle.wait()
        return 0

    def _job_finished(self, job_id: int) -> None:
        with self._idle:
            self._inflight.discard(job_id)
            if not self._inflight:
                self._idle.notify_all()

    def flush_hint(self) -> None:
        """No-op: workers start jobs the moment they are submitted."""

    def pending_jobs(self) -> int:
        with self._lock:
            return len(self._inflight)

    def sim_now(self) -> float:
        """The pool's hardware clock IS host wall time (seconds since
        construction); receipts' ``sim_completed`` live on this clock."""
        return time.monotonic() - self._t0

    def capacity_hint(self) -> CapacityHint:
        """Live-load snapshot: queued jobs beyond the worker count wait
        roughly one observed mean job time per ``workers`` of backlog."""
        with self._lock:
            pending = len(self._inflight)
            backlog = max(pending - self.workers, 0)
            wait = backlog * self._avg_job_seconds / self.workers
        return CapacityHint(
            pending_jobs=pending, est_queue_seconds=wait,
            parallelism=self.workers, kind="host",
        )

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ThreadPoolBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
