"""Continuous serving engine: enqueueing submit(), one driver loop, SLO-aware
admission.

Request -> encode (backbone stage, backbone inline, or hashed BoW) ->
k-of-n Ising formulation -> decomposition if oversized ->
stochastic-rounding iterations on the selected solver backend -> the
selected m items.

The request surface is **workload-generic**: the native request is a
:class:`repro_torch.serving.api.SelectionRequest` (items + a
:class:`~repro_torch.serving.api.KofnSpec` objective -- relevance source,
pairwise redundancy, m, lambda), and every workload in
``repro_torch.workloads`` (summarize, dedup, rerank, multidoc) reduces to it.
``submit(text=...)`` / :class:`SummarizeRequest` remain as thin
compatibility views that build the equivalent centroid-relevance
SelectionRequest -- bit-identical selections by construction, tested.

The serving surface is **continuous**, not batch-shaped:

* ``submit()`` is a real enqueue.  It runs admission control, assigns the
  request id, stamps the per-request PRNG key, and returns a
  :class:`ResponseFuture` (``result(timeout=)``, ``add_done_callback``,
  ``cancel()``, ``await`` -- the ``FarmFuture`` contract, one level up).
* With an :class:`repro_torch.embeddings.EncoderStage` as the ``encoder``, the
  neural backbone becomes a SECOND continuous-batching pipeline stage in
  front of the farm: requests' encode jobs batch into
  ``embed_sentences`` launches on the stage's own drain thread while the
  driver keeps draining OTHER requests' Ising rounds -- encode of request
  B overlaps anneal of request A.  Encoder seconds/bytes/joules are
  metered per request into the response next to chip time, and the
  stage's EWMA encode estimate spends deadline slack at admission.
* A background **driver thread** owns all in-flight requests.  Each request
  is a generator that submits its solve jobs (ALL planned decomposition
  windows, speculated ahead by the pipelined window planner) to the engine's
  :class:`repro_torch.solvers.base.SolverBackend` and yields; the driver steps
  every active generator, so jobs from concurrently-resident requests pack
  into the same backend rounds.  Under the COBI farm's ``policy="manual"``
  the driver supplies the round barrier (ONE ``drain()`` per round packs all
  requests' jobs onto shared virtual chips); under a background drain policy
  (``"bin-full"``/``"deadline"``/``"timer"``) or a self-draining host
  thread-pool backend it never drains -- generators just block on their
  futures.  Results are bit-identical across policies and across arrival
  interleavings: every job solves from its own key.
* ``run_batch()`` and ``stream()`` are thin wrappers over the same loop:
  enqueue everything, then wait (in order) or yield (in completion order).
  ``run_batch(requests, seed=s)`` reproduces the legacy lockstep results
  bit-for-bit: per-request keys are ``fold_in(key(s), request_id)``, and the
  engine owns id assignment -- duplicate or unset (``<= 0``) caller ids are
  remapped to fresh engine ids instead of silently colliding.
* An :class:`repro_torch.serving.admission.AdmissionController` sits between
  ``submit()`` and the backend: a hard queue-depth cap and an
  ``estimate_packing``-based deadline-feasibility check on the simulated
  clock, with configurable overload behaviour -- reject
  (:class:`EngineOverloadedError`) or degrade ``reads`` to a floor -- so the
  farm's deadline drain policy can actually meet its watermarks at
  saturation instead of watching an unbounded queue blow every deadline.

* With ``routing=True`` a :class:`repro_torch.serving.router.BackendRouter` sits
  between admission and the backends: per-backend cost models (a
  :class:`repro_torch.serving.calibration.CalibrationProfile` -- checked-in
  artifact or the built-in default) predict latency/energy/quality on the
  COBI farm AND a same-solver host thread pool, admission feasibility
  consults those predictions across backends, and farm overload SPILLS onto
  the pool instead of shedding.  Results are bit-identical wherever a
  request lands (every job solves from its own key; both backends run the
  same solver); only latency/energy accounting and the serving clock
  differ.  Decomposed requests route per window; responses carry
  ``backend_used`` and predicted-vs-realized latency, and realized receipts
  feed the profile's EWMA corrections.

Jobs go in with ``reduce="best"`` (the COBI farm's fused
anneal->readout->best-of epilogue selects each iteration's winning read ON
DEVICE; host backends reduce in the worker).  Per-request latency, energy
and attributed h2d/d2h transfer bytes come from the backend's job receipts
(the paper's 200 us / 25 mW hardware model for the farm; measured worker
wall time x host watts for thread pools).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import traceback
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import SolveConfig
from repro_torch.core.hardware import COBI, MCMC_CMOS, TABU_CPU
from repro_torch.core.metrics import normalized_objective, reference_bounds
from repro_torch.core.pipeline import iter_solve_es, solve_es
from repro_torch.data.text import split_sentences
from repro_torch.embeddings import HashedBowEncoder
from repro_torch.farm import CobiFarm, McmcPoolBackend
from repro_torch.obs import NULL_SPAN, Observability
from repro_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    EngineOverloadedError,
)
from repro_torch.serving.api import (
    KofnSpec,
    SelectionRequest,
    SelectionResponse,
    encode_texts,
    problem_from_embeddings,
)
from repro_torch.serving.calibration import CalibrationProfile, default_profile
from repro_torch.serving.recovery import RecoveryContext, RequestFailed, RetryPolicy
from repro_torch.serving.router import BackendRouter, RouterConfig
from repro_torch.solvers.base import AwaitableFuture, ThreadPoolBackend
from repro_torch.device import resolve_device
from repro_torch.solvers.cobi import COBI_MAX_SPINS

# Solvers served through a backend's submit->future loop; the rest (brute /
# exact / random baselines) run inline in the driver thread via solve_es.
_POOL_SOLVERS = ("tabu", "sa")


class RequestCancelled(RuntimeError):
    """The request was cancelled before the driver picked it up."""


class RequestEvicted(RequestCancelled):
    """The queued request was evicted (``shed="evict-lowest"``) to make room
    for a higher-priority / tighter-deadline newcomer at the depth cap."""


@dataclasses.dataclass
class SummarizeRequest:
    """Legacy summarization request -- a compatibility view.

    The engine converts it to the equivalent centroid-relevance
    :class:`~repro_torch.serving.api.SelectionRequest` (items =
    ``split_sentences(text)``) at admission; selections are bit-identical
    to the pre-redesign path by construction."""

    text: str
    m: int = 6
    request_id: int = 0  # <= 0 means "unassigned": the engine assigns one
    priority: int = 0
    # Absolute simulated-clock deadline stamped on the request's farm jobs;
    # the farm's policy="deadline" watermark trigger and the engine's
    # admission feasibility check both key on it.
    deadline: Optional[float] = None


# The response type is workload-generic (``selected`` items +
# ``encoder_*`` metering on top of the original accounting fields);
# summarization reads it through the ``summary`` property.  The old name
# stays as an alias so callers' type hints and isinstance checks hold.
SummarizeResponse = SelectionResponse


class ResponseFuture(AwaitableFuture):
    """Thread-safe, awaitable handle to one submitted request.

    The ``FarmFuture`` contract one level up (machinery shared via
    :class:`repro_torch.solvers.base.AwaitableFuture`): ``result(timeout=)``
    blocks until the driver finishes the request; ``add_done_callback`` runs
    from the driver thread (immediately if already done); ``cancel()``
    succeeds only while the request is still queued (the driver has not
    started it); ``await future`` suspends the running asyncio task.
    """

    __slots__ = ("request_id", "_engine")

    def __init__(self, engine: "SummarizationEngine", request_id: int):
        super().__init__()
        self.request_id = request_id
        self._engine = engine

    def _describe(self) -> str:
        return f"request {self.request_id}"

    def result(self, timeout: Optional[float] = None) -> SummarizeResponse:
        return super().result(timeout)

    def cancel(self) -> bool:
        """Dequeue the request if the driver has not started it; True on
        success (the future is then done and ``result()`` raises
        :class:`RequestCancelled`)."""
        return self._engine._cancel(self)


@dataclasses.dataclass
class _Work:
    """One admitted request waiting for (or owned by) the driver.

    ``req`` is always the workload-generic form -- legacy
    :class:`SummarizeRequest` submissions are converted at admission."""

    req: SelectionRequest
    key: torch.Tensor
    reads: int  # effective reads from admission (== cfg.reads unless degraded)
    degraded: bool
    future: ResponseFuture
    backend_name: Optional[str] = None  # router-chosen backend from the ticket
    predicted_seconds: float = 0.0
    sim_at_admit: float = 0.0  # primary backend clock at admission
    # Root trace span, opened when the driver adopts the request (stays
    # NULL_SPAN for queued-cancelled/evicted requests and disabled tracing).
    span: object = NULL_SPAN
    # Tracer time the request entered the driver's queue (tracing on only):
    # the start of its ``request.queue`` span.
    t_enqueued: Optional[float] = None


class SummarizationEngine:
    def __init__(
        self,
        solve_cfg: Optional[SolveConfig] = None,
        *,
        encoder=None,
        lam: float = 0.5,
        score_against_exact: bool = False,
        farm: Optional[CobiFarm] = None,
        n_chips: int = 4,
        policy: str = "manual",
        backend=None,
        pool_workers: int = 4,
        admission: Optional[AdmissionConfig] = None,
        routing: bool = False,
        route_objective: str = "min-energy",
        profile=None,
        quality_floor: Optional[float] = None,
        faults=None,
        health=None,
        retry: Optional[RetryPolicy] = None,
        seed: int = 0,
        obs=None,
        tracing: bool = True,
        device=None,
    ):
        """``backend`` injects any :class:`repro_torch.solvers.base.SolverBackend`.
        By default the COBI solver gets a ``CobiFarm(n_chips, policy=policy)``
        (``farm=`` injects a pre-built one; ``n_chips=0`` disables it -- legacy
        sequential per-request solving) and tabu/SA get a
        :class:`ThreadPoolBackend` with ``pool_workers`` threads
        (``pool_workers=0`` disables it; ``solver="mcmc"`` gets a
        :class:`repro_torch.farm.McmcPoolBackend` annealer bank instead so
        receipts bill the CMOS-annealer hardware model).  A non-manual
        ``policy`` makes the
        farm self-draining: the driver never calls ``drain()`` and futures
        resolve from the farm's background drive loop.  ``admission``
        configures the submit-side admission layer (default: admit
        everything).  ``routing=True`` (COBI farm backends only) adds a
        same-solver host thread pool and a :class:`BackendRouter` above
        admission: ``profile`` is a :class:`CalibrationProfile` (or a path to
        a saved one; default: the uncalibrated hardware-constant profile --
        a profile carrying an ``"mcmc"`` model additionally registers an
        MCMC annealer bank as a third routable backend),
        ``route_objective`` picks min-energy / min-latency / weighted, and
        ``quality_floor`` caps the predicted quality gap a backend may incur.
        ``seed`` keys the continuous ``submit()`` path: request ``r``'s key
        is ``fold_in(key(seed), r)``, so a ``run_batch`` with the same seed
        and the same engine-assigned ids is bit-identical -- routing never
        changes results, only where (and at what cost) they are computed.

        Fault-tolerant serving: ``faults`` (a
        :class:`repro_torch.farm.faults.FaultPlan`) and ``health`` (breaker config)
        are forwarded to the default farm; ``retry`` (a
        :class:`repro_torch.serving.recovery.RetryPolicy`) turns typed farm faults
        into per-job deadline-budgeted retries, failover onto the router's
        pool, and -- when both run out -- a typed
        :class:`~repro_torch.serving.recovery.RequestFailed` on the response
        future.  Without ``retry`` the first fault fails the request (still
        typed; futures are never stranded).

        Everything runs on ``device`` (``None``: the card; raises without
        one): the engine hands it to every backend it builds and forms every
        problem there, so the driver thread, the farm's drain thread and the
        pools' workers all work on that one device.  An injected ``farm=``,
        ``backend=`` or encoder stage keeps its own device."""
        self.device = resolve_device(device)
        self.cfg = solve_cfg or SolveConfig(
            solver="cobi", iterations=6, reads=8, int_range=14
        )
        # One Observability bundle (tracer + metrics registry + flight
        # recorder) is shared by every layer; ``tracing=False`` disables the
        # span path (bit-identical results either way -- tracing never
        # touches keys, instances, or scheduling) while the registry stays
        # live because the layers' stats() are views over it.
        self.obs = obs if obs is not None else Observability(tracing=tracing)
        # The driver thread's meters, traced or not: wall seconds inside its
        # rounds, and seconds its generators spent polling encode futures.
        self._m_driver_busy = self.obs.registry.counter(
            "engine_driver_busy_seconds_total",
            "driver-thread wall seconds inside its rounds")
        self._m_encode_wait = self.obs.registry.counter(
            "engine_encode_wait_seconds_total",
            "driver-thread seconds waiting on encode futures")
        # The current round's encode polling and drain windows (tracer
        # time), driver thread only.
        self._round_encode_wait = 0.0
        self._round_drains: List[tuple] = []
        self.encoder = encoder or HashedBowEncoder()
        # An EncoderStage (submit->future encoder) is the second pipeline
        # stage: _iter_one submits encode jobs and yields while they batch
        # on the stage's drain thread, overlapping other requests' Ising
        # rounds.  A plain encoder (.encode only) runs inline in the driver.
        self.stage = self.encoder if hasattr(self.encoder, "submit") else None
        if self.stage is not None and hasattr(self.stage, "attach_obs"):
            self.stage.attach_obs(self.obs)
        self.lam = lam
        self.score = score_against_exact
        self.retry = retry
        if farm is not None and (faults is not None or health is not None):
            raise ValueError(
                "pass faults=/health= only with the default farm; a pre-"
                "built farm= carries its own fault plan and health tracker"
            )
        if farm is None and backend is None and n_chips > 0 \
                and self.cfg.solver == "cobi":
            farm = CobiFarm(n_chips, policy=policy, faults=faults,
                            health=health, obs=self.obs, device=self.device)
        elif farm is not None:
            # Injected pre-built farm: rebind its metrics/tracing to the
            # engine's shared bundle (counter values carry over).
            farm.attach_obs(self.obs)
        self.farm = farm
        if backend is not None:
            self.backend = backend
            if hasattr(backend, "attach_obs"):
                backend.attach_obs(self.obs)
        elif farm is not None and self.cfg.solver == "cobi":
            self.backend = farm
        elif self.cfg.solver == "mcmc" and pool_workers > 0:
            # The MCMC solver family serves through its annealer bank so
            # receipts bill the CMOS hardware model, not host watts.
            self.backend = McmcPoolBackend(workers=pool_workers, obs=self.obs,
                                           device=self.device)
        elif self.cfg.solver in _POOL_SOLVERS and pool_workers > 0:
            self.backend = ThreadPoolBackend(self.cfg.solver,
                                             workers=pool_workers,
                                             obs=self.obs)
        else:
            self.backend = None
        self.router: Optional[BackendRouter] = None
        if routing:
            if self.farm is None or self.backend is not self.farm:
                raise ValueError(
                    "routing=True requires the default COBI farm backend "
                    "(solver='cobi' with a farm); spill targets a same-"
                    "solver host pool"
                )
            if isinstance(profile, str):
                profile = CalibrationProfile.load(profile)
            if profile is None:
                profile = default_profile(
                    n_chips=self.farm.n_chips,
                    lanes_per_chip=self.farm.lanes_per_chip,
                    pool_workers=max(pool_workers, 1),
                    pool_solver=self.cfg.solver,
                )
            spill_pool = ThreadPoolBackend(
                self.cfg.solver, workers=max(pool_workers, 1),
                host_power_w=profile.model("pool").power_w,
                obs=self.obs,
            )
            backends = {"farm": self.farm, "pool": spill_pool}
            if "mcmc" in profile.models:
                # A profile carrying an mcmc model opts the engine into the
                # third solver family: the annealer bank serves routed work
                # whenever its fitted quality knots clear the quality floor.
                backends["mcmc"] = McmcPoolBackend(
                    workers=max(profile.model("mcmc").parallelism, 1),
                    obs=self.obs, device=self.device,
                )
            self.router = BackendRouter(
                backends, profile,
                RouterConfig(objective=route_objective,
                             quality_floor=quality_floor, primary="farm"),
                obs=self.obs,
            )
        if admission is None:  # default: admit everything, just count it
            admission = AdmissionConfig(deadline_feasibility=False)
        self.admission = AdmissionController(
            admission,
            lanes_per_chip=getattr(self.backend, "lanes_per_chip", None),
            n_chips=getattr(self.backend, "n_chips", 1),
            seconds_per_solve=getattr(
                getattr(self.backend, "hardware", None), "seconds_per_solve", 0.0
            ),
            router=self.router,
            # Health-shrunk capacity flows into the ledger-side completion
            # estimate too, not just the router's live capacity_hint.
            chips_available=getattr(self.backend, "available_chips", None),
            obs=self.obs,
        )
        self._seed = seed
        self._base_key = prng.key(seed)
        self._counter = 0
        self._lock = threading.RLock()
        self._new = threading.Condition(self._lock)
        self._queue: List[_Work] = []
        self._driver: Optional[threading.Thread] = None
        self._closed = False

    def _hardware(self):
        if self.cfg.solver == "cobi":
            return COBI
        if self.cfg.solver == "mcmc":
            return MCMC_CMOS
        return TABU_CPU

    # ------------------------------------------------------------------ API

    def submit(self, text: Optional[str] = None, m: int = 6,
               priority: int = 0, deadline: Optional[float] = None, *,
               items: Optional[Sequence[str]] = None,
               kofn: Optional[KofnSpec] = None,
               workload: str = "selection") -> ResponseFuture:
        """Enqueue one request; returns an awaitable :class:`ResponseFuture`.

        Two faces, one path: ``submit(text, m)`` is the legacy
        summarization surface (verbatim-compatible); ``submit(items=...,
        kofn=KofnSpec(...))`` is the workload-generic one.  Both run
        admission control first: raises :class:`EngineOverloadedError` when
        the queue-depth cap is hit or the deadline is infeasible (or admits
        with degraded ``reads`` under ``overload="degrade"``).  The request
        id is engine-assigned; its PRNG key is
        ``fold_in(key(engine seed), id)``.
        """
        if (text is None) == (items is None):
            raise ValueError("pass exactly one of text= or items=")
        if text is not None:
            if kofn is not None:
                raise ValueError("kofn= goes with items=, not text=")
            req = SummarizeRequest(text=text, m=m, priority=priority,
                                   deadline=deadline)
        else:
            req = SelectionRequest(
                items=list(items),
                kofn=kofn if kofn is not None else KofnSpec(m=m, lam=self.lam),
                workload=workload, priority=priority, deadline=deadline,
            )
        return self.submit_request(req)

    def submit_request(self, request) -> ResponseFuture:
        """Enqueue a pre-built :class:`SelectionRequest` (e.g. from
        ``repro_torch.workloads.build_request``) or legacy
        :class:`SummarizeRequest`.  A ``request_id <= 0`` is engine-assigned
        (an explicit positive id is kept, remapped only on collision)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            rid = request.request_id
            if rid <= 0 or self.admission.is_active(rid):
                rid = self._next_rid_locked()
        if rid != request.request_id:
            request = dataclasses.replace(request, request_id=rid)
        return self._enqueue(request, prng.fold_in(self._base_key, rid))

    def run_batch(self, requests: Sequence, seed: int = 0
                  ) -> List[SelectionResponse]:
        """Serve a batch (:class:`SelectionRequest` and/or legacy
        :class:`SummarizeRequest`) through the continuous driver; blocks
        until done.

        Thin wrapper over the ``submit()`` machinery: every request is
        enqueued (admission-controlled) and the call waits for all futures in
        order.  Requests with duplicate or unset (``<= 0``) ids are remapped
        to fresh engine-assigned ids -- the engine owns id assignment, so two
        hand-built requests can no longer silently share a PRNG key.  All
        requests' subproblems share the backend's packed rounds, exactly like
        the legacy lockstep loop (bit-identical for the same seed and ids).
        """
        return [f.result() for f in self.submit_batch(requests, seed)]

    def submit_batch(self, requests: Sequence, seed: int = 0
                     ) -> List[ResponseFuture]:
        """Enqueue a batch atomically; returns one future per request.

        The batch face of :meth:`submit`: every request is admitted BEFORE
        the driver adopts any of them, so admission/routing decisions are a
        pure function of the request mix (no race against in-flight drains)
        and the whole batch's jobs pack into shared first-round drains.
        Unlike :meth:`run_batch` the caller collects results -- a failed
        request surfaces on ITS future instead of aborting the batch.
        """
        return self._enqueue_batch(requests, seed)

    def stream(self, requests: Iterable, seed: int = 0):
        """Serve requests, yielding responses in COMPLETION order.

        The streaming face of the same driver loop: everything is enqueued
        up front (id remapping and admission as in :meth:`run_batch`), then
        responses are yielded as their futures resolve -- a fast small
        request is not stuck behind a slow oversized one.  A failed request
        raises when its turn to yield comes.
        """
        import queue as queue_mod

        done_q: "queue_mod.Queue[ResponseFuture]" = queue_mod.Queue()
        futures = self._enqueue_batch(list(requests), seed)
        for fut in futures:
            fut.add_done_callback(done_q.put)
        for _ in range(len(futures)):
            yield done_q.get().result()

    def stats(self) -> dict:
        """One serving-health snapshot across the engine's layers:
        admission counters, the encoder's word-vector cache hit rate (BoW)
        or stage counters (EncoderStage), and router state when routing."""
        out: dict = {"admission": dataclasses.asdict(self.admission.stats())}
        if hasattr(self.encoder, "cache_stats"):
            out["encoder_cache"] = self.encoder.cache_stats()
        if self.stage is not None:
            out["encoder_stage"] = dataclasses.asdict(self.stage.stats())
        if self.router is not None:
            out["router"] = self.router.stats()
        tracer = self.obs.tracer
        out["obs"] = {
            "tracing": tracer.enabled,
            "unclosed_spans": tracer.unclosed_spans(),
            "dropped_events": tracer.dropped,
        }
        return out

    def metrics_snapshot(self) -> dict:
        """Plain-dict dump of every registry series (see
        ``MetricsRegistry.snapshot``); the example service and benchmark
        reports print from this instead of hand-rolled counters."""
        return self.obs.registry.snapshot()

    def close(self) -> None:
        """Finish queued/in-flight work, stop the driver, close the backend.

        Idempotent and safe with work still queued: the driver loop keeps
        serving until both its queue and its active set are empty, THEN
        exits; only afterwards is the backend shut down.  ``submit`` raises
        after close."""
        with self._new:
            already = self._closed
            self._closed = True
            driver, self._driver = self._driver, None
            self._new.notify_all()
        if driver is not None:
            driver.join(timeout=600.0)
        if not already:
            if self.stage is not None:
                self.stage.close()
            if self.backend is not None:
                self.backend.close()
            if self.router is not None:
                for be in self.router.backends.values():
                    if be is not self.backend:
                        be.close()

    def __enter__(self) -> "SummarizationEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ internals

    def _enqueue_batch(self, requests: Sequence, seed: int
                       ) -> List[ResponseFuture]:
        """Admit + enqueue a whole batch ATOMICALLY: the driver adopts all of
        it in one round, so the batch's jobs pack into shared drains exactly
        like the legacy lockstep loop (per-request enqueueing would let the
        driver race ahead and fragment the first rounds' bins)."""
        base = prng.key(seed)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            seen: set = set()
            resolved = []
            for req in requests:
                rid = req.request_id
                if rid <= 0 or rid in seen or self.admission.is_active(rid):
                    rid = self._next_rid_locked(seen)
                seen.add(rid)
                if rid != req.request_id:
                    req = dataclasses.replace(req, request_id=rid)
                resolved.append(req)
        works: List[_Work] = []
        try:
            for req in resolved:
                works.append(
                    self._admit_work(req, prng.fold_in(base, req.request_id))
                )
        except BaseException:
            for work in works:  # released admitted-but-never-queued work
                self.admission.on_done(work.req.request_id)
            raise
        self._enqueue_works(works)
        return [w.future for w in works]

    def _enqueue(self, req, key) -> ResponseFuture:
        work = self._admit_work(req, key)
        self._enqueue_works([work])
        return work.future

    def _next_rid_locked(self, taken: Sequence[int] = ()) -> int:
        """Next engine-assigned request id (caller holds ``self._lock``).

        Skips ids in ``taken`` (the batch being resolved) AND ids of
        admitted-but-unfinished requests -- a caller-provided explicit batch
        id never advances the counter, so without the skip a later
        ``submit()`` could mint an id colliding with live traffic and corrupt
        the admission depth accounting."""
        while True:
            self._counter += 1
            rid = self._counter
            if rid not in taken and not self.admission.is_active(rid):
                return rid

    def _to_selection(self, req) -> SelectionRequest:
        """Canonicalize a request: legacy :class:`SummarizeRequest` becomes
        the equivalent centroid-relevance :class:`SelectionRequest` (same
        sentence split, same engine-level ``lam`` -- the exact ops of the
        pre-redesign path, so selections are bit-identical)."""
        if isinstance(req, SelectionRequest):
            return req
        return SelectionRequest(
            items=split_sentences(req.text),
            kofn=KofnSpec(m=req.m, lam=self.lam),
            workload="summarize",
            request_id=req.request_id,
            priority=req.priority,
            deadline=req.deadline,
        )

    def _admit_work(self, req, key) -> _Work:
        sel = self._to_selection(req)
        try:
            ticket = self._admit_ticket(sel)
        except EngineOverloadedError as exc:
            # shed="evict-lowest": at the depth cap, try to evict one queued
            # request that ranks strictly below the newcomer, then re-admit.
            if (getattr(exc, "reason", "") != "depth"
                    or self.admission.config.shed != "evict-lowest"
                    or not self._evict_for(sel.priority, sel.deadline)):
                raise
            ticket = self._admit_ticket(sel)
        return _Work(req=sel, key=key, reads=ticket.reads,
                     degraded=ticket.degraded,
                     future=ResponseFuture(self, sel.request_id),
                     backend_name=ticket.backend,
                     predicted_seconds=ticket.predicted_seconds,
                     sim_at_admit=ticket.sim_at_admit)

    def _admit_ticket(self, sel: SelectionRequest):
        extra = 0.0
        if self.stage is not None and sel.deadline is not None:
            # The encode stage runs before the first solve job can launch:
            # its EWMA estimate spends deadline slack at admission (an
            # approximation -- encode wall seconds against the sim clock).
            texts = encode_texts(sel.kofn, sel.items)
            if texts:
                n_tok = 1 + sum(len(t.encode("utf-8")) + 1 for t in texts)
                extra = self.stage.estimate_seconds(n_tok,
                                                    workload=sel.workload)
        return self.admission.admit(
            sel.request_id,
            self._estimate_job_lanes(len(sel.items), sel.kofn.m),
            self.cfg.reads,
            sel.deadline,
            self.backend.sim_now() if self.backend is not None else 0.0,
            priority=sel.priority,
            steps=self.cfg.steps,
            iterations=self.cfg.iterations,
            extra_seconds=extra,
        )

    def _evict_for(self, priority: int, deadline: Optional[float]) -> bool:
        """Evict the most-evictable QUEUED request that ranks strictly below
        a ``(priority, deadline)`` newcomer: lowest priority first, slackest
        deadline (latest, with none-at-all slackest) as the tie-break.  The
        victim's future fails with :class:`RequestEvicted` and its admitted
        work is released (counted in ``AdmissionStats.evicted``).  Returns
        False when nothing queued ranks below the newcomer -- the newcomer
        then sheds exactly as under ``shed="reject-new"``."""
        def rank(prio, dl):  # greater tuple = more evictable
            return (-prio, math.inf if dl is None else dl)

        mine = rank(priority, deadline)
        with self._new:
            victim_i = None
            victim_rank = mine
            for i, w in enumerate(self._queue):
                r = rank(w.req.priority, w.req.deadline)
                if r > victim_rank:
                    victim_i, victim_rank = i, r
            if victim_i is None:
                return False
            victim = self._queue.pop(victim_i)
        self.admission.note_eviction(victim.req.request_id)
        victim.future._finish(None, RequestEvicted(
            f"request {victim.req.request_id} (priority "
            f"{victim.req.priority}) was evicted from the queue to admit a "
            f"higher-ranked request at the depth cap"
        ))
        return True

    def _enqueue_works(self, works: List[_Work]) -> None:
        with self._new:
            if self._closed:
                for work in works:
                    self.admission.on_done(work.req.request_id)
                raise RuntimeError("engine is closed")
            if self.obs.tracer.enabled:
                t = self.obs.tracer.now()
                for work in works:
                    work.t_enqueued = t
            self._queue.extend(works)
            if self._driver is None:
                self._driver = threading.Thread(
                    target=self._drive, name="summarize-engine-drive",
                    daemon=True,
                )
                self._driver.start()
            self._new.notify_all()

    def _estimate_job_lanes(self, n_sents: int, m: int) -> List[int]:
        """Planned solve-job spin counts for admission's packing estimate.

        One Ising spin per sentence; an oversized request decomposes into
        p-sentence windows, each solve removing ``p - q`` sentences, plus the
        final window.  Every window costs ``cfg.iterations`` solve jobs.
        """
        if n_sents <= m:
            return []
        cfg = self.cfg
        max_spins = COBI_MAX_SPINS if cfg.solver == "cobi" else cfg.p
        if n_sents > max_spins or (cfg.decompose and n_sents > cfg.p):
            windows = 1 + math.ceil(max(0, n_sents - cfg.p) / (cfg.p - cfg.q))
            return [cfg.p] * (windows * cfg.iterations)
        return [n_sents] * cfg.iterations

    def _cancel(self, future: ResponseFuture) -> bool:
        with self._new:
            for i, work in enumerate(self._queue):
                if work.future is future:
                    del self._queue[i]
                    break
            else:
                return False
        self.admission.on_done(future.request_id)
        future._finish(None, RequestCancelled(
            f"request {future.request_id} was cancelled before serving"
        ))
        return True

    def _drive(self) -> None:
        """Driver loop: adopt queued requests, step every active generator
        once per round, supply the manual-policy round barrier, resolve
        futures.  Runs until the engine is closed AND no work remains."""
        active: List[tuple] = []  # (generator, work)
        tracer = self.obs.tracer
        while True:
            with self._new:
                while not self._queue and not active and not self._closed:
                    self._new.wait()
                if self._closed and not self._queue and not active:
                    return
                batch, self._queue = self._queue, []
            t_round0 = tracer.now()
            self._round_encode_wait = 0.0
            self._round_drains = []
            for work in batch:
                active.append((self._iter_one(work), work))
            stepped = len(active)
            still: List[tuple] = []
            for gen, work in active:
                try:
                    next(gen)
                    still.append((gen, work))
                except StopIteration as done:
                    self._resolve(work, done.value)
                except BaseException as exc:  # noqa: BLE001 -- fail request
                    self._resolve(work, None, exc)
            active = still
            if active and self.stage is not None:
                # The encoder stage is always self-draining; the hint tells
                # it this round's submissions are over so a lingering batch
                # window closes (non-blocking, no-op with linger=0).
                try:
                    self.stage.flush_hint()
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            if active and self.backend is not None:
                # With a router, EVERY routable backend gets its round
                # barrier -- spilled jobs must resolve too (the host pool's
                # flush_hint is a no-op; it self-drains).
                barriers = ([self.backend] if self.router is None
                            else list(self.router.backends.values()))
                for be in barriers:
                    try:
                        if be.policy == "manual":
                            # Manual policy: the driver IS the round barrier
                            # -- one drain packs every active request's jobs.
                            self._drain(be)
                        else:
                            # Self-draining backends: tell the drive loop
                            # this round's burst is over (non-blocking);
                            # generators block on their futures.
                            be.flush_hint()
                    except Exception:  # noqa: BLE001
                        # The backend already failed the affected job
                        # futures; the corresponding generators surface the
                        # error on their next step.  The driver must outlive
                        # it.
                        traceback.print_exc()
            self._end_round(t_round0, adopted=len(batch),
                            active=stepped, finished=stepped - len(active))

    def _end_round(self, t_round0: float, **attrs) -> None:
        """Meter one driver round: its encode polling, and its wall seconds,
        exactly its ``engine.round`` span's t1 - t0.  The round and its
        drains are recorded whole at its end (``emit_span``): a round
        outlives the futures it resolves, and a span still open then would
        read as unclosed to a caller that wakes on them."""
        tracer = self.obs.tracer
        t1 = tracer.now()
        wait = self._round_encode_wait
        if wait:
            self._m_encode_wait.inc(wait)
        self._m_driver_busy.inc(t1 - t_round0)
        if tracer.enabled:
            round_id = tracer.emit_span("engine.round", track="engine",
                                        t0=t_round0, t1=t1,
                                        encode_wait_s=wait, **attrs)
            for d0, d1 in self._round_drains:
                tracer.emit_span("engine.drain", parent=round_id,
                                 track="engine", t0=d0, t1=d1)

    def _drain(self, backend) -> None:
        """One manual round barrier, its window kept for ``engine.drain``."""
        tracer = self.obs.tracer
        t0 = tracer.now()
        try:
            backend.drain()
        finally:
            self._round_drains.append((t0, tracer.now()))

    def _resolve(self, work: _Work, response: Optional[SummarizeResponse],
                 error: Optional[BaseException] = None) -> None:
        tracer = self.obs.tracer
        t0 = tracer.now() if work.span else 0.0
        # Realized completion feeds admission's estimate-error tracking, but
        # only on the primary backend's clock -- a pool-served request's
        # sim_completed lives on the pool's wall clock and would poison the
        # error distribution.
        realized = None
        if (response is not None and response.sim_completed > 0.0
                and (self.router is None
                     or work.backend_name == self.router.primary)):
            realized = response.sim_completed
        self.admission.on_done(work.req.request_id, realized=realized)
        if response is not None:
            response.degraded = work.degraded
        if work.span:
            outcome = "ok" if error is None else type(error).__name__
            work.span.end(
                sim_t1=(self.backend.sim_now() if self.backend is not None
                        else None),
                outcome=outcome,
                realized_seconds=(response.realized_seconds
                                  if response is not None else None),
            )
        if isinstance(error, RequestFailed) and not error.flight_log:
            # Post-mortem payload: the request's last-N trace records.  The
            # root span was ended above, so its terminal record is in the
            # ring by the time the dump is cut.
            error.flight_log = tuple(
                self.obs.recorder.dump(work.req.request_id))
        work.future._finish(response, error)
        if work.span:
            # Recorded whole once the future is finished (see _end_round).
            tracer.emit_span("engine.resolve", trace_id=work.span.trace_id,
                             parent=work.span.span_id, track="engine",
                             t0=t0, t1=tracer.now())

    def _iter_one(self, work: _Work):
        """Generator serving one request; yields once per backend round."""
        req = work.req
        t0 = time.perf_counter()
        tracer = self.obs.tracer
        # Root span per request.  Opened here -- at driver adoption -- not at
        # admission, so rejected/cancelled/evicted requests never open a span
        # (no unclosed leak paths); ended in _resolve, the single terminal
        # path for adopted work.  Phase spans below use emit_span (atomic
        # open+close), which can never leak even when this generator dies.
        span = tracer.span(
            "request", trace_id=req.request_id, track="engine",
            sim_t0=(self.backend.sim_now() if self.backend is not None
                    else None),
            workload=req.workload, n_items=len(req.items),
            priority=req.priority, backend=work.backend_name,
            degraded=work.degraded, reads=work.reads,
        )
        tracer.register_root(req.request_id, span)
        work.span = span
        if work.t_enqueued is not None:
            tracer.emit_span(
                "request.queue", trace_id=req.request_id,
                parent=span.span_id, track="engine",
                t0=work.t_enqueued, t1=span.t0,
            )
        items = req.items
        m = req.kofn.m
        cfg = self.cfg
        if work.reads != cfg.reads:
            cfg = dataclasses.replace(cfg, reads=work.reads)
        if len(items) <= m:
            return SelectionResponse(
                req.request_id, list(items), np.ones(len(items), np.int32),
                0.0, None, time.perf_counter() - t0, 0.0, 0.0, 0,
                reads_used=cfg.reads, workload=req.workload,
            )
        # ---- encode stage: the request's texts (items, plus the query row
        # for query relevance; empty when mu/beta are both given) ----
        texts = encode_texts(req.kofn, items)
        enc_seconds = 0.0
        enc_bytes = 0
        enc_power = 0.0
        t_enc_w0 = tracer.now() if tracer.enabled else 0.0
        if not texts:
            e = None
        elif self.stage is not None:
            qfut = None
            if req.kofn.relevance == "query" and len(texts) >= 2:
                # Split the query (last row of encode_texts' output) into
                # its own solo job: the stage's causal packing would
                # entangle a combined query row with this request's items,
                # while a solo row is a pure function of (text, params) and
                # so cacheable across requests (submit_query's LRU).
                qfut = self.stage.submit_query(texts[-1],
                                               tag=req.request_id)
                efut = self.stage.submit(texts[:-1], tag=req.request_id,
                                         workload=req.workload)
            else:
                efut = self.stage.submit(texts, tag=req.request_id,
                                         workload=req.workload)
            # Yield to the driver while the stage batches and runs the
            # encode: other requests' Ising rounds keep draining, so encode
            # of this request overlaps anneal of its neighbours.  The short
            # bounded wait keeps the manual-policy round loop from
            # hot-spinning without stalling it a full encode.  The seconds
            # spent inside the waits are the driver's encode polling.
            while True:
                t_wait = time.perf_counter()
                ready = efut.wait(0.002) and (qfut is None
                                              or qfut.wait(0.002))
                self._round_encode_wait += time.perf_counter() - t_wait
                if ready:
                    break
                yield
            e = efut.result()
            rcpt = efut.receipt()
            enc_seconds = rcpt.encoder_seconds
            enc_bytes = rcpt.bytes_h2d + rcpt.bytes_d2h
            if qfut is not None:
                # Re-append the query row LAST, preserving the
                # ``problem_from_embeddings`` contract (query = e[-1]).
                e = torch.cat([e, qfut.result().to(e.device)], dim=0)
                qrcpt = qfut.receipt()
                enc_seconds += qrcpt.encoder_seconds
                enc_bytes += qrcpt.bytes_h2d + qrcpt.bytes_d2h
            enc_power = self.stage.power_w
        else:
            t_enc = time.perf_counter()
            e = self.encoder.encode(texts)
            enc_seconds = time.perf_counter() - t_enc
            enc_bytes = e.numel() * e.element_size()
            enc_power = self._hardware().host_power_w
        if tracer.enabled and texts:
            # Phase marker only: the meters live on the stage's encode.job
            # spans (receipt values); summing THOSE is what conservation
            # tests check, so this span carries no meter-named attributes.
            tracer.emit_span(
                "request.encode", trace_id=req.request_id,
                parent=span.ctx.span_id, track="engine",
                t0=t_enc_w0, t1=tracer.now(),
                n_texts=len(texts), staged=self.stage is not None,
            )
        with span.child("engine.scores"):
            problem = problem_from_embeddings(req.kofn, items, e,
                                              device=self.device)
        if problem.n > COBI_MAX_SPINS and not cfg.decompose:
            cfg = dataclasses.replace(cfg, decompose=True)
        backend_used = None
        realized_seconds = 0.0
        eff_deadline = req.deadline
        recovery = None
        if self.backend is not None:
            backend = self.backend
            route_hook = None
            if self.router is not None:
                name = work.backend_name or self.router.primary
                backend = self.router.backends[name]
                backend_used = name
                if req.deadline is not None and backend is not self.backend:
                    # Backends keep independent clocks (farm sim clock vs
                    # pool wall clock): carry the deadline over as remaining
                    # slack from the primary clock at admission.
                    eff_deadline = (backend.sim_now()
                                    + (req.deadline - work.sim_at_admit))
                if cfg.decompose:
                    route_hook = self._window_route(work, cfg)
            recovery = self._recovery_for(backend, eff_deadline, cfg,
                                          req.request_id)
            t_serve0 = backend.sim_now()
            t_solve_w0 = tracer.now() if tracer.enabled else 0.0
            report = yield from iter_solve_es(
                problem, work.key, cfg, backend=backend,
                priority=req.priority, deadline=eff_deadline,
                tag=req.request_id, route=route_hook, recovery=recovery,
                span=span,
            )
            if self.router is not None:
                if report.backend_jobs:  # window-routed: dominant backend
                    backend_used = max(report.backend_jobs,
                                       key=report.backend_jobs.get)
                if report.sim_completed > 0.0:
                    realized_seconds = max(report.sim_completed - t_serve0,
                                           0.0)
                if report.windows:
                    # Per-window attribution: every window's realized
                    # receipts calibrate the backend that actually ran it,
                    # so spilled windows update the pool's EWMA instead of
                    # being dropped when the dominant backend differs from
                    # the admission ticket.
                    for w in report.windows:
                        if (w.backend is not None
                                and w.realized_seconds > 0.0
                                and w.predicted_seconds > 0.0):
                            self.router.observe(
                                w.backend,
                                predicted_seconds=w.predicted_seconds,
                                realized_seconds=w.realized_seconds,
                                realized_energy=w.realized_energy,
                            )
                elif (realized_seconds > 0.0 and work.predicted_seconds > 0.0
                        and backend_used == work.backend_name):
                    # Whole-request fallback (no window records): realized
                    # receipts close the loop on the ticket's backend.
                    self.router.observe(
                        backend_used,
                        predicted_seconds=work.predicted_seconds,
                        realized_seconds=realized_seconds,
                    )
            if tracer.enabled:
                tracer.emit_span(
                    "request.solve", trace_id=req.request_id,
                    parent=span.ctx.span_id, track="engine",
                    t0=t_solve_w0, t1=tracer.now(),
                    sim_t0=t_serve0,
                    sim_t1=(report.sim_completed
                            if report.sim_completed > 0.0 else None),
                    backend=backend_used, windows=len(report.windows),
                    solver_invocations=report.solver_invocations,
                )
        else:
            t_solve_w0 = tracer.now() if tracer.enabled else 0.0
            report = solve_es(problem, work.key, cfg, device=self.device)
            if tracer.enabled:
                tracer.emit_span(
                    "request.solve", trace_id=req.request_id,
                    parent=span.ctx.span_id, track="engine",
                    t0=t_solve_w0, t1=tracer.now(),
                    solver_invocations=report.solver_invocations,
                )
        hw = self._hardware()
        host_eval = report.solver_invocations * cfg.reads * hw.host_eval_seconds
        metered = report.chip_seconds + report.host_seconds
        if metered > 0.0:  # receipts: lane-shared chip time / worker wall time
            t_solver = metered + host_eval
            e_solver = report.chip_energy_joules + host_eval * hw.host_power_w
        else:
            solves = report.solver_invocations * cfg.reads
            t_solver = solves * hw.seconds_per_solve + host_eval
            e_solver = (
                solves * hw.seconds_per_solve * hw.solver_power_w
                + host_eval * hw.host_power_w
            )
        normalized = None
        if self.score:
            normalized = float(
                normalized_objective(report.objective, reference_bounds(problem))
            )
        deadline_met = None
        if eff_deadline is not None and report.sim_completed > 0.0:
            deadline_met = report.sim_completed <= eff_deadline
        selected = [items[i] for i in np.nonzero(report.selection)[0]]
        return SelectionResponse(
            request_id=req.request_id,
            selected=selected,
            selection=report.selection,
            objective=report.objective,
            normalized=normalized,
            wall_seconds=time.perf_counter() - t0,
            projected_solver_seconds=t_solver,
            projected_energy_joules=e_solver,
            solver_invocations=report.solver_invocations,
            bytes_h2d=report.bytes_h2d,
            bytes_d2h=report.bytes_d2h,
            sim_completed=report.sim_completed,
            deadline_met=deadline_met,
            reads_used=cfg.reads,
            backend_used=backend_used,
            predicted_seconds=work.predicted_seconds,
            realized_seconds=realized_seconds,
            retries=recovery.retries if recovery is not None else 0,
            faults_seen=report.faults_seen + (
                recovery.faults_seen if recovery is not None else 0),
            failed_over=bool(recovery.failed_over) if recovery is not None
            else False,
            workload=req.workload,
            encoder_seconds=enc_seconds,
            encoder_bytes=enc_bytes,
            encoder_joules=enc_seconds * enc_power,
        )

    def _recovery_for(self, backend, eff_deadline: Optional[float],
                      cfg: SolveConfig, request_id: int
                      ) -> Optional[RecoveryContext]:
        """Per-request recovery context (None when no retry policy is set).

        The failover target is the router's OTHER backend (the existing
        spill path); without a router there is nowhere to fail over and the
        context retries-then-fails-typed."""
        if self.retry is None:
            return None
        failover_be, failover_name = None, None
        if self.router is not None:
            for name, be in self.router.backends.items():
                if be is not backend:
                    failover_be, failover_name = be, name
                    break
        on_failover = None
        if failover_name is not None:
            router, fname = self.router, failover_name
            on_failover = lambda: router.note_failover(fname)  # noqa: E731
        hw = self._hardware()
        return RecoveryContext(
            self.retry,
            clock=backend.sim_now,
            deadline=eff_deadline,
            failover=failover_be,
            failover_name=failover_name,
            on_failover=on_failover,
            est_job_seconds=cfg.reads * hw.seconds_per_solve,
            request_id=request_id,
            obs=self.obs,
        )

    def _window_route(self, work: _Work, cfg: SolveConfig):
        """Per-decomposition-window route hook for :func:`iter_solve_es`.

        Re-decides each window against LIVE capacity hints (the admission
        decision vouched for the request; windows may still spill off an
        overloaded farm mid-request).  Converts the request deadline to the
        winning backend's clock via remaining primary-clock slack."""
        req = work.req

        def route(n: int, reads: int):
            slack = (None if req.deadline is None
                     else req.deadline - self.backend.sim_now())
            name, be, predicted = self.router.route_window_info(
                n, reads, steps=cfg.steps, iterations=cfg.iterations,
                deadline_slack=slack, tag=req.request_id,
            )
            deadline = req.deadline
            if deadline is not None and be is not self.backend:
                deadline = be.sim_now() + max(slack, 0.0)
            return name, be, deadline, predicted

        return route
