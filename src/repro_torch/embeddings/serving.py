"""Batched backbone-encoder serving stage: continuous batching in front of
the Ising farm.

Twin of ``repro.embeddings.serving``.  The neural encoder (``models/``:
``configs/sbert_paper.py``, or any text-only family: dense, moe, hybrid,
ssm; optionally the flash-attention kernel via
``cfg.attn_impl="flash"``) sits behind the same submit->future discipline
the COBI farm uses, as a SECOND pipeline stage whose drains run
concurrently with Ising drains:

  * ``submit(texts)`` tokenizes into a power-of-two padded-length bucket
    (chosen from the job's OWN token count -- results never depend on
    batch-mates) and returns an :class:`EncodeFuture` immediately.
  * A background drain thread grabs everything queued, groups jobs by
    length bucket, pads the batch and segment-count dimensions to
    power-of-two buckets (the farm's ``BATCH_BUCKET``/``REPLICA_BUCKET``
    discipline: a handful of shapes), and runs ONE ``embed_sentences``
    pass per group.
  * Padding is inert by construction: the backbone is causal, so trailing
    PAD tokens cannot affect real-token hidden states (an MoE backbone
    routes each row's tokens in order, so trailing PADs take the last
    capacity slots, but its capacity grows with the padded length: its
    embeddings depend on the length bucket, as the reference's do); batch
    rows and pooling one-hot columns are independent per row/segment.  Same
    sentences => identical embeddings (and identical mu/beta) regardless
    of batch composition -- tested.
  * Each job's :class:`EncodeReceipt` meters encoder wall seconds (the
    pass's wall time up to a device synchronise, attributed by token
    share), h2d/d2h bytes, and the stage clock -- the encoder's line on the
    request bill, next to chip time.
  * ``prewarm()`` runs each (batch, length, segment) shape of a lattice
    once on the drain thread, so the first open-loop burst finds the kernel
    library built and the matrix-product libraries warm in the thread that
    runs the passes (cuBLAS keeps its handles and workspaces per thread).

``encode(texts)`` is the synchronous face (submit + wait), making a stage
usable anywhere a plain encoder is accepted.  ``submit_query(text)`` is the
cached face: rerank traffic re-asks the same query against many candidate
sets, so the stage keeps a small text-hash-keyed LRU of SOLO query
embeddings (solo because the causal packing above makes a combined-encode
query row depend on its batch-mates), invalidated when ``params`` is
swapped; hit/miss counters surface through ``cache_stats()`` and the
engine's ``stats()["encoder_cache"]``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import embed_sentences, init_params
from repro_torch.obs import Observability
from repro_torch.solvers.base import AwaitableFuture

# Power-of-two padding bases (the farm's BATCH_BUCKET/REPLICA_BUCKET idiom):
# batches pad to 4,8,16..., segment counts to 8,16,..., token lengths to
# 64,128,... so background drains stay within a handful of shapes.
BATCH_BUCKET = 4
SEG_BUCKET = 8
MIN_LEN_BUCKET = 64

# Query-embedding LRU capacity: retrieval/rerank traffic re-asks the same
# query against many candidate sets, so the solo query row is the one
# embedding that is genuinely reusable across requests.
QUERY_CACHE_SIZE = 256


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bucket(n: int, base: int) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def _embed_batch(cfg, params, tokens, segs, n_segments):
    """Unit-norm sentence embeddings (B, n_segments, d) of one padded batch."""
    with torch.no_grad():
        emb = embed_sentences(cfg, params, tokens, segs, n_segments)
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.clamp(norm, min=1e-9)


@dataclasses.dataclass(frozen=True)
class EncodeReceipt:
    """Per-job encoder bill, the counterpart of the farm's ``JobReceipt``."""

    job_id: int
    tag: Optional[int]
    encoder_seconds: float  # pass wall time, attributed by token share
    bytes_h2d: int  # tokens + segment ids shipped (this job's padded rows)
    bytes_d2h: int  # embeddings returned (real segments only)
    batch_jobs: int  # jobs sharing the launch that served this one
    padded_len: int  # length bucket the job encoded at
    sim_completed: float  # stage clock (seconds since stage start) at finish


class EncodeFuture(AwaitableFuture):
    """Handle to one submitted encode job; ``result()`` -> (n, d) unit-norm
    embeddings, ``receipt()`` -> :class:`EncodeReceipt` once done."""

    __slots__ = ("job_id", "_receipt")

    def __init__(self, job_id: int):
        super().__init__()
        self.job_id = job_id
        self._receipt: Optional[EncodeReceipt] = None

    def _describe(self) -> str:
        return f"encode job {self.job_id}"

    def receipt(self, timeout: Optional[float] = None) -> EncodeReceipt:
        self._wait(timeout)
        return self._receipt


@dataclasses.dataclass
class _EncodeJob:
    job_id: int
    n_items: int
    tokens: np.ndarray  # (L,) int32, padded to the length bucket
    segs: np.ndarray  # (L,) int32, -1 on pad/specials
    n_tokens: int  # real (non-PAD) token count, for share attribution
    future: EncodeFuture
    tag: Optional[int]
    # Workload label ("selection", "multidoc", ...): keys the per-workload
    # sec/token estimate -- multidoc items are systematically longer, so one
    # global EWMA under-charges them at admission.
    workload: Optional[str] = None


@dataclasses.dataclass
class EncoderStats:
    jobs: int = 0
    launches: int = 0  # embed passes (one per (bucket) group)
    drains: int = 0  # drain-thread wakeups that executed work
    tokens: int = 0  # real tokens encoded
    busy_seconds: float = 0.0  # wall time inside embed passes
    mean_batch: float = 0.0  # jobs per launch
    sec_per_token: float = 0.0  # EWMA, feeds admission's encode estimate
    prewarmed: int = 0  # shapes run by prewarm()


class EncoderStage:
    """Continuous-batching serving path for a backbone sentence encoder.

    ``policy`` mirrors the backend protocol the serving engine's drive loop speaks:
    the stage is always self-draining (its own thread supplies the drain),
    so the drive loop only ever calls :meth:`flush_hint`.
    """

    policy = "background"

    def __init__(self, cfg, params, *, max_len: int = 1024,
                 power_w: float = 45.0, linger: float = 0.0,
                 attn_impl: Optional[str] = None, obs=None, device=None):
        """``cfg``/``params`` are the backbone config + model
        (:func:`EncoderStage.tiny` builds the CPU-smoke pair).  ``power_w``
        prices encoder seconds into joules on receipts; ``linger`` is an
        optional batching debounce (seconds) before a drain grabs the
        queue; ``attn_impl`` overrides ``cfg.attn_impl`` (e.g. ``"flash"``
        to route through the flash-attention kernel).  The stage runs on
        ``device`` (``None``: the card; raises without one) and moves the
        model there."""
        if cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"EncoderStage encodes text alone; {cfg.name} ({cfg.family}) needs frontend "
                f"embeddings, which the stage has no way to pass (as in the reference): call "
                f"models.embed_sentences(..., frontend=...) instead")
        if attn_impl is not None:
            cfg = cfg.replace(attn_impl=attn_impl)
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params.to(self.device)
        self.tok = ByteTokenizer()
        self.max_len = max_len
        self.power_w = power_w
        self.linger = linger
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_EncodeJob] = []
        self._inflight: List[EncodeFuture] = []
        # prewarm() requests: (shapes, future), run by the drive thread.
        self._warm: List[Tuple[List[Tuple[int, int, int]], AwaitableFuture]] = []
        self._drive_thread: Optional[threading.Thread] = None
        self._closed = False
        self._flush = False
        self._job_counter = 0
        self._ewma_spt = 0.0  # global EWMA seconds per real token (fallback)
        self.obs = None
        self.attach_obs(obs if obs is not None else Observability.disabled())
        # Wall-clock (t0, t1) of each launch -- intersect with the farm's
        # busy intervals to measure encode-vs-anneal overlap.
        self._busy: deque = deque(maxlen=4096)
        # Query-embedding LRU (see submit_query): text-hash -> (1, d) row,
        # valid only for the params object it was computed with.  The
        # in-flight table coalesces concurrent same-query requests (one
        # engine round submits a whole batch before any encode finishes).
        self._query_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._query_inflight: Dict[str, "EncodeFuture"] = {}
        self._query_cache_cap = QUERY_CACHE_SIZE
        self._query_hits = 0
        self._query_misses = 0
        self._params_token = id(params)

    def attach_obs(self, obs) -> None:
        """Bind (or rebind) the stage to an ``Observability`` bundle.

        Leaf stages start on a private disabled bundle; the serving engine
        rebinds them to its shared one.  Counter values carry over so a
        rebind never loses history."""
        carry = None
        if self.obs is not None:
            carry = {
                "jobs": self._m_jobs.value,
                "launches": self._m_launches.value,
                "drains": self._m_drains.value,
                "tokens": self._m_tokens.value,
                "busy": self._m_busy.value,
                "prewarmed": self._m_prewarmed.value,
            }
        self.obs = obs
        reg = obs.registry
        self._m_jobs = reg.counter(
            "encoder_jobs_total", "encode jobs completed")
        self._m_launches = reg.counter(
            "encoder_launches_total", "embed passes")
        self._m_drains = reg.counter(
            "encoder_drains_total", "drain wakeups that executed work")
        self._m_tokens = reg.counter(
            "encoder_tokens_total", "real (non-PAD) tokens encoded")
        self._m_busy = reg.counter(
            "encoder_busy_seconds_total", "wall seconds inside embed passes")
        self._m_prewarmed = reg.counter(
            "encoder_prewarmed_total", "shapes run by prewarm()")
        # Per-workload sec/token: admission reads child.ewma for its encode
        # estimate (multidoc items are systematically longer than selection
        # items, so one global EWMA under-charges them).
        self._m_spt = reg.histogram(
            "encoder_sec_per_token",
            "per-launch encode seconds per real token",
            labels=("workload",))
        if carry:
            self._m_jobs.inc(carry["jobs"])
            self._m_launches.inc(carry["launches"])
            self._m_drains.inc(carry["drains"])
            self._m_tokens.inc(carry["tokens"])
            self._m_busy.inc(carry["busy"])
            self._m_prewarmed.inc(carry["prewarmed"])

    @classmethod
    def tiny(cls, seed: int = 0, **kwargs) -> "EncoderStage":
        """CPU-smoke stage: the SBERT-paper config ``reduced()`` with
        freshly initialized weights (production passes trained params), on
        ``kwargs["device"]`` (``None``: the card)."""
        from repro_torch.configs.base import get_config

        cfg = get_config("sbert-paper").reduced()
        params = init_params(cfg, seed, device=kwargs.get("device"))
        kwargs.setdefault("max_len", cfg.max_seq_len)
        return cls(cfg, params, **kwargs)

    # ------------------------------------------------------------------ API

    def submit(self, texts: Sequence[str], *, tag: Optional[int] = None,
               workload: Optional[str] = None) -> EncodeFuture:
        """Enqueue one encode job; returns immediately.

        The job's length bucket is a pure function of its own texts, so
        its embeddings never depend on what else is queued.  ``workload``
        labels the job's sec/token observation (see
        :meth:`estimate_seconds`)."""
        texts = list(texts)
        with self._lock:
            if self._closed:
                raise RuntimeError("encoder stage is closed")
            self._job_counter += 1
            job_id = self._job_counter
        fut = EncodeFuture(job_id)
        if not texts:
            fut._receipt = EncodeReceipt(job_id, tag, 0.0, 0, 0, 0, 0,
                                         self.sim_now())
            fut._finish(torch.zeros((0, self.cfg.d_model), dtype=torch.float32,
                                    device=self.device), None)
            return fut
        n_tok = min(1 + sum(len(t.encode("utf-8")) + 1 for t in texts),
                    self.max_len)
        length = min(_bucket(n_tok, MIN_LEN_BUCKET), self.max_len)
        tokens, segs = self.tok.encode_sentences(texts, length)
        job = _EncodeJob(job_id, len(texts), tokens, segs, n_tok, fut, tag,
                         workload)
        with self._cond:
            self._queue.append(job)
            self._start_drive()
            self._cond.notify_all()
        return fut

    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        """Synchronous face: submit + wait.  Makes a stage usable anywhere
        a plain ``encoder.encode(texts)`` is accepted."""
        return self.submit(texts).result()

    def submit_query(self, text: str, *, tag: Optional[int] = None
                     ) -> EncodeFuture:
        """Cached solo encode of one query string; same future surface as
        :meth:`submit`.

        The query is always encoded ALONE: the backbone is causal and
        :meth:`submit` packs a job's texts into one token row, so a query
        row from a combined encode depends on whatever items preceded it --
        uncacheable across requests.  A standalone query embedding is a
        pure function of (text, params), so it lives in a small LRU keyed
        by the text hash; a params swap invalidates the whole cache.  A hit
        resolves immediately with a zero-cost receipt and is bit-identical
        to the miss that populated it (same tensor).  Concurrent requests
        for the SAME query coalesce onto one in-flight encode (the engine
        submits a whole batch round before any encode finishes)."""
        key = hashlib.blake2b(text.encode("utf-8"),
                              digest_size=16).hexdigest()
        with self._lock:
            if self._closed:
                raise RuntimeError("encoder stage is closed")
            if id(self.params) != self._params_token:
                # Params swap: everything cached or racing was computed
                # with the old weights -- drop it all.
                self._query_cache.clear()
                self._query_inflight.clear()
                self._params_token = id(self.params)
            token = self._params_token
            cached = self._query_cache.get(key)
            inflight = None if cached is not None \
                else self._query_inflight.get(key)
            if cached is not None or inflight is not None:
                if cached is not None:
                    self._query_cache.move_to_end(key)
                self._query_hits += 1
                self._job_counter += 1
                job_id = self._job_counter
            else:
                self._query_misses += 1
        if cached is not None:
            fut = EncodeFuture(job_id)
            fut._receipt = EncodeReceipt(
                job_id, tag, 0.0, 0, _nbytes(cached), 0, 0,
                self.sim_now(),
            )
            fut._finish(cached, None)
            return fut
        if inflight is not None:
            # Piggyback on the racing encode: own job id + zero-cost
            # receipt (the first submitter's receipt bills the launch).
            fut = EncodeFuture(job_id)

            def _chain(f: EncodeFuture, fut: EncodeFuture = fut,
                       tag: Optional[int] = tag) -> None:
                err = f.exception(0.0)
                emb = None if err is not None else f.result(0.0)
                nbytes = 0 if emb is None else _nbytes(emb)
                fut._receipt = EncodeReceipt(fut.job_id, tag, 0.0, 0,
                                             nbytes, 0, 0, self.sim_now())
                fut._finish(emb, err)

            inflight.add_done_callback(_chain)
            return fut
        fut = self.submit([text], tag=tag)
        with self._lock:
            self._query_inflight[key] = fut

        def _fill(f: EncodeFuture, key: str = key, token: int = token
                  ) -> None:
            with self._lock:
                if self._query_inflight.get(key) is f:
                    del self._query_inflight[key]
                stale = self._params_token != token \
                    or id(self.params) != token
            try:
                emb = f.result(0.0)
            except Exception:  # noqa: BLE001 -- failed encodes aren't cached
                return
            if stale:
                return
            with self._lock:
                self._query_cache[key] = emb
                self._query_cache.move_to_end(key)
                while len(self._query_cache) > self._query_cache_cap:
                    self._query_cache.popitem(last=False)

        fut.add_done_callback(_fill)
        return fut

    def cache_stats(self) -> dict:
        """Query-LRU counters (the engine surfaces these in ``stats()``)."""
        with self._lock:
            hits, misses = self._query_hits, self._query_misses
            return {
                "hits": hits,
                "misses": misses,
                "size": len(self._query_cache),
                "capacity": self._query_cache_cap,
                "hit_rate": hits / max(hits + misses, 1),
            }

    def flush_hint(self) -> None:
        """Non-blocking nudge: the current burst is over, drain what's
        queued without waiting out the linger (the engine's round hook)."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every job submitted so far has resolved."""
        self.flush_hint()
        with self._lock:
            futures = [j.future for j in self._queue] + list(self._inflight)
        for fut in futures:
            fut.wait(timeout)

    def estimate_seconds(self, n_tokens: int,
                         workload: Optional[str] = None) -> float:
        """Predicted encode seconds for an ``n_tokens`` job; admission adds
        this to deadline-feasibility estimates.

        With a ``workload`` label the estimate reads that workload's
        sec/token EWMA from the registry histogram (populated by
        :meth:`_run_group`); an unseen workload -- or ``workload=None`` --
        falls back to the global EWMA."""
        spt = self._ewma_spt
        if workload is not None:
            child = self._m_spt.labels(workload=workload)
            if child.count:
                spt = child.ewma
        return spt * max(n_tokens, 1)

    def prewarm(self, *, lengths: Optional[Sequence[int]] = None,
                batches: Sequence[int] = (BATCH_BUCKET,),
                segments: Sequence[int] = (SEG_BUCKET,)) -> int:
        """Run each (batch, length, segments) shape of a lattice once, up
        front, on the drive thread, so the first open-loop burst finds the
        kernel library built and the matrix-product libraries warm in the
        thread that runs its passes (the farm's ``prewarm()`` idiom one
        stage earlier).  Blocks until done; returns the shapes run."""
        if lengths is None:
            lengths = []
            length = MIN_LEN_BUCKET
            while length <= min(self.max_len, 4 * MIN_LEN_BUCKET):
                lengths.append(length)
                length *= 2
        shapes = [(int(b), int(length), int(g))
                  for length in lengths for b in batches for g in segments]
        fut = AwaitableFuture()
        with self._cond:
            if self._closed:
                raise RuntimeError("encoder stage is closed")
            self._warm.append((shapes, fut))
            self._start_drive()
            self._cond.notify_all()
        fut.result()
        self._m_prewarmed.inc(len(shapes))
        return len(shapes)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Wall-clock (start, end) of recent encode launches
        (``time.monotonic`` domain, same as the farm's)."""
        with self._lock:
            return list(self._busy)

    def sim_now(self) -> float:
        return time.monotonic() - self._t0

    def stats(self) -> EncoderStats:
        """Registry view: the counters live in ``obs.registry``; this
        rebuilds the legacy :class:`EncoderStats` shape from them."""
        jobs = int(self._m_jobs.value)
        launches = int(self._m_launches.value)
        return EncoderStats(
            jobs=jobs,
            launches=launches,
            drains=int(self._m_drains.value),
            tokens=int(self._m_tokens.value),
            busy_seconds=self._m_busy.value,
            mean_batch=jobs / launches if launches else 0.0,
            sec_per_token=self._ewma_spt,
            prewarmed=int(self._m_prewarmed.value),
        )

    def close(self) -> None:
        """Finish queued work, then stop the drain thread.  Idempotent."""
        with self._cond:
            self._closed = True
            thread, self._drive_thread = self._drive_thread, None
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=60.0)

    def __enter__(self) -> "EncoderStage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ internals

    def _sync(self) -> None:
        """Wait for the card, so a wall time covers the work and not only
        its launch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_drive(self) -> None:
        """Start the drive thread if it is not running (``_cond`` held)."""
        if self._drive_thread is None:
            self._drive_thread = threading.Thread(
                target=self._drive, name="encoder-stage-drive", daemon=True)
            self._drive_thread.start()

    def _run_warm(self, shapes: List[Tuple[int, int, int]]) -> None:
        for b, length, g in shapes:
            tokens = torch.zeros((b, length), dtype=torch.int32, device=self.device)
            segs = torch.full((b, length), -1, dtype=torch.int32, device=self.device)
            _embed_batch(self.cfg, self.params, tokens, segs, g)
            self._sync()

    def _drive(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._warm and not self._closed:
                    self._cond.wait()
                warm = None
                if self._warm:
                    shapes, warm = self._warm.pop(0)
                elif not self._queue:
                    return  # closed and empty
                else:
                    if self.linger > 0.0 and not self._flush and not self._closed:
                        self._cond.wait(self.linger)
                    self._flush = False
                    jobs, self._queue = self._queue, []
                    self._inflight = [j.future for j in jobs]
            if warm is not None:
                try:
                    self._run_warm(shapes)
                    warm._finish()
                except BaseException as exc:  # noqa: BLE001 -- never strand
                    warm._finish(None, exc)
                continue
            try:
                self._run_jobs(jobs)
            except BaseException as exc:  # noqa: BLE001 -- never strand
                for job in jobs:
                    if not job.future.done():
                        job.future._finish(None, exc)
            finally:
                with self._lock:
                    self._inflight = []

    def _run_jobs(self, jobs: List[_EncodeJob]) -> None:
        self._m_drains.inc()
        groups: Dict[int, List[_EncodeJob]] = {}
        for job in jobs:
            groups.setdefault(len(job.tokens), []).append(job)
        for length in sorted(groups):
            self._run_group(length, groups[length])

    def _run_group(self, length: int, jobs: List[_EncodeJob]) -> None:
        b_pad = _bucket(len(jobs), BATCH_BUCKET)
        g_pad = _bucket(max(j.n_items for j in jobs), SEG_BUCKET)
        total_tok = sum(j.n_tokens for j in jobs)
        tracer = self.obs.tracer
        # One pass on the stage's thread, from host packing through the
        # device synchronise.
        with tracer.span("encoder.pass", track="encoder", jobs=len(jobs),
                         length=length, batch=b_pad, tokens=total_tok):
            tokens = np.zeros((b_pad, length), np.int32)
            segs = np.full((b_pad, length), -1, np.int32)
            for i, job in enumerate(jobs):
                tokens[i] = job.tokens
                segs[i] = job.segs
            t_start = time.monotonic()
            out = _embed_batch(self.cfg, self.params,
                               torch.from_numpy(tokens).to(self.device),
                               torch.from_numpy(segs).to(self.device), int(g_pad))
            self._sync()
            t_end = time.monotonic()
        wall = t_end - t_start
        spt = wall / max(total_tok, 1)
        with self._lock:
            self._busy.append((t_start, t_end))
            self._ewma_spt = (spt if self._ewma_spt == 0.0
                              else 0.7 * self._ewma_spt + 0.3 * spt)
        self._m_launches.inc()
        self._m_jobs.inc(len(jobs))
        self._m_tokens.inc(total_tok)
        self._m_busy.inc(wall)
        # Per-workload sec/token: one observation per job so a workload's
        # EWMA tracks the launches it actually rode in.
        for job in jobs:
            self._m_spt.labels(
                workload=job.workload if job.workload else "unlabeled"
            ).observe(spt)
        done = self.sim_now()
        d = int(self.cfg.d_model)
        tw1 = tracer.now() if tracer.enabled else 0.0
        for i, job in enumerate(jobs):
            emb = out[i, :job.n_items]
            receipt = EncodeReceipt(
                job_id=job.job_id,
                tag=job.tag,
                encoder_seconds=wall * (job.n_tokens / max(total_tok, 1)),
                bytes_h2d=2 * length * 4,  # this job's tokens + seg rows
                bytes_d2h=job.n_items * d * 4,
                batch_jobs=len(jobs),
                padded_len=length,
                sim_completed=done,
            )
            if tracer.enabled:
                # Receipt values verbatim; the wall window is the shared
                # launch (tracer clock), the sim window the stage clock.
                tracer.emit_span(
                    "encode.job", trace_id=job.tag,
                    parent=tracer.root_id(job.tag), track="encoder",
                    t0=tw1 - wall, t1=tw1,
                    sim_t0=done - wall, sim_t1=done,
                    job_id=job.job_id, n_items=job.n_items,
                    n_tokens=job.n_tokens, workload=job.workload,
                    encoder_seconds=receipt.encoder_seconds,
                    bytes_h2d=receipt.bytes_h2d,
                    bytes_d2h=receipt.bytes_d2h,
                    batch_jobs=receipt.batch_jobs,
                    padded_len=receipt.padded_len,
                )
            job.future._receipt = receipt
            job.future._finish(emb, None)
