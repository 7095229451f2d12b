"""Request-scoped tracing: spans, instant events, and a bounded ring buffer.

One :class:`Tracer` instance is shared by every layer of the serving stack
(engine, admission, router, encoder stage, farm scheduler, host pools,
recovery).  The design goals, in order:

* **Zero cost when disabled.**  A disabled tracer returns the module-level
  :data:`NULL_SPAN` from every entry point and appends nothing; callers on
  hot paths may additionally guard with ``if tracer.enabled:`` to skip
  attribute-dict construction.  Tracing never touches PRNG keys, instance
  data, or scheduling order, so traced and untraced runs are bit-identical.

* **Bounded memory.**  Completed spans and instant events land in one
  fixed-size ring (``collections.deque(maxlen=capacity)``); when the ring is
  full the oldest record is dropped and ``dropped`` is incremented, so a
  long-running service can leave tracing on permanently.

* **Receipts are the meters.**  Span attributes copy receipt values
  (``JobReceipt`` / ``PoolReceipt`` / ``EncodeReceipt``) verbatim at commit
  time rather than re-measuring, so span-summed chip seconds / bytes /
  joules equal the drain-level ``FarmStats`` meters bit-for-bit (tested in
  ``tests/test_obs.py``).

Correlation model: the engine opens one **root span per request** keyed by
``trace_id == request_id`` and registers it via :meth:`Tracer.register_root`.
Every receipt in the stack already carries ``tag == request_id``, so
backends emit their per-job spans with ``trace_id=tag`` and
``parent=tracer.root_id(tag)`` -- no context object needs to cross the
submit boundary.  A :class:`TraceContext` (trace id + span id) is still
threaded through admission tickets and router decisions for layers that
want an explicit handle.

Span records are plain dicts (one per *completed* span -- open spans live
only in the tracer's open-table), with keys::

    kind   "span" | "event"
    name   span name ("request", "encode.job", "farm.drain", ...)
    trace  request id (or None for infrastructure spans)
    id     span id (monotonic per tracer)
    parent parent span id or None
    track  export track ("engine", "encoder", "chip3", "pool", ...)
    t0/t1  wall seconds on the tracer clock (perf_counter - origin)
    sim0/sim1  backend sim-clock seconds, or None
    attrs  dict of JSON-ish attributes
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["TraceContext", "Span", "Tracer", "NULL_SPAN"]


@dataclass(frozen=True)
class TraceContext:
    """Minimal propagation handle: which request, which enclosing span."""

    trace_id: Optional[int]
    span_id: Optional[int]


class _NullSpan:
    """Inert span returned by a disabled tracer; absorbs every call."""

    __slots__ = ()
    trace_id = None
    span_id = None
    ctx = TraceContext(None, None)

    def end(self, sim_t1=None, **attrs) -> None:
        pass

    def event(self, name, sim_t=None, **attrs) -> None:
        pass

    def child(self, name, *, track=None, sim_t0=None, **attrs) -> "_NullSpan":
        return self

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One open span; commit it with :meth:`end` (exactly once)."""

    __slots__ = ("_tracer", "span_id", "trace_id", "parent_id", "name",
                 "track", "t0", "sim_t0", "attrs", "_done")

    def __init__(self, tracer: "Tracer", span_id: int,
                 trace_id: Optional[int], parent_id: Optional[int],
                 name: str, track: str, t0: float,
                 sim_t0: Optional[float], attrs: dict):
        self._tracer = tracer
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t0 = t0
        self.sim_t0 = sim_t0
        self.attrs = attrs
        self._done = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> None:
        """Attach attributes to the span before (or at) end."""
        self.attrs.update(attrs)

    def event(self, name: str, sim_t: Optional[float] = None,
              **attrs) -> None:
        """Record an instant event parented to this span."""
        self._tracer.event(name, trace_id=self.trace_id,
                           parent=self.span_id, track=self.track,
                           sim_t=sim_t, **attrs)

    def child(self, name: str, *, track: Optional[str] = None,
              sim_t0: Optional[float] = None, **attrs) -> "Span":
        return self._tracer.span(
            name, trace_id=self.trace_id, parent=self.span_id,
            track=track if track is not None else self.track,
            sim_t0=sim_t0, **attrs)

    def end(self, sim_t1: Optional[float] = None, **attrs) -> None:
        """Close the span, committing its record to the ring (idempotent)."""
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._commit(self, sim_t1)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def __bool__(self) -> bool:
        return True


class Tracer:
    """Thread-safe span/event recorder over one bounded ring buffer."""

    def __init__(self, *, enabled: bool = True, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = 0
        self._origin = time.perf_counter()
        self.dropped = 0
        self.opened = 0
        self.closed = 0
        self._open: Dict[int, Span] = {}
        self._roots: Dict[int, int] = {}  # trace_id -> root span id

    # ------------------------------------------------------------- clock

    def now(self) -> float:
        """Wall seconds on the tracer clock (shared origin for all spans)."""
        return time.perf_counter() - self._origin

    # ------------------------------------------------------------- spans

    def span(self, name: str, *, trace_id: Optional[int] = None,
             parent: Optional[int] = None, track: str = "main",
             sim_t0: Optional[float] = None, **attrs):
        """Open a span; caller must :meth:`Span.end` it exactly once."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            self._ids += 1
            sid = self._ids
            self.opened += 1
            sp = Span(self, sid, trace_id, parent, name, track,
                      self.now(), sim_t0, dict(attrs))
            self._open[sid] = sp
        return sp

    def emit_span(self, name: str, *, trace_id: Optional[int] = None,
                  parent: Optional[int] = None, track: str = "main",
                  t0: Optional[float] = None, t1: Optional[float] = None,
                  sim_t0: Optional[float] = None,
                  sim_t1: Optional[float] = None, **attrs) -> None:
        """Record an already-completed span in one call (opens and closes
        atomically, so it can never contribute to ``unclosed_spans``).
        Backends use this to convert receipts into spans at commit time."""
        if not self.enabled:
            return
        now = self.now()
        rec = {
            "kind": "span", "name": name, "trace": trace_id,
            "parent": parent, "track": track,
            "t0": now if t0 is None else t0,
            "t1": now if t1 is None else t1,
            "sim0": sim_t0, "sim1": sim_t1, "attrs": attrs,
        }
        with self._lock:
            self._ids += 1
            rec["id"] = self._ids
            self.opened += 1
            self.closed += 1
            self._append_locked(rec)

    def event(self, name: str, *, trace_id: Optional[int] = None,
              parent: Optional[int] = None, track: str = "main",
              sim_t: Optional[float] = None, **attrs) -> None:
        """Record an instant event (zero-duration ring entry)."""
        if not self.enabled:
            return
        t = self.now()
        rec = {
            "kind": "event", "name": name, "trace": trace_id,
            "parent": parent, "track": track, "t0": t, "t1": t,
            "sim0": sim_t, "sim1": sim_t, "attrs": attrs,
        }
        with self._lock:
            self._ids += 1
            rec["id"] = self._ids
            self._append_locked(rec)

    def _commit(self, sp: Span, sim_t1: Optional[float]) -> None:
        rec = {
            "kind": "span", "name": sp.name, "trace": sp.trace_id,
            "id": sp.span_id, "parent": sp.parent_id, "track": sp.track,
            "t0": sp.t0, "t1": self.now(),
            "sim0": sp.sim_t0, "sim1": sim_t1, "attrs": sp.attrs,
        }
        with self._lock:
            self.closed += 1
            self._open.pop(sp.span_id, None)
            if self._roots.get(sp.trace_id) == sp.span_id:
                del self._roots[sp.trace_id]
            self._append_locked(rec)

    def _append_locked(self, rec: dict) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(rec)

    # ------------------------------------------------------- correlation

    def register_root(self, trace_id: int, span) -> None:
        """Name ``span`` the root for ``trace_id`` so receipt-driven spans
        emitted by backends (keyed by job ``tag``) can parent to it."""
        if not self.enabled or span is NULL_SPAN:
            return
        with self._lock:
            self._roots[trace_id] = span.span_id

    def root_id(self, trace_id) -> Optional[int]:
        if not self.enabled or trace_id is None:
            return None
        with self._lock:
            return self._roots.get(trace_id)

    # ---------------------------------------------------------- reading

    def records(self, trace_id: Optional[int] = None) -> List[dict]:
        """Snapshot of committed records (oldest first), optionally
        filtered to one request's trace."""
        with self._lock:
            recs = list(self._ring)
        if trace_id is None:
            return recs
        return [r for r in recs if r["trace"] == trace_id]

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def unclosed_spans(self) -> int:
        """Spans opened but never ended.  Zero at quiescence is the span
        tree completeness invariant gated in CI (``ZERO_METRICS``)."""
        with self._lock:
            return self.opened - self.closed

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
