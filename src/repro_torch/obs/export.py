"""Trace and metrics export: Chrome-trace/Perfetto JSON + Prometheus text.

:func:`chrome_trace` converts a :class:`~repro_torch.obs.trace.Tracer` ring
snapshot into the Chrome Trace Event JSON format that Perfetto,
``chrome://tracing``, and speedscope all load.  Two process tracks are
emitted:

* ``pid 1`` -- **wall clock**: every span, timestamped on the tracer's
  shared ``perf_counter`` origin (``clock="tracer"``), or in Unix-epoch
  microseconds (``clock="unix"``, the timebase of ``torch.profiler``'s own
  trace, so the two lay over each other).  One thread (tid) per logical
  track ("engine", "encoder", "chip0".., "pool", ...).
* ``pid 2`` -- **sim clock**: only spans that carry backend sim-clock
  stamps (farm drains and per-job spans, pool jobs), timestamped on the
  backend's simulated-hardware clock.  This is the track that shows chip
  occupancy the way the paper's latency model counts it.

``"M"`` metadata events name the processes and threads; span events use
``ph: "X"`` (complete) and instants ``ph: "i"``.  Timestamps are
microseconds as the format requires.

:func:`validate_chrome_trace` is the CI schema gate: bench-smoke exports
a trace artifact from the routed saturation scenario and fails the build
if the artifact stops being loadable.
"""

from __future__ import annotations

import json
from typing import List, Optional

__all__ = ["chrome_trace", "validate_chrome_trace", "prometheus_text",
           "write_chrome_trace"]

_WALL_PID = 1
_SIM_PID = 2


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def chrome_trace(tracer, *, t0: Optional[float] = None,
                 t1: Optional[float] = None,
                 trace_id: Optional[int] = None,
                 clock: str = "tracer") -> dict:
    """Export (a window of) the tracer ring as Chrome Trace Event JSON.

    ``t0``/``t1`` bound the *wall-clock* window in tracer seconds (spans
    overlapping the window are kept); ``trace_id`` restricts to one
    request.  ``clock`` stamps the wall-clock events on the tracer's origin
    (``"tracer"``) or in Unix-epoch microseconds (``"unix"``, through
    :meth:`~repro_torch.obs.trace.Tracer.to_unix_ns`).  Returns
    ``{"traceEvents": [...]}`` ready to ``json.dump``.
    """
    if clock == "tracer":
        def wall_us(t):
            return t * 1e6
    elif clock == "unix":
        def wall_us(t):
            return tracer.to_unix_ns(t) / 1e3
    else:
        raise ValueError(f"clock must be 'tracer' or 'unix', got {clock!r}")
    records = tracer.records(trace_id)
    if t0 is not None:
        records = [r for r in records if r["t1"] >= t0]
    if t1 is not None:
        records = [r for r in records if r["t0"] <= t1]

    tracks: List[str] = []
    seen = set()
    for r in records:
        if r["track"] not in seen:
            seen.add(r["track"])
            tracks.append(r["track"])
    tid_of = {name: i + 1 for i, name in enumerate(sorted(tracks))}

    events: List[dict] = []
    events.append({"ph": "M", "name": "process_name", "pid": _WALL_PID,
                   "tid": 0, "args": {"name": "wall-clock"}})
    events.append({"ph": "M", "name": "process_name", "pid": _SIM_PID,
                   "tid": 0, "args": {"name": "sim-clock"}})
    for name, tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
        for pid in (_WALL_PID, _SIM_PID):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})

    for r in records:
        args = {"trace_id": r["trace"], "span_id": r["id"]}
        if r["parent"] is not None:
            args["parent_id"] = r["parent"]
        args.update({k: _jsonable(v) for k, v in r["attrs"].items()})
        tid = tid_of[r["track"]]
        if r["kind"] == "event":
            events.append({
                "ph": "i", "s": "t", "name": r["name"],
                "pid": _WALL_PID, "tid": tid,
                "ts": wall_us(r["t0"]), "args": args,
            })
            continue
        events.append({
            "ph": "X", "name": r["name"], "pid": _WALL_PID, "tid": tid,
            "ts": wall_us(r["t0"]),
            "dur": max(r["t1"] - r["t0"], 0.0) * 1e6,
            "args": args,
        })
        if r["sim0"] is not None and r["sim1"] is not None:
            events.append({
                "ph": "X", "name": r["name"], "pid": _SIM_PID, "tid": tid,
                "ts": r["sim0"] * 1e6,
                "dur": max(r["sim1"] - r["sim0"], 0.0) * 1e6,
                "args": args,
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "dropped_events": tracer.dropped,
            "unclosed_spans": tracer.unclosed_spans(),
        },
    }


def write_chrome_trace(tracer, path: str, **kw) -> dict:
    """Export and write a trace JSON artifact; returns the document."""
    doc = chrome_trace(tracer, **kw)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: dict) -> int:
    """Schema-check a Chrome-trace document; returns the event count.

    Raises ``ValueError`` on the first structural problem.  This is
    deliberately strict about the fields Perfetto's importer needs
    (``ph``; ``name``/``pid``/``tid``/``ts`` on events; numeric
    non-negative ``dur`` on complete events).
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be a dict with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: missing 'ph'")
        ph = ev["ph"]
        if ph == "M":
            if "name" not in ev or "pid" not in ev:
                raise ValueError(f"event {i}: metadata needs name/pid")
            continue
        for field in ("name", "pid", "tid", "ts"):
            if field not in ev:
                raise ValueError(f"event {i}: missing {field!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: non-numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        elif ph != "i":
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
    return len(events)


def prometheus_text(registry) -> str:
    """Prometheus text exposition snapshot of a ``MetricsRegistry``."""
    return registry.to_prometheus()
