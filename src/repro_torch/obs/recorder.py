"""Flight recorder: per-request post-mortems from the tracer ring.

The recorder is a thin view over the tracer's bounded ring buffer: when a
request fails terminally, :meth:`FlightRecorder.dump` collects the last N
committed records carrying that request's trace id (plus any still-open
spans, flagged ``open: true``) into a list of plain dicts.  The engine
attaches that list to ``RequestFailed.flight_log`` before the future
resolves, and the chaos-soak benchmark writes the logs of every terminal
failure into its JSON artifact -- so every failure ships its own
post-mortem without anyone having had to turn on extra logging first.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Last-N-events view over one :class:`~repro_torch.obs.trace.Tracer`."""

    def __init__(self, tracer, *, last_n: int = 64):
        self.tracer = tracer
        self.last_n = int(last_n)

    def dump(self, trace_id: Optional[int]) -> List[dict]:
        """Most recent ``last_n`` records for ``trace_id`` (oldest first).

        Includes still-open spans (as ``{"open": True, ...}`` entries) so a
        hung request's partial tree is visible in its post-mortem.  Returns
        ``[]`` when tracing is disabled.
        """
        if not self.tracer.enabled:
            return []
        out = [dict(r) for r in self.tracer.records(trace_id)]
        for sp in self.tracer.open_spans():
            if sp.trace_id == trace_id:
                out.append({
                    "kind": "span", "name": sp.name, "trace": sp.trace_id,
                    "id": sp.span_id, "parent": sp.parent_id,
                    "track": sp.track, "t0": sp.t0, "t1": None,
                    "sim0": sp.sim_t0, "sim1": None,
                    "attrs": dict(sp.attrs), "open": True,
                })
        return out[-self.last_n:]
