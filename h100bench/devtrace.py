"""The traced run's device trace and host spans.

``torch.profiler`` records the card's operations (kernels, copies, sets)
over the last seconds of the measured window; they are read from the
profiler's raw events (building its event tree takes minutes at hundreds of
thousands of kernels).  The benchmark's own host spans wrap the program's
layer entry points (the farm's drain, an encoder pass, the rounding, the
formulation, repair and objective, the host encoder) so that each idle
stretch of the card can be named by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import importlib
import time

# (module, attribute path, span name): the layer entry points wrapped in a
# traced run.  A missing one raises: a rename in the program would otherwise
# empty the breakdown quietly.
HOST_SPANS = (
    ("repro_torch.farm.scheduler", "CobiFarm.drain", "farm.drain"),
    ("repro_torch.embeddings.serving", "EncoderStage._run_group", "encoder.pass"),
    ("repro_torch.embeddings.encoder", "HashedBowEncoder.encode", "bow.encode"),
    ("repro_torch.core.pipeline", "quantize_ising_many", "pipeline.rounding"),
    ("repro_torch.core.pipeline", "quantize_ising", "pipeline.rounding"),
    ("repro_torch.core.pipeline", "improved_ising", "pipeline.formulation"),
    ("repro_torch.core.pipeline", "repair_selection", "pipeline.repair"),
    ("repro_torch.core.pipeline", "es_objective", "pipeline.objective"),
    ("repro_torch.core.pipeline", "_objective_np", "pipeline.objective"),
    ("repro_torch.serving.engine", "problem_from_embeddings", "engine.scores"),
    ("repro_torch.serving.engine", "SummarizationEngine._resolve", "engine.resolve"),
)


class HostSpans:
    """Wraps the entry points of :data:`HOST_SPANS` to record (name, t0, t1)
    on the host's ``perf_counter`` clock; :meth:`restore` unwraps them."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self._undo = []

    def install(self) -> None:
        for module, path, name in HOST_SPANS:
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = getattr(owner, attr)
            setattr(owner, attr, self._wrap(fn, name))
            self._undo.append((owner, attr, fn))

    def _wrap(self, fn, name):
        spans = self.spans

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter()))

        return wrapped

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


@dataclasses.dataclass
class DeviceTrace:
    """The card's operations in [t0, t1] (host perf_counter seconds), each
    (name, start, duration), clipped to the window."""

    t0: float
    t1: float
    ops: list

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, s, d in sorted(self.ops, key=lambda op: op[1]):
            e = s + d
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> list[tuple[float, float]]:
        out, cur = [], self.t0
        for s, e in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return out

    def seconds_by_name(self, match=None) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, _, d in self.ops:
            if match is None or any(m in name for m in match):
                out[name] = out.get(name, 0.0) + d
        return out


class Profiler:
    """``torch.profiler`` over the card alone, with the host clock at its
    start kept beside it so that its timestamps map onto ``perf_counter``.
    On a CPU device (the tests' rehearsal) it records the host's operators
    in the card's place."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = device.type == "cuda"
        self._kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
        self._prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                         else ProfilerActivity.CPU])
        self._clocks = None
        self.note = "trace: not read"

    def warm(self, device) -> None:
        """One short profile in set-up, so that starting the real one in the
        window does not pay the tracer's first initialisation."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._prof.activities):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        self._prof.start()
        self._clocks = (time.perf_counter_ns(), time.time_ns(), time.monotonic_ns())

    def stop(self) -> None:
        self._prof.stop()

    def read(self, t0: float, t1: float) -> DeviceTrace:
        """The device operations between t0 and t1 (perf_counter seconds)."""
        raw = [(ev.name(), ev.start_ns(), ev.duration_ns())
               for ev in self._prof.profiler.kineto_results.events()
               if ev.device_type() == self._kind
               and not getattr(ev, "is_hidden_event", lambda: False)()]
        self.note = f"trace: {len(raw)} device operations recorded"
        if not raw:
            return DeviceTrace(t0, t1, [])
        first = min(s for _, s, _ in raw)
        # The profiler's clock is one of these three; take the one its first
        # operation lies closest after.
        perf0 = self._clocks[0]
        clock = min(range(3), key=lambda i: abs(first - self._clocks[i]))
        base = self._clocks[clock]
        ops = []
        for name, s, d in raw:
            start = (s - base + perf0) / 1e9
            end = start + d / 1e9
            start, end = max(start, t0), min(end, t1)
            if end > start:
                ops.append((name, start, end - start))
        last = max(s + d for _, s, d in raw)
        self.note += (f", {len(ops)} inside the traced slice; the first starts "
                      f"{(first - base) / 1e9:+.3f} s and the last ends {(last - base) / 1e9:+.3f} s "
                      f"from the profiler's start ({('perf_counter', 'time', 'monotonic')[clock]} "
                      f"clock), the slice lasts {t1 - t0:.3f} s")
        return DeviceTrace(t0, t1, ops)


def name_gaps(trace: DeviceTrace, spans, top: int = 10) -> list[list]:
    """Idle seconds of the card in the trace's window, summed by what the
    host was doing at each gap's midpoint (the latest-started host span
    open then, else ``host.other``): the ``top`` largest as [name, seconds]."""
    spans = sorted(spans, key=lambda sp: sp[1])
    heap: list = []  # (-start, end, name) of spans started by the midpoint
    i, by_name = 0, {}
    for s, e in sorted(trace.gaps(), key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while i < len(spans) and spans[i][1] <= mid:
            heapq.heappush(heap, (-spans[i][1], spans[i][2], spans[i][0]))
            i += 1
        while heap and heap[0][1] < mid:  # ended before this (and every later) midpoint
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host.other"
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[f"idle while {n}", v] for n, v in ranked]


def top_ops(trace: DeviceTrace, top: int = 10) -> list[list]:
    ranked = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
    return [[n[:160], v] for n, v in ranked]
