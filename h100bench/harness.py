"""One run of one cell: build the system under test from the cell's
configuration file, warm the shapes its traffic reaches, drive the traffic
for ``--seconds``, read the metrics, judge the answers against the plain
reference, and print the result line.

Everything is found by name: the cell in ``BENCHMARK.json``; its
configuration ``h100bench/configs/<config>.json``, the front end it names
(``front_ends/<front_end>.py``) and its limits
``h100bench/limits/<config>.json``; its mix ``h100bench/traffic/<mix>.json``
and the arrival process and request kind the mix names
(``arrivals/<arrivals>.py``, ``requests/<request>.py``); each metric's
reader ``h100bench/end_to_end/<metric>.py`` or
``h100bench/layer_metrics/<metric>.py``, a module with ``read(ctx)`` that
returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import heapq
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from h100bench import devtrace, system
from h100bench.capture import InstanceLog
from h100bench.generator import Traffic, plugin

BENCH = Path(__file__).resolve().parent
SAMPLE = 16  # answers judged a run, drawn from the seed
TRACE_SECONDS = 4.0  # the traced run profiles the card over the window's last seconds
LATE_WAIT = 60.0  # seconds past the close the run waits for the answers in flight
TRACE_CAPACITY = 400_000
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Request:
    k: int
    sentences: list
    m: int
    t_sub: float
    rid: int | None = None  # the engine's request id: the tag of its solver jobs
    t_done: float = math.nan
    response: object = None
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.response is not None and self.error is None


class Loop:
    """Drives the engine with a mix's traffic: the mix's arrival process
    calls :meth:`submit_next`, and hears of each answer.  As answers come,
    it keeps the :data:`SAMPLE` requests of the window with the least
    priority drawn from the seed, and tells the instance log to free the
    rest."""

    def __init__(self, engine, traffic: Traffic, log: InstanceLog, window: tuple):
        self.engine, self.traffic, self.log = engine, traffic, log
        self.t0, self.t1 = window
        self.requests: list[Request] = []
        self.sample: list = []  # heap of (-priority, k, request)
        self.stopped = False
        self.next_k = 0
        self._cond = threading.Condition()
        self._in_flight = 0

    def submit_next(self) -> None:
        with self._cond:
            if self.stopped:
                return
            k, self.next_k = self.next_k, self.next_k + 1
            self._in_flight += 1
        req, sentences = self.traffic.request.build(self.traffic, k)
        rec = Request(k, sentences, self.traffic.m, time.perf_counter())
        with self._cond:
            self.requests.append(rec)
        try:
            fut = self.engine.submit_request(req)
        except Exception as exc:  # noqa: BLE001 -- a refused request is a failed one
            self._finish(rec, None, exc)
            return
        rec.rid = fut.request_id
        fut.add_done_callback(lambda f, rec=rec: self._done(rec, f))

    def _done(self, rec: Request, fut) -> None:
        try:
            resp, err = fut.result(0.0), None
        except Exception as exc:  # noqa: BLE001
            resp, err = None, exc
        self._finish(rec, resp, err)
        self.traffic.arrivals.on_answer(self)

    def _finish(self, rec: Request, resp, err) -> None:
        rec.t_done = time.perf_counter()
        rec.response, rec.error = resp, err
        drop = rec.rid
        if rec.ok and self.traffic.arrivals.owns(rec, self.t0, self.t1):
            with self._cond:
                heapq.heappush(self.sample, (-self.traffic.priority(rec.k), rec.k, rec))
                drop = heapq.heappop(self.sample)[2].rid if len(self.sample) > SAMPLE else None
        if drop is not None:
            self.log.drop(drop)
        with self._cond:
            self._in_flight -= 1
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self.stopped = True

    def wait_idle(self, deadline: float) -> bool:
        with self._cond:
            while self._in_flight > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _read_first(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _steal_s() -> float:
    """Seconds the hypervisor kept the machine's CPUs from it (all CPUs)."""
    for line in _read_first("/proc/stat").splitlines():
        f = line.split()
        if f and f[0] == "cpu" and len(f) > 8:
            return int(f[8]) / os.sysconf("SC_CLK_TCK")
    return math.nan


def _runqueue_wait_s() -> float:
    """Seconds the process's live threads waited for a CPU, ready to run."""
    total = 0
    try:
        tasks = os.listdir("/proc/self/task")
    except OSError:
        return math.nan
    for tid in tasks:
        f = _read_first(f"/proc/self/task/{tid}/schedstat").split()
        if len(f) > 1:
            total += int(f[1])
    return total / 1e9


def host_snapshot() -> dict:
    """What the host gave the process: its CPU seconds, the collector's runs
    by generation, the machine's stolen seconds and the process's wait for a
    CPU."""
    t = os.times()
    return {"cpu_s": t.user + t.system, "gc": [g["collections"] for g in gc.get_stats()],
            "steal_s": _steal_s(), "runq_s": _runqueue_wait_s()}


def host_line(h0: dict, h1: dict, seconds: float) -> str:
    return (f"host: {h1['cpu_s'] - h0['cpu_s']:.3f} CPU s of the process over the "
            f"{seconds:g} s window; collections by generation "
            f"{[b - a for a, b in zip(h0['gc'], h1['gc'])]}; stolen "
            f"{h1['steal_s'] - h0['steal_s']:.3f} s (all CPUs); waited for a CPU "
            f"{h1['runq_s'] - h0['runq_s']:.3f} s (the process's threads)")


def slices_line(requests: list, t0: float, t1: float, n: int = 5) -> str:
    """Answers of the window by fifths: a stall shows as one slow fifth, a
    slow host as slow fifths throughout."""
    width = (t1 - t0) / n
    counts = [0] * n
    for r in requests:
        counts[min(n - 1, int((r.t_done - t0) / width))] += 1
    return f"slices: answers in each {width:g} s of the window {counts}"


def _counters(registry) -> dict:
    return {f.name: f.value for f in registry.families()
            if f.kind == "counter" and not f.label_names}


def load_reader(kind: str, name: str):
    return plugin(kind, name, BENCH)


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    metrics that list it (or, listing no cells, move an end-to-end metric it
    reports), else its end-to-end metrics."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def drive(engine, traffic: Traffic, log: InstanceLog, seconds: float,
          profiler=None) -> SimpleNamespace:
    """Warm the engine with ``traffic.warm_seconds`` of the mix, then measure
    ``seconds``; returns the window, the requests and the counters at its
    edges.  A profiler, when given, runs over the window's last
    :data:`TRACE_SECONDS`."""
    t_start = time.perf_counter()
    t0 = t_start + traffic.warm_seconds
    t1 = t0 + seconds
    t_trace = max(t0, t1 - TRACE_SECONDS)
    loop = Loop(engine, traffic, log, (t0, t1))
    out = SimpleNamespace(t0=t0, t1=t1, loop=loop, c0=None, c1=None, trace_window=None)
    events = [(t0, "open"), (t_trace, "trace"), (t1, "close")]

    def tick(now_due: float) -> None:
        while events and events[0][0] <= now_due:
            t_ev, what = events.pop(0)
            _sleep_until(t_ev)
            if what == "open":
                out.c0 = _counters(engine.obs.registry)
                out.h0 = host_snapshot()
            elif what == "trace" and profiler is not None:
                profiler.start()
                out.trace_window = (min(time.perf_counter(), t1), t1)
            elif what == "close":
                loop.stop()
                out.c1 = _counters(engine.obs.registry)
                out.h1 = host_snapshot()
                if profiler is not None:
                    profiler.stop()

    traffic.arrivals.drive(loop, traffic, tick)
    out.all_answered = loop.wait_idle(time.perf_counter() + LATE_WAIT)
    out.owned = [r for r in loop.requests if traffic.arrivals.owns(r, t0, t1)]
    out.sample = sorted((rec for _, _, rec in loop.sample), key=lambda r: r.k)
    return out


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "--id=0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run_cell(manifest: dict, cell_name: str, *, seed: int, seconds: float, trace: bool,
             device, t_process: float, config: dict | None = None, mix: dict | None = None,
             limits_file: dict | None = None, log=print) -> dict:
    """One run of ``cell_name``; returns the result line's object.  The
    configuration, mix and limits are read from their files unless given."""
    import torch

    cell = next(c for c in manifest["workloads"] if c["name"] == cell_name)
    config = config or json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    mix = mix or json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = limits_file or json.loads(
        (BENCH / "limits" / f"{cell['config']}.json").read_text())
    metrics = cell_metrics(manifest, cell_name, trace)
    traffic = Traffic(mix, seed, BENCH)

    engine, stage = system.build_engine(config, seed, device, tracing=trace,
                                        trace_capacity=TRACE_CAPACITY)
    host_spans = profiler = None
    instances = InstanceLog()
    try:
        instances.install(engine)
        shapes = system.traffic_shapes(config, traffic)
        warmed = system.prewarm(engine, stage, config, shapes)
        log(f"warm: {warmed} launches over the shapes the traffic reaches ({shapes})")
        if trace:
            host_spans = devtrace.HostSpans()
            host_spans.install()
            profiler = devtrace.Profiler(device)
            profiler.warm(device)
        # What set-up left is never collected again: the window's collections
        # walk only what the window makes.
        gc.collect()
        gc.freeze()
        run = drive(engine, traffic, instances, seconds, profiler)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        tracer = engine.obs.tracer
        offset = time.perf_counter() - tracer.now()
        spans = [dict(rec, t0=rec["t0"] + offset, t1=rec["t1"] + offset)
                 for rec in tracer.records()] if trace else []
    finally:
        if host_spans is not None:
            host_spans.restore()
        instances.restore()
        engine.close()
        gc.unfreeze()
    del engine, stage
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    setup_s = run.t0 - t_process
    owned = run.owned
    failed = [r for r in owned if not r.ok]

    dev_trace = None
    if profiler is not None and run.trace_window is not None:
        dev_trace = profiler.read(*run.trace_window)
        log(profiler.note)
    log(f"window: {len(owned)} requests owned, {len(failed)} failed, all answered "
        f"{run.all_answered}")
    log(host_line(run.h0, run.h1, seconds))
    log(slices_line(owned, run.t0, run.t1))
    for line in traffic.request.notes(config, owned):
        log(line)

    ctx = SimpleNamespace(cell=cell, config=config, mix=mix, seed=seed, seconds=seconds,
                          t0=run.t0, t1=run.t1, setup_s=setup_s, requests=owned,
                          counters=(run.c0, run.c1), spans=spans, device=dev_trace,
                          host_spans=host_spans.spans if host_spans else [])
    values = {}
    for m in metrics:
        kind = "end_to_end" if not trace else "layer_metrics"
        v = load_reader(kind, m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_ref = time.perf_counter()
    verdict = traffic.request.judge(config, limits_file, seed, device, run.sample,
                                    traffic.lam, instances.logs)
    log(f"reference: {len(run.sample)} answers judged in {time.perf_counter() - t_ref:.3f} s "
        f"(bounds exact: {verdict.exact}); not compared: quality_gap "
        f"{verdict.numbers['quality_gap']!r}, 1 - normalized objective "
        f"{[round(j['quality_gap'], 6) for j in verdict.judged]}")
    correct = verdict.ok and not failed and run.all_answered and len(run.sample) > 0

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(owned), "failed": len(failed),
              "metrics": values, "device": dev}
    if trace and dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s
        dev["window_s"] = dev_trace.window_s
        result["breakdown"] = {"device_ops": devtrace.top_ops(dev_trace),
                               "idle_gaps": devtrace.name_gaps(dev_trace, ctx.host_spans)}
    result["checks"] = {k: {"value": verdict.numbers[k], "limit": verdict.limits[k]}
                        for k in verdict.limits}
    return result


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = next((c for c in manifest["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(manifest, args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device, t_process=t_process,
                      log=lambda s: print(s, flush=True))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX "
              "package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
