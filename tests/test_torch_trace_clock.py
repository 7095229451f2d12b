"""The port's tracer clock laid over ``torch.profiler``'s: a
``record_function`` opened inside a program span starts, by the profiler's
own timestamp, inside that span mapped to Unix-epoch nanoseconds; the
Chrome trace's ``clock="unix"`` stamps spans in Unix-epoch microseconds and
the default stays on the tracer's origin."""

import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import Tracer, chrome_trace, validate_chrome_trace

SLACK_NS = 1_000_000  # 1 ms


def _kineto_start_ns(prof, name: str) -> int:
    (start,) = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
                if ev.name() == name]
    return start


def test_a_profiler_range_starts_inside_its_program_span():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):  # the profiler's first ranges pay its set-up
            with record_function("warm"):
                torch.ones(4).sum()
        with tracer.span("probe.span"), record_function("probe.range"):
            torch.ones(64).sum()
    start = _kineto_start_ns(prof, "probe.range")
    (span,) = tracer.records()
    lo, hi = tracer.to_unix_ns(span["t0"]), tracer.to_unix_ns(span["t1"])
    assert lo - SLACK_NS <= start <= hi + SLACK_NS, (start - lo, hi - start)


def test_to_unix_ns_agrees_with_the_wall_clock():
    tracer = Tracer()
    before = time.time_ns()
    t = tracer.now()
    after = time.time_ns()
    assert before - SLACK_NS <= tracer.to_unix_ns(t) <= after + SLACK_NS
    assert tracer.to_unix_ns(t + 1.5) - tracer.to_unix_ns(t) == 1_500_000_000


def test_chrome_trace_unix_clock_stamps_fresh_spans_now():
    tracer = Tracer()
    with tracer.span("fresh", track="engine", k=1):
        pass
    tracer.emit_span("done", sim_t0=0.0, sim_t1=0.5)
    now_us = time.time() * 1e6
    doc = chrome_trace(tracer, clock="unix")
    assert validate_chrome_trace(doc) > 0
    wall = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 1}
    assert abs(wall["fresh"]["ts"] - now_us) < 1e6
    plain = chrome_trace(tracer)
    plain_wall = {e["name"]: e for e in plain["traceEvents"] if e["ph"] == "X" and e["pid"] == 1}
    rec = {r["name"]: r for r in tracer.records()}
    assert plain_wall["fresh"]["ts"] == rec["fresh"]["t0"] * 1e6
    assert wall["fresh"]["dur"] == plain_wall["fresh"]["dur"]
    # The sim-clock track keeps its own timebase under either clock.
    sim = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 2]
    assert sim == [e for e in plain["traceEvents"] if e["ph"] == "X" and e["pid"] == 2]
    with pytest.raises(ValueError):
        chrome_trace(tracer, clock="monotonic")
