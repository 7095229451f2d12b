"""The per-layer metrics read from the program's own spans and counters
inside the driver loop, the pipeline and the encoder stage: a traced tiny
rehearsal of the sbert cell reports each as a finite number, consistent
with the driver's busy time; an untraced one reports none; and on a program
that lacks those spans and counters each reader finds nothing and raises
nothing."""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import pytest

from h100bench import harness
from h100bench.devtrace import DeviceTrace
from h100bench.tests import tiny

CELL = "es-sbert-cobi.news-batch"
NEW = ("driver_ms_per_summary", "encode_poll_ms_per_summary", "rounding_ms_per_summary",
       "formulation_ms_per_summary", "queue_wait_ms_p50", "idle_while_rounding_share")


def test_new_metrics_are_declared_for_the_sbert_cell():
    declared = {m["name"]: m for m in tiny.MANIFEST["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "summaries_per_s"
    assert set(NEW) <= {m["name"] for m in harness.cell_metrics(tiny.REHEARSAL, CELL, True)}


def test_a_traced_rehearsal_reports_each_new_metric(monkeypatch):
    # On the CPU the harness's profiler stands the host's operators in for
    # the card's; they run on the engine's and the encoder stage's threads,
    # which the profiler records only when told to record every thread.
    import torch.profiler
    from torch._C._profiler import _ExperimentalConfig

    monkeypatch.setattr(torch.profiler, "profile", functools.partial(
        torch.profiler.profile, experimental_config=_ExperimentalConfig(profile_all_threads=True)))
    out = tiny.run(CELL, trace=True)
    assert out["correct"], out["checks"]
    got = {name: out["metrics"][name]["value"] for name in NEW}
    assert all(math.isfinite(v) and v >= 0.0 for v in got.values()), got
    assert got["driver_ms_per_summary"] > 0.0 and got["rounding_ms_per_summary"] > 0.0
    assert (got["rounding_ms_per_summary"] + got["formulation_ms_per_summary"]
            + got["encode_poll_ms_per_summary"]) <= got["driver_ms_per_summary"]
    assert got["idle_while_rounding_share"] <= 100.0
    assert {out["metrics"][name]["unit"] for name in NEW} == {"ms", "%"}


def test_an_untraced_rehearsal_reports_none_of_them():
    out = tiny.run(CELL, trace=False)
    assert out["correct"], out["checks"]
    assert not set(NEW) & set(out["metrics"])


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_and_counters_reads_nothing(name):
    """What a parent program, older than these spans and counters, gives
    the readers: its own counters and spans, and a device trace."""
    ok = SimpleNamespace(ok=True, t_done=0.5)
    ctx = SimpleNamespace(
        t0=0.0, t1=1.0, requests=[ok, ok],
        counters=({"farm_jobs_total": 0.0}, {"farm_jobs_total": 12.0}),
        spans=[{"name": "request.solve", "t0": 0.1, "t1": 0.4, "attrs": {}}],
        device=DeviceTrace(0.0, 1.0, [("kernel", 0.2, 0.1)]))
    assert harness.load_reader("layer_metrics", name).read(ctx) is None


def test_the_driver_reader_cuts_rounds_at_the_window_edges():
    """Rounds that straddle the window's edges count only their part inside
    it, so the driver's busy seconds never exceed the window."""
    rounds = [(-0.4, 0.3), (0.3, 0.7), (0.7, 1.6), (1.6, 2.0)]
    ctx = SimpleNamespace(
        t0=0.0, t1=1.0, requests=[SimpleNamespace(ok=True)] * 4,
        spans=[{"name": "engine.round", "t0": a, "t1": b, "attrs": {}} for a, b in rounds])
    got = harness.load_reader("layer_metrics", "driver_ms_per_summary").read(ctx)
    assert got == pytest.approx(1e3 * 1.0 / 4)
