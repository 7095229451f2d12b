"""The port's spans and counters inside the serving engine's driver loop,
the solve pipeline and the encoder stage, on the CPU.

One tiny batch (two text requests through an ``EncoderStage``, one
oversized request with its own mu/beta that decomposes) runs through
``CobiFarm(2)`` under the manual policy, traced and untraced.  Bars: every
request's phase spans are there, once per submission unit, under its root;
every driver-thread span lies inside an ``engine.round``; the driver's
counters equal what its round spans say; tracing changes no answer.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SolveConfig
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import EncoderStage
from repro_torch.farm import CobiFarm
from repro_torch.serving import SummarizationEngine, SummarizeRequest
from repro_torch.serving import api as tapi

CFG = SolveConfig(solver="cobi", iterations=2, reads=4, int_range=14, steps=60,
                  p=20, q=10)
# Spans that run on the driver thread, one round at a time.
DRIVER_PREFIXES = ("pipeline.", "engine.", "farm.")
UNIT_PHASES = ("pipeline.formulation", "pipeline.rounding", "pipeline.submit")


def _requests():
    rng = np.random.default_rng(3)
    mu = rng.random(70).astype(np.float32)
    beta = rng.random((70, 70)).astype(np.float32)
    beta = (beta + beta.T) / 2
    np.fill_diagonal(beta, 0.0)
    reqs = [SummarizeRequest(text=" ".join(synthetic_document(500 + i, n)), m=5)
            for i, n in enumerate((14, 18))]
    reqs.append(tapi.SelectionRequest(
        items=[f"item {k}" for k in range(70)],
        kofn=tapi.KofnSpec(m=6, lam=0.5, relevance="given", mu=mu.tolist(), beta=beta)))
    return reqs


def _serve(tracing: bool):
    stage = EncoderStage.tiny(max_len=512, device="cpu")
    with SummarizationEngine(CFG, farm=CobiFarm(2, device="cpu"), encoder=stage, seed=0,
                             tracing=tracing, device="cpu") as eng:
        got = eng.run_batch(_requests(), seed=5)
    counters = {f.name: f.value for f in eng.obs.registry.families()
                if f.kind == "counter" and not f.label_names}
    return eng, got, counters


@pytest.fixture(scope="module")
def traced():
    return _serve(True)


def _spans(eng):
    return [r for r in eng.obs.tracer.records() if r["kind"] == "span"]


def _descends(rec, by_id, root_id):
    while rec["parent"] is not None:
        if rec["parent"] == root_id:
            return True
        rec = by_id[rec["parent"]]
    return False


def test_each_request_has_its_phase_spans_under_its_root(traced):
    eng, got, _ = traced
    spans = _spans(eng)
    by_id = {r["id"]: r for r in spans}
    for resp in got:
        rid = resp.request_id
        mine = [r for r in spans if r["trace"] == rid]
        (root,) = [r for r in mine if r["name"] == "request"]
        assert all(_descends(r, by_id, root["id"]) for r in mine if r is not root)
        names = collections.Counter(r["name"] for r in mine)
        assert names["request.queue"] == 1
        (queue,) = [r for r in mine if r["name"] == "request.queue"]
        assert queue["parent"] == root["id"] and queue["t1"] == root["t0"] >= queue["t0"]
        units = resp.solver_invocations // CFG.iterations
        assert [names[p] for p in UNIT_PHASES] == [units] * 3
        reduces = [r for r in mine if r["name"] == "pipeline.reduce"]
        decomposed = names["pipeline.window_plan"] > 0
        # The pipelined planner replans once a resolved window: one reduce
        # each; a mis-speculated window is submitted and never reduced.
        assert len(reduces) == (names["pipeline.window_plan"] - 1 if decomposed else 1)
        assert 1 <= len(reduces) <= units
        for red in reduces:
            kids = collections.Counter(r["name"] for r in mine if r["parent"] == red["id"])
            assert kids == {"pipeline.repair": CFG.iterations,
                            "pipeline.objective": CFG.iterations}
        # A decomposed request repairs and scores its merged selection once.
        final = collections.Counter(r["name"] for r in mine if r["parent"] == root["id"]
                                    and r["name"] in ("pipeline.repair", "pipeline.objective"))
        assert final == ({"pipeline.repair": 1, "pipeline.objective": 1} if decomposed else {})
        assert names["engine.scores"] == names["engine.resolve"] == 1
    assert sum(r["name"] == "pipeline.window_plan" for r in spans) > 0
    rounding = [r for r in spans if r["name"] == "pipeline.rounding"]
    assert all(r["attrs"]["iterations"] == CFG.iterations and r["attrs"]["n"] > 0
               for r in rounding)


def test_driver_spans_lie_inside_rounds(traced):
    eng, _, _ = traced
    spans = _spans(eng)
    rounds = [r for r in spans if r["name"] == "engine.round"]
    assert rounds and all(r["trace"] is None and r["track"] == "engine" for r in rounds)
    assert all(set(r["attrs"]) == {"adopted", "active", "finished", "encode_wait_s"}
               for r in rounds)
    assert sum(r["attrs"]["adopted"] for r in rounds) == 3
    assert sum(r["attrs"]["finished"] for r in rounds) == 3
    round_ids = {r["id"] for r in rounds}
    driver = [r for r in spans if r["name"].startswith(DRIVER_PREFIXES)
              and r["name"] != "engine.round"]
    assert {"engine.drain", "farm.job", "pipeline.rounding"} <= {r["name"] for r in driver}
    for rec in driver:
        assert any(r["t0"] <= rec["t0"] and rec["t1"] <= r["t1"] for r in rounds), rec["name"]
    assert all(r["parent"] in round_ids for r in driver if r["name"] == "engine.drain")
    assert eng.obs.tracer.unclosed_spans() == 0 and eng.obs.tracer.dropped == 0


def test_encoder_passes_are_spanned_on_the_stage_track(traced):
    eng, _, counters = traced
    passes = [r for r in _spans(eng) if r["name"] == "encoder.pass"]
    assert len(passes) == counters["encoder_launches_total"] > 0
    assert all(r["track"] == "encoder" and r["trace"] is None for r in passes)
    assert sum(r["attrs"]["jobs"] for r in passes) == counters["encoder_jobs_total"]
    assert sum(r["attrs"]["tokens"] for r in passes) == counters["encoder_tokens_total"]
    assert all(r["attrs"]["batch"] >= r["attrs"]["jobs"] and r["attrs"]["length"] > 0
               for r in passes)


def test_driver_counters_equal_the_round_spans(traced):
    eng, _, counters = traced
    rounds = [r for r in _spans(eng) if r["name"] == "engine.round"]
    busy = 0.0
    for r in rounds:  # the counter's own order of additions
        busy += r["t1"] - r["t0"]
    assert counters["engine_driver_busy_seconds_total"] == busy
    wait = sum(r["attrs"]["encode_wait_s"] for r in rounds)
    assert wait > 0.0
    assert counters["engine_encode_wait_seconds_total"] == pytest.approx(wait, rel=1e-9)


def test_untraced_serving_gives_the_same_answers_and_still_counts(traced):
    _, want, _ = traced
    eng, got, counters = _serve(False)
    assert eng.obs.tracer.records() == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.selection, w.selection)
        assert g.objective == w.objective
        assert g.solver_invocations == w.solver_invocations
    assert counters["engine_driver_busy_seconds_total"] > 0.0
    assert counters["engine_encode_wait_seconds_total"] > 0.0
