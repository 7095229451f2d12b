"""The port's serving stack against the reference's, on the CPU: admission,
routing, recovery and calibration decisions, the workload builders, the
engine under Tabu and under the chip farm, the serve launcher, and the
engine's meter conservation.

Bars: admission, router and recovery are pure Python, so their decisions on
one request stream are the reference's bit for bit, and so are calibration
predictions (same profile JSON, same float64 arithmetic) and the workload
builders' requests.  The engine under Tabu gives the reference engine's
selections and objectives bit for bit wherever the request carries its own
mu/beta (identical instances); a text request goes through the encoder and
scores_from_embeddings, whose float32 products sum in another order
(objective within rtol 1e-5).  Under COBI the port's engine equals the
port's inline solve_es keyed by fold_in(key(seed), request_id), bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import workloads as jwl
from repro.core import SolveConfig as JSolveConfig
from repro.data.synthetic import synthetic_benchmark
from repro.farm import CobiFarm as JFarm
from repro.farm import faults as jfaults
from repro.serving import SummarizationEngine as JEngine
from repro.serving import SummarizeRequest as JSummarizeRequest
from repro.serving import admission as jadm
from repro.serving import api as japi
from repro.serving import calibration as jcal
from repro.serving import recovery as jrec
from repro.serving import router as jrt
from repro_torch import prng
from repro_torch import workloads as twl
from repro_torch.core import SolveConfig, solve_es
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import HashedBowEncoder
from repro_torch.farm import CobiFarm
from repro_torch.farm import faults as tfaults
from repro_torch.interop import carry_across
from repro_torch.serving import SummarizationEngine, SummarizeRequest
from repro_torch.serving import admission as tadm
from repro_torch.serving import api as tapi
from repro_torch.serving import calibration as tcal
from repro_torch.serving import recovery as trec
from repro_torch.serving import router as trt

ROOT = Path(__file__).resolve().parents[1]
PROFILES = {name: ROOT / "benchmarks" / f"CALIBRATION_{name}.json"
            for name in ("cobi_pool", "mcmc")}
# The H100's own fits (python -m repro_torch.launch.calibrate on the card).
PROFILES.update({f"{name}_h100": ROOT / "src" / "repro_torch" / "serving" / "profiles"
                 / f"CALIBRATION_{name}_h100.json" for name in ("cobi_pool", "mcmc")})
JPKG = SimpleNamespace(adm=jadm, cal=jcal, rt=jrt, rec=jrec, faults=jfaults)
TPKG = SimpleNamespace(adm=tadm, cal=tcal, rt=trt, rec=trec, faults=tfaults)


# ------------------------------------------------------ pure-Python layers


class _Backend:
    """What the router reads of a live backend: a queue estimate and a
    fault rate, both set by the stream."""

    def __init__(self):
        self.wait, self.rate = 0.0, 0.0

    def capacity_hint(self):
        return SimpleNamespace(est_queue_seconds=self.wait)

    def fault_rate(self):
        return self.rate


# (n sentences, reads, deadline slack or None, priority): small, decomposed
# and tight-deadline requests, so admission admits, degrades, spills and
# rejects.
STREAM = [(14, 8, None, 0), (20, 8, 0.05, 1), (70, 8, 0.02, 0), (33, 8, 0.004, 2),
          (59, 16, 0.01, 0), (12, 8, 0.0005, 0), (25, 8, 0.003, 1), (100, 8, None, 0),
          (40, 8, 0.008, 0), (18, 4, 0.002, 3), (59, 8, 0.03, 0), (9, 8, 0.001, 0)]


def _decisions(pkg, profile_json: str) -> list:
    out = []
    profile = pkg.cal.CalibrationProfile.from_json(profile_json)
    backends = {name: _Backend() for name in profile.models}
    router = pkg.rt.BackendRouter(
        backends, profile, pkg.rt.RouterConfig(quality_floor=0.6, primary="farm"))
    ctl = pkg.adm.AdmissionController(
        pkg.adm.AdmissionConfig(max_queue_depth=5, overload="degrade",
                                deadline_watermark=1e-4, auto_watermark=True),
        lanes_per_chip=64, n_chips=2, seconds_per_solve=200e-6, router=router)
    sim = 0.0
    for i, (n, reads, slack, prio) in enumerate(STREAM):
        rid = i + 1
        lanes = [n] * 6 if n <= 59 else [20] * (6 * (1 + -(-(n - 20) // 10)))
        backends["farm"].wait = 0.002 * (i % 4)
        backends["pool"].rate = 0.1 * (i % 3)
        try:
            t = ctl.admit(rid, lanes, reads, None if slack is None else sim + slack, sim,
                          priority=prio, steps=400, iterations=6)
            out.append({k: v for k, v in dataclasses.asdict(t).items() if k != "ctx"})
        except pkg.adm.EngineOverloadedError as exc:
            out.append(("rejected", exc.reason, str(exc)))
        if i % 3 == 2:
            ctl.on_done(rid - 1, realized=sim + 0.003)
            ctl.note_eviction(rid - 2)
        sim += 0.0007
    out.append(dataclasses.asdict(ctl.stats()))
    for jobs, slack in (([(20, 8)] * 6, None), ([(59, 64)] * 10, 0.001), ([(5, 1)], 0.0),
                        ([(40, 8)] * 3, 0.5)):
        try:
            out.append(dataclasses.asdict(router.decide(jobs, deadline_slack=slack,
                                                        iterations=6)))
        except pkg.rt.InfeasibleRoute as exc:
            out.append(("infeasible", str(exc)))
    out.append(router.route_window_info(20, 8, iterations=6, deadline_slack=1e-5)[::2])
    router.observe("pool", predicted_seconds=0.01, realized_seconds=0.03,
                   predicted_energy=1.0, realized_energy=0.5)
    router.note_failover("pool")
    out.append(router.stats())
    out.append(profile.to_json())
    now = [0.0]
    ctx = pkg.rec.RecoveryContext(
        pkg.rec.RetryPolicy(max_retries=2), clock=lambda: now[0], deadline=0.01,
        failover="the pool", failover_name="pool", est_job_seconds=0.0016, request_id=7)
    for attempts, t, failed_over in ((0, 0.0, False), (1, 0.004, False), (2, 0.005, False),
                                     (0, 0.0099, False), (0, 0.0, True)):
        now[0] = t
        ctx.note_fault(pkg.faults.ChipFailure("chip 1 lost", job_id=attempts))
        try:
            out.append(ctx.decide(attempts, failed_over=failed_over))
        except pkg.rec.RequestFailed as exc:
            out.append(("failed", str(exc), exc.attempts, exc.faults))
    out.append((ctx.retries, ctx.failed_over, ctx.faults_seen))
    return out


@pytest.mark.parametrize("source", ["default", *PROFILES])
def test_admission_router_recovery_decisions_equal_the_reference(source):
    if source == "default":
        text = jcal.default_profile(n_chips=2, mcmc_workers=2).to_json()
    else:
        text = PROFILES[source].read_text()
    got, want = _decisions(TPKG, text), _decisions(JPKG, text)
    assert got == want
    kinds = {type(d).__name__ if not isinstance(d, tuple) else d[0] for d in want}
    assert {"dict", "failed", "rejected"} <= kinds or source != "default"


@pytest.mark.parametrize("source", ["default", *PROFILES])
def test_calibration_predictions_equal_the_reference(source):
    if source == "default":
        jp = jcal.default_profile(n_chips=4, pool_workers=3, mcmc_workers=2)
        tp = tcal.default_profile(n_chips=4, pool_workers=3, mcmc_workers=2)
    else:
        jp, tp = (m.CalibrationProfile.load(str(PROFILES[source])) for m in (jcal, tcal))
    assert tp.to_json() == jp.to_json()
    assert carry_across("profile", jp.to_json()).to_json() == jp.to_json()
    for name, jm in jp.models.items():
        tm = tp.model(name)
        for n in (1, 5, 20, 33, 59):
            for reads in (1, 8, 64):
                jobs = [(n, reads)] * 6
                assert tm.request_seconds(jobs, 400) == jm.request_seconds(jobs, 400)
                assert tm.request_energy(jobs, 300) == jm.request_energy(jobs, 300)
                assert tm.invocation_seconds(n, reads, 200) == jm.invocation_seconds(n, reads, 200)
                assert tm.quality_gap(n, reads) == jm.quality_gap(n, reads)
    assert tcal.fit_host_latency([(10, 0.1), (20, 0.3), (40, 1.1)]) == jcal.fit_host_latency(
        [(10, 0.1), (20, 0.3), (40, 1.1)])
    assert dataclasses.asdict(tcal.mcmc_model(workers=3)) == dataclasses.asdict(
        jcal.mcmc_model(workers=3))


def _zoo(wl, i):
    """One request of each registered workload, as the serve launcher builds
    them (seeded by index)."""
    sents = synthetic_document(i, 20 + (i % 3) * 15)
    docs = [" ".join(synthetic_document(10 * i + j, 8)) for j in range(3)]
    return [wl.build_request("summarize", text=" ".join(sents), m=6),
            wl.build_request("dedup", items=sents, keep=6),
            wl.build_request("rerank", query=sents[0], candidates=sents[1:], k=6),
            wl.build_request("multidoc", documents=docs, m=6)]


def test_workload_requests_equal_the_reference():
    assert twl.available_workloads() == jwl.available_workloads()
    for i in range(3):
        want = [dataclasses.asdict(r) for r in _zoo(jwl, i)]
        got = _zoo(twl, i)
        assert [dataclasses.asdict(r) for r in got] == want
        assert carry_across("requests", want) == got
    with pytest.raises(KeyError) as jerr:
        jwl.get_workload("nope")
    with pytest.raises(KeyError) as terr:
        twl.get_workload("nope")
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------- engine


def _given_requests(api):
    """Requests that carry their own mu/beta (no encoder): both packages
    solve the identical instance."""
    reqs = []
    for seed, n, m in ((0, 14, 4), (1, 20, 6), (2, 30, 5)):
        p = synthetic_benchmark(seed, n, m, lam=0.5)
        reqs.append(api.SelectionRequest(
            items=[f"item {k}" for k in range(n)],
            kofn=api.KofnSpec(m=m, lam=0.5, relevance="given", mu=np.asarray(p.mu).tolist(),
                              beta=np.asarray(p.beta)),
            workload="given"))
    return reqs


def test_engine_under_tabu_gives_the_reference_engines_selections():
    cfg = dict(solver="tabu", iterations=3, reads=4, int_range=14)
    text = " ".join(synthetic_document(31, 16))
    jreqs = _given_requests(japi) + [JSummarizeRequest(text=text, m=5)]
    treqs = _given_requests(tapi) + [SummarizeRequest(text=text, m=5)]
    with JEngine(JSolveConfig(**cfg), pool_workers=2, seed=0) as jeng:
        want = jeng.run_batch(jreqs, seed=3)
    with SummarizationEngine(SolveConfig(**cfg), pool_workers=2, seed=0, device="cpu") as teng:
        assert type(teng.backend).__name__ == "ThreadPoolBackend"
        got = teng.run_batch(treqs, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.selection, w.selection)
        assert g.selected == w.selected
        assert (g.request_id, g.solver_invocations, g.reads_used, g.workload) == (
            w.request_id, w.solver_invocations, w.reads_used, w.workload)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.objective == w.objective
    np.testing.assert_allclose(got[-1].objective, want[-1].objective, rtol=1e-5)


def test_engine_under_cobi_equals_inline_solves_keyed_by_fold_in():
    """The port's engine with CobiFarm(2): every response equals solve_es on
    the same problem, keyed fold_in(key(seed), request_id), bit for bit,
    the decomposed request (N 70 > 59) included (its pipelined windows
    speculate, so it may count more invocations than the inline run)."""
    cfg = SolveConfig(solver="cobi", iterations=2, reads=6, int_range=14, steps=100,
                      p=20, q=10)
    reqs = [SummarizeRequest(text=" ".join(synthetic_document(500 + i, n)), m=5)
            for i, n in enumerate((14, 18, 12))]
    big = synthetic_benchmark(4, 70, 6, lam=0.5)
    reqs.append(tapi.SelectionRequest(
        items=[f"item {k}" for k in range(70)],
        kofn=tapi.KofnSpec(m=6, lam=0.5, relevance="given", mu=np.asarray(big.mu).tolist(),
                           beta=np.asarray(big.beta))))
    with SummarizationEngine(cfg, farm=CobiFarm(2, device="cpu"), seed=0,
                             device="cpu") as eng:
        got = eng.run_batch(reqs, seed=5)
        jobs = eng.farm.stats().jobs_completed
    assert jobs > 0
    enc = HashedBowEncoder()
    for resp, req in zip(got, reqs):
        sel = eng._to_selection(req)
        texts = tapi.encode_texts(sel.kofn, sel.items)
        e = enc.encode(texts) if texts else None
        problem = tapi.problem_from_embeddings(sel.kofn, sel.items, e, device="cpu")
        c = dataclasses.replace(cfg, decompose=problem.n > 59)
        want = solve_es(problem, prng.fold_in(prng.key(5), resp.request_id), c, device="cpu")
        np.testing.assert_array_equal(resp.selection, want.selection)
        assert resp.objective == want.objective
    assert got[-1].selection.sum() == 6 and got[-1].solver_invocations > cfg.iterations


def test_serve_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 3
    assert "unclosed_spans=0" in lines[-1]


def _meters(eng, responses):
    recs = eng.obs.tracer.records()
    snap = eng.obs.registry.snapshot()
    farm_stats = eng.farm.stats()
    jobs = [r for r in recs if r["kind"] == "span" and r["name"] == "farm.job"]
    return dict(
        span_chip_s=sum(r["attrs"]["chip_seconds"] for r in jobs),
        hist_chip_s=sum(s["sum"] for s in snap["farm_job_chip_seconds"]["series"]),
        span_joules=sum(r["attrs"]["energy_joules"] for r in jobs),
        hist_joules=sum(s["sum"] for s in snap["farm_job_energy_joules"]["series"]),
        span_bytes=(sum(r["attrs"]["bytes_h2d"] for r in jobs),
                    sum(r["attrs"]["bytes_d2h"] for r in jobs)),
        farm_bytes=(farm_stats.bytes_h2d, farm_stats.bytes_d2h),
        jobs=(len(jobs), farm_stats.jobs_completed),
        unclosed=eng.stats()["obs"]["unclosed_spans"],
        selections=[r.selection.tolist() for r in responses],
    )


def test_engine_meter_conservation_matches_the_reference():
    """The twin of test_obs.py::test_engine_meter_conservation_bitwise,
    held to what the reference does rather than to that test's bar: the
    reference sums its receipts' chip seconds per histogram series in
    another order than per span, so the two sums may differ in the last
    bit.  The port must fold the same receipts into the same sums, bit for
    bit, wherever the reference's sums land; its integer meters (bytes,
    jobs) must be conserved exactly."""
    cfg = dict(solver="cobi", iterations=2, reads=6, int_range=14, steps=100, p=20, q=10)
    docs = [" ".join(synthetic_document(500 + i, n)) for i, n in enumerate([14, 70, 18, 12])]
    with JEngine(JSolveConfig(**cfg), farm=JFarm(2, impl="ref"), seed=0) as jeng:
        want = _meters(jeng, jeng.run_batch(
            [JSummarizeRequest(text=d, m=5, request_id=i + 1) for i, d in enumerate(docs)]))
    with SummarizationEngine(SolveConfig(**cfg), farm=CobiFarm(2, device="cpu"), seed=0,
                             device="cpu") as teng:
        got = _meters(teng, teng.run_batch(
            [SummarizeRequest(text=d, m=5, request_id=i + 1) for i, d in enumerate(docs)]))
    keys = ("span_chip_s", "hist_chip_s", "span_joules", "hist_joules", "span_bytes",
            "farm_bytes", "jobs", "unclosed")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["span_bytes"] == got["farm_bytes"] and got["jobs"][0] == got["jobs"][1]
    assert got["unclosed"] == 0
