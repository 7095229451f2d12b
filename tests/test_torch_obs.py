"""The port's copy of the observability package against the reference's:
the same call sequence gives the same Chrome trace, Prometheus text and
flight-recorder dump, and the port's farm, traced, exports what the JAX
farm exports for the same jobs.

Both tracers run on one deterministic clock (each reading advances it by
1 ms), so the comparison is exact.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import obs as jobs
from repro.core.formulation import IsingProblem as JIsing
from repro.farm import CobiFarm as JFarm
from repro_torch import obs as tobs
from repro_torch.core.formulation import IsingProblem
from repro_torch.farm import CobiFarm
from repro_torch.interop import carry_across


def _tick(tracer):
    counter = itertools.count()
    tracer.now = lambda: next(counter) * 1e-3
    return tracer


def _exercise(pkg):
    """One call sequence over a whole Observability bundle."""
    o = pkg.Observability(capacity=64)
    tr = _tick(o.tracer)
    root = tr.span("request", trace_id=7, track="engine", size=20)
    tr.register_root(7, root)
    with root.child("request.solve", sim_t0=0.0) as solve:
        solve.event("recovery.fault", sim_t=0.001, kind="ChipFailure")
        solve.set(windows=2)
    tr.emit_span("farm.job", trace_id=7, parent=tr.root_id(7), track="chip1",
                 sim_t0=0.0, sim_t1=0.0016, lanes=20, faults=("stuck-lane",))
    tr.event("admission.admit", trace_id=8, track="engine", slack=0.5)
    open_span = tr.span("request", trace_id=8, track="engine")
    root.end(sim_t1=0.002, outcome="ok")
    reg = o.registry
    c = reg.counter("farm_bytes_total", "bytes", labels=("direction",))
    c.labels(direction="h2d").inc(1024)
    c.labels(direction="d2h").inc(16)
    reg.gauge("chips_quarantined", "open breakers").set(1)
    hist = reg.histogram("farm_job_energy_joules", "energy per job")
    for v in (1e-6, 4e-6, 3.2e-5, 0.5):
        hist.observe(v)
    return o, open_span


def test_trace_metrics_and_recorder_match_reference():
    (jo, jopen), (to, topen) = _exercise(jobs), _exercise(tobs)
    assert tobs.chrome_trace(to.tracer) == jobs.chrome_trace(jo.tracer)
    assert tobs.chrome_trace(to.tracer, trace_id=7, t0=0.002) == jobs.chrome_trace(
        jo.tracer, trace_id=7, t0=0.002)
    assert tobs.validate_chrome_trace(tobs.chrome_trace(to.tracer)) > 0
    assert tobs.prometheus_text(to.registry) == jobs.prometheus_text(jo.registry)
    assert to.registry.snapshot() == jo.registry.snapshot()
    assert to.recorder.dump(7) == jo.recorder.dump(7)
    assert to.tracer.unclosed_spans() == jo.tracer.unclosed_spans() == 1
    topen.end()
    jopen.end()
    assert to.tracer.unclosed_spans() == 0


def test_traced_farm_exports_what_the_jax_farm_exports():
    """Drain spans (pack, place, launch, readout, per-job receipts) and the
    farm's metric families come out the same for the same jobs."""
    rng = np.random.default_rng(0)
    insts = []
    for n in (59, 40, 20, 33):
        h = rng.integers(-14, 15, n).astype(np.float32)
        j = np.triu(rng.integers(-14, 15, (n, n)), 1).astype(np.float32)
        insts.append((h, j + j.T))
    keys = [jax.random.fold_in(jax.random.key(1), i) for i in range(len(insts))]
    exports = []
    for pkg, make, wrap in (
        (jobs, lambda o: JFarm(2, impl="ref", obs=o),
         lambda h, j, k: (JIsing(h=jnp.asarray(h), j=jnp.asarray(j)), k)),
        (tobs, lambda o: CobiFarm(2, device="cpu", obs=o),
         lambda h, j, k: (IsingProblem(h=torch.from_numpy(h), j=torch.from_numpy(j)),
                          carry_across("key", np.asarray(jax.random.key_data(k))))),
    ):
        o = pkg.Observability()
        _tick(o.tracer)
        farm = make(o)
        for i, ((h, j), k) in enumerate(zip(insts, keys)):
            farm.submit(*wrap(h, j, k), reads=8, steps=20, reduce="best", tag=i)
        farm.drain()
        exports.append((pkg.chrome_trace(o.tracer), pkg.prometheus_text(o.registry)))
    assert exports[0] == exports[1]
    assert any(e["name"] == "farm.launch" for e in exports[1][0]["traceEvents"])
