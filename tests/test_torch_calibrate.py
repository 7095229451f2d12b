"""The port's calibration fit (``repro_torch.launch.calibrate``, the twin of
the reference's ``benchmarks/calibrate.py``) against the reference's
``repro.serving.calibration.calibrate_profile``, on the CPU.

Each package runs the tiny sweep (sizes 8 and 12, 2 benchmarks, 4
iterations, 100 steps) with the Tabu pool and the MCMC bank once, the
reference through ``calibrate_profile``, the port through ``run`` (warm-up,
fit, save, round trip).  Bars: every model's quality knots and the hardware
constants the fit does not touch are equal; the pool's latency fit is host
wall time, so it differs by nature and is held only to be finite; each
package's saved profile loads in the other with equal predictions and equal
router decisions (pure float64 Python).  The command line runs on the CPU
with ``--device cpu`` and raises without a card otherwise.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.serving import calibration as jcal
from repro.serving import router as jrt
from repro_torch.launch import calibrate as tlaunch
from repro_torch.serving import calibration as tcal
from repro_torch.serving import router as trt

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("farm", "pool", "mcmc")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both packages' tiny Tabu-pool + MCMC fits, saved: (profile, path)."""
    out = tmp_path_factory.mktemp("calibrate")
    jprof = jcal.calibrate_profile(pool_solver="tabu", mcmc_workers=4, **tlaunch.TINY)
    jpath = out / "reference.json"
    jprof.save(str(jpath))
    tpath = out / "port.json"
    tprof = tlaunch.run(tiny=True, out=str(tpath), pool_solver="tabu", backend="mcmc",
                        device="cpu")
    return SimpleNamespace(ref=jprof, port=tprof, ref_path=jpath, port_path=tpath)


@pytest.mark.parametrize("name", MODELS)
def test_quality_knots_equal_the_reference(fits, name):
    jm, tm = fits.ref.model(name), fits.port.model(name)
    assert tm.quality_n == jm.quality_n == (8, 12)
    assert tm.quality_p == jm.quality_p
    assert all(0.0 <= p <= 1.0 for p in tm.quality_p)


@pytest.mark.parametrize("name", MODELS)
def test_hardware_constants_equal_the_reference(fits, name):
    jm, tm = fits.ref.model(name), fits.port.model(name)
    for field in ("kind", "solver", "seconds_per_solve", "power_w", "parallelism",
                  "lanes_per_chip", "reads_ref", "steps_ref", "steps_scale"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert fits.port.meta == fits.ref.meta  # no card on the CPU: the fit's own meta


def test_pool_latency_fit_is_finite(fits):
    pool = fits.port.model("pool")
    assert pool.solver == "tabu" and pool.steps_ref == 100
    assert all(math.isfinite(c) for c in pool.lat_coef)
    for n in range(8, 60):
        assert math.isfinite(pool.invocation_seconds(n, 8, 100))
        assert math.isfinite(pool.request_seconds([(n, 8)] * 4, 100))


def _router_decisions(cal, rt, path) -> list:
    """Router decisions over a few requests and slacks from one profile file."""

    class _Backend:
        def capacity_hint(self):
            return SimpleNamespace(est_queue_seconds=0.001)

        def fault_rate(self):
            return 0.0

    profile = cal.CalibrationProfile.load(str(path))
    router = rt.BackendRouter({name: _Backend() for name in profile.models}, profile,
                              rt.RouterConfig(primary="farm"))
    out = []
    for jobs in ([(8, 8)] * 4, [(12, 8)] * 6, [(40, 64)] * 8, [(59, 8)] * 3):
        for slack in (None, 0.5, 0.01, 0.002, 1e-5):
            for floor in (None, 0.1):
                try:
                    d = router.decide(jobs, steps=400, iterations=4, deadline_slack=slack,
                                      quality_floor=floor)
                    out.append(dataclasses.asdict(d))
                except rt.InfeasibleRoute as exc:
                    out.append(("infeasible", str(exc)))
    out.append(router.stats())
    return out


@pytest.mark.parametrize("source", ["reference", "port"])
def test_saved_profiles_cross_both_ways(fits, source):
    path = fits.ref_path if source == "reference" else fits.port_path
    jp, tp = jcal.CalibrationProfile.load(str(path)), tcal.CalibrationProfile.load(str(path))
    assert tp.to_json() == jp.to_json()
    for name in MODELS:
        for n in (2, 8, 12, 20, 40, 59):
            for jobs in ([(n, 8)], [(n, 8)] * 6, [(n, 64)] * 3):
                assert tp.model(name).request_seconds(jobs, 400) == \
                    jp.model(name).request_seconds(jobs, 400)
                assert tp.model(name).request_energy(jobs, 300) == \
                    jp.model(name).request_energy(jobs, 300)
    assert _router_decisions(tcal, trt, path) == _router_decisions(jcal, jrt, path)


def test_launcher_runs_on_the_cpu(tmp_path):
    out = tmp_path / "profile.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.calibrate", "--tiny", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = run.stdout.splitlines()
    assert lines[0].startswith("warm-up: ")
    sizes = [line for line in lines if line.startswith("n=")]
    assert [line.split()[0] for line in sizes] == ["n=", "n="]
    assert [int(line.split()[1]) for line in sizes] == [8, 12]
    assert all("pool_s=" in line and "farm_s=" in line and "p_succ=" in line for line in sizes)
    assert lines[-1].startswith(f"wrote {out} (schema 1, models ['farm', 'pool'])")
    prof = tcal.CalibrationProfile.load(str(out))
    assert prof.meta["pool_solver"] == "cobi" and prof.meta["sizes"] == [8, 12]
    assert jcal.CalibrationProfile.load(str(out)).to_json() == prof.to_json()


def test_launcher_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.run(tiny=True, device=device)


def test_launcher_imports_nothing_of_jax():
    src = (ROOT / "src" / "repro_torch" / "launch" / "calibrate.py").read_text()
    assert "jax" not in src and "from repro." not in src and "import repro\n" not in src
    code = ("import sys; import repro_torch.launch.calibrate; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro'))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120, check=True)
    assert run.stdout.strip() == "[]"
