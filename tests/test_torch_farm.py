"""The port's chip farm on the CPU (the kernels' plain versions) against the
JAX package's farm, plus the invariants the reference proves of its farm,
held inside the port.

Bars: packing, tiering, fault decisions, validation verdicts, breaker
traces, receipts, placement and byte metering equal the reference's bit for
bit; a job's farm result equals the port's own solo ``cobi`` solve on the
same instance and key bit for bit (packed == solo, fused == two-launch +
first argmin, background policies == manual); batched phases agree with the
reference's within rtol = atol = 2e-4 at 50 steps (its kernel-vs-oracle
bound); energies of returned spins are exact on re-scoring.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import farm as jfarm
from repro.core.formulation import IsingProblem as JIsing
from repro.farm import scheduler as jsched
from repro.kernels import ops as jops
from repro_torch import farm as tfarm
from repro_torch.core.formulation import IsingProblem
from repro_torch.farm import scheduler as tsched
from repro_torch.interop import carry_across
from repro_torch.kernels import cobi_dynamics as tcobi
from repro_torch.kernels import ops as tops
from repro_torch.solvers import cobi as tsolver

STEPS = 60


def _hj(seed, n):
    """Chip-range integer instance (h, J) as numpy float32."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-14, 15, n).astype(np.float32)
    j = np.triu(rng.integers(-14, 15, (n, n)), 1).astype(np.float32)
    return h, j + j.T


def _pair(seed, n):
    """The same instance for both packages."""
    h, j = _hj(seed, n)
    return (JIsing(h=jnp.asarray(h), j=jnp.asarray(j)),
            IsingProblem(h=torch.from_numpy(h), j=torch.from_numpy(j)))


def _tkey(jkey):
    return carry_across("key", np.asarray(jax.random.key_data(jkey)))


def _keys(seed, k):
    jk = [jax.random.fold_in(jax.random.key(seed), i) for i in range(k)]
    return jk, [_tkey(x) for x in jk]


def _equal(a, b):
    return torch.equal(a.spins, b.spins) and torch.equal(a.energies, b.energies)


# ---------------------------------------------------------------- packing


@pytest.mark.parametrize("sizes,capacity", [
    ([59, 40, 20, 12, 59, 33, 7], 128),
    ([1] * 10 + [59, 59, 3], 128),
    ([120, 100, 30, 7], 256),
])
def test_pack_instances_matches_reference(sizes, capacity):
    pairs = [_pair(i, n) for i, n in enumerate(sizes)]
    want = jfarm.pack_instances([(i, jp) for i, (jp, _) in enumerate(pairs)], capacity)
    got = tfarm.pack_instances([(i, tp) for i, (_, tp) in enumerate(pairs)], capacity)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [dataclasses.astuple(s) for s in g.slots] == [dataclasses.astuple(s) for s in w.slots]
        for name in ("h_scaled", "j_scaled", "h_orig", "j_orig"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert g.occupancy == w.occupancy


@pytest.mark.parametrize("sizes,reads", [
    ([59, 40, 20, 12, 59, 33, 7, 64], [8, 6, 12, 64, 60, 8, 1, 0]),
    ([10, 14, 18, 22, 26, 30, 34, 38, 12, 16, 20], [8] * 11),
])
def test_estimate_packing_and_tiers_match_reference(sizes, reads):
    for cap in (128, 256):
        want, got = jfarm.estimate_packing(sizes, cap), tfarm.estimate_packing(sizes, cap)
        assert (got.bins, got.lanes_used) == (want.bins, want.lanes_used)
        assert got.closed_bins(0.9) == want.closed_bins(0.9)
    for ratio in (1.0, 2.0, 8.0):
        assert tfarm.replica_tiers(reads, ratio=ratio) == jfarm.replica_tiers(reads, ratio=ratio)
    assert [tsched._batch_pad(b) for b in range(1, 14)] == [jsched._batch_pad(b) for b in range(1, 14)]


# ------------------------------------------------------- faults and health


def test_fault_plan_decisions_match_reference():
    kw = dict(seed=7, drain_timeout_rate=0.2, chip_transient_rate=0.3,
              failed_chips=(2,), bitflip_rate=0.2, corrupt_rate=0.1, stuck_lane_rate=0.05)
    jp, tp = jfarm.FaultPlan(**kw), tfarm.FaultPlan(**kw)
    for ids in ([0], [1, 2, 3], list(range(40))):
        assert tp.drain_timeout(ids) == jp.drain_timeout(ids)
    for chip in range(4):
        assert tp.stuck_lanes(chip, 128) == jp.stuck_lanes(chip, 128)
        assert [tp.chip_failed(chip, c) for c in range(20)] == [jp.chip_failed(chip, c) for c in range(20)]
    spins = np.where(np.random.default_rng(0).random((4, 30)) < 0.5, 1, -1).astype(np.int8)
    energies = np.arange(4, dtype=np.float32)
    for job in range(60):
        assert tp.readout_fault(job) == jp.readout_fault(job)
        gs, ge, gk = tp.corrupt_readout(job, spins, energies)
        ws, we, wk = jp.corrupt_readout(job, spins, energies)
        assert gk == wk
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(ge, we)


@pytest.mark.parametrize("kind", ["clean", "bitflip", "corrupt", "non-integer"])
def test_validate_readout_verdicts_match_reference(kind):
    h, j = _hj(3, 25)
    spins = np.where(np.random.default_rng(1).random((3, 25)) < 0.5, 1, -1).astype(np.int8)
    energies = tfarm.ising_energy_np(spins, h, j).astype(np.float32)
    if kind == "non-integer":
        h = h + np.float32(0.25)
        energies = energies + np.float32(1.0)
    if kind in ("bitflip", "corrupt"):
        spins = spins.copy()
        spins[:, 4] = -spins[:, 4]
        if kind == "corrupt":
            spins[:, 9] = -spins[:, 9]
            energies = energies + np.float32(0.5)
    got = tfarm.validate_readout(spins, energies, h, j)
    want = jfarm.validate_readout(spins, energies, h, j)
    assert (got.status, got.detail, got.repaired_reads, got.candidates) == (
        want.status, want.detail, want.repaired_reads, want.candidates)
    np.testing.assert_array_equal(got.spins, want.spins)
    np.testing.assert_array_equal(got.energies, want.energies)


def test_breakers_and_health_give_reference_state_traces():
    outcomes = ["ok", "failed", "failed", "degraded", "failed", "ok", "failed",
                "failed", "failed", "ok", "ok", "degraded", "failed", "ok"]
    cfg = dict(consecutive_failures=2, cooldown=0.002, min_events=3)
    traces = []
    for pkg in (tfarm, jfarm):
        health = pkg.FarmHealth(4, pkg.BreakerConfig(**cfg))
        breaker = pkg.ChipBreaker(pkg.BreakerConfig(**cfg))
        trace = []
        for step, outcome in enumerate(outcomes):
            now = step * 0.001
            health.record(step % 3, outcome, now)
            breaker.record(outcome, now)
            trace.append((breaker.state(now), breaker.trips, health.states(now),
                          health.schedule(5, now), health.available_chips(now),
                          health.quarantined(now), health.stats(now)))
        traces.append(trace)
    assert traces[0] == traces[1]


# ---------------------------------------------- inside the port: exactness


@pytest.mark.parametrize("reduce", ["none", "best"])
def test_farm_job_equals_its_solo_solve(reduce):
    """Packed at any lane offset, a job's result equals the port's solo
    ``cobi`` solver on the same instance and key, bit for bit; and a job
    alone on the farm equals the same job packed with binmates."""
    sizes_reads = [(59, 8), (41, 8), (20, 6), (12, 8), (33, 16)]
    pairs = [_pair(10 + i, n) for i, (n, _) in enumerate(sizes_reads)]
    _, keys = _keys(0, len(pairs))
    farm = tfarm.CobiFarm(2, device="cpu")
    futs = [farm.submit(tp, k, reads=r, steps=STEPS, reduce=reduce)
            for (_, tp), k, (_, r) in zip(pairs, keys, sizes_reads)]
    farm.drain()
    for (_, tp), k, (_, r), fut in zip(pairs, keys, sizes_reads, futs):
        solo = tsolver.solve(tp, k, reads=r, steps=STEPS, reduce=reduce)
        assert _equal(fut.result(), solo)
    alone = tfarm.CobiFarm(1, device="cpu")
    fut = alone.submit(pairs[1][1], keys[1], reads=8, steps=STEPS, reduce=reduce)
    alone.drain()
    assert futs[1].receipt().lanes == 41 and _equal(fut.result(), futs[1].result())


def test_fused_drain_equals_two_launch_drain_plus_first_argmin():
    """Ragged read counts over two replica tiers: every job's fused winner
    is the all-reads drain's first argmin, bit for bit, and its energy is
    exact on re-scoring."""
    sizes_reads = [(40, 6), (59, 8), (20, 12), (30, 64), (12, 60), (25, 8)]
    pairs = [_pair(100 + i, n) for i, (n, _) in enumerate(sizes_reads)]
    _, keys = _keys(5, len(pairs))
    results = {}
    for mode in ("none", "best"):
        farm = tfarm.CobiFarm(2, device="cpu")
        futs = [farm.submit(tp, k, reads=r, steps=STEPS, reduce=mode)
                for (_, tp), k, (_, r) in zip(pairs, keys, sizes_reads)]
        farm.drain()
        results[mode] = [f.result() for f in futs]
        assert farm.stats().super_instances >= 2  # two tiers ran
    for (_, r), (_, tp), rn, rb in zip(sizes_reads, pairs, results["none"], results["best"]):
        assert rn.energies.shape == (r,) and rb.spins.shape == (1, tp.n)
        a = int(np.argmin(rn.energies.numpy()))
        assert torch.equal(rb.spins[0], rn.spins[a])
        assert float(rb.energies[0]) == float(rn.energies[a])
        rescored = tops.ising_energy(rb.spins, tp.h, tp.j)
        assert torch.equal(rescored, rb.energies)


def test_ragged_batch_padding_is_inert():
    """Three bins pad to a batch of four: the zero bin changes no result and
    bills no chip time."""
    pairs = [_pair(200 + i, 59) for i in range(6)]
    _, keys = _keys(9, 6)
    farm = tfarm.CobiFarm(4, device="cpu")
    futs = [farm.submit(tp, k, reads=8, steps=STEPS, reduce="best")
            for (_, tp), k in zip(pairs, keys)]
    farm.drain()
    assert tsched._batch_pad(3) == 4 and farm.stats().super_instances == 3
    for (_, tp), k, fut in zip(pairs, keys, futs):
        assert _equal(fut.result(), tsolver.solve(tp, k, reads=8, steps=STEPS, reduce="best"))


def test_a_bin_of_one_spin_jobs_takes_one_slot_per_lane():
    """100 one-spin jobs share one bin: 100 slots (padded to 104), each equal
    to its solo solve."""
    rng = np.random.default_rng(4)
    probs = [IsingProblem(h=torch.tensor([float(v)]), j=torch.zeros((1, 1)))
             for v in rng.choice([-3, -1, 2, 5], 100)]
    _, keys = _keys(4, 100)
    farm = tfarm.CobiFarm(1, device="cpu")
    futs = [farm.submit(p, k, reads=8, steps=30, reduce="best") for p, k in zip(probs, keys)]
    farm.drain()
    assert farm.stats().super_instances == 1
    for p, k, fut in zip(probs, keys, futs):
        assert _equal(fut.result(), tsolver.solve(p, k, reads=8, steps=30, reduce="best"))
    with pytest.raises(ValueError, match="1 to 128 slots"):
        tcobi._check_fused(*(torch.zeros(s) for s in (
            (1, 128, 128), (1, 1, 128), (1, 128, 129), (1, 1, 129))), b=1, n=128)


@pytest.mark.parametrize("policy", ["bin-full", "timer", "deadline"])
def test_background_policy_results_equal_manual(policy):
    pairs = [_pair(300 + i, n) for i, n in enumerate([30, 45, 20, 59, 12, 33])]
    _, keys = _keys(2, len(pairs))

    def run(pol):
        farm = tfarm.CobiFarm(2, device="cpu", policy=pol, linger=0.01, timer_interval=0.01)
        futs = [farm.submit(tp, k, reads=8, steps=STEPS, reduce="best", deadline=1.0)
                for (_, tp), k in zip(pairs, keys)]
        if pol == "manual":
            with pytest.raises(tfarm.FarmPendingError):
                futs[0].result()
            farm.drain()
        out = [f.result(timeout=60) for f in futs]
        farm.close()
        return out

    for a, b in zip(run("manual"), run(policy)):
        assert _equal(a, b)


# ----------------------------------------------------- against the JAX farm


@pytest.mark.parametrize("mode", ["none", "best", "chaos"])
def test_receipts_bins_and_placement_match_jax_farm(mode):
    """Same jobs, same keys: bins, tiers, chip placement, sim clock, energy,
    byte metering and every receipt equal the reference farm's; under a
    chip-fault plan the same jobs fail the same way.  Energies of the
    returned spins are exact on re-scoring."""
    sizes_reads = [(59, 8), (40, 8), (20, 6), (12, 8), (59, 8), (33, 48), (7, 40), (25, 8)]
    pairs = [_pair(400 + i, n) for i, (n, _) in enumerate(sizes_reads)]
    jkeys, tkeys = _keys(11, len(pairs))
    reduce = "none" if mode == "none" else "best"
    kw = dict(policy="manual")
    plan = dict(seed=3, chip_transient_rate=0.4, failed_chips=(1,)) if mode == "chaos" else None
    jf = jfarm.CobiFarm(3, impl="ref", faults=plan and jfarm.FaultPlan(**plan), **kw)
    tf = tfarm.CobiFarm(3, device="cpu", faults=plan and tfarm.FaultPlan(**plan), **kw)
    outs = []
    for farm, keys, pick in ((jf, jkeys, 0), (tf, tkeys, 1)):
        futs = [farm.submit(pair[pick], k, reads=r, steps=STEPS, reduce=reduce, priority=i % 2,
                            tag=100 + i)
                for i, (pair, k, (_, r)) in enumerate(zip(pairs, keys, sizes_reads))]
        farm.drain()
        rows = []
        for f in futs:
            try:
                f.result()
                rows.append(("ok", f.receipt()))
            except jfarm.FarmFault as exc:  # the reference's class
                rows.append((type(exc).__name__, exc.receipt))
            except tfarm.FarmFault as exc:
                rows.append((type(exc).__name__, exc.receipt))
        outs.append((rows, farm.stats(), futs))
    (jrows, jstats, _), (trows, tstats, tfuts) = outs
    assert [(k, dataclasses.asdict(r)) for k, r in trows] == [(k, dataclasses.asdict(r)) for k, r in jrows]
    for name in ("jobs_completed", "super_instances", "drains", "sim_seconds",
                 "energy_joules", "bytes_h2d", "bytes_d2h", "fault_counts", "quarantined"):
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert [dataclasses.asdict(c) for c in tstats.chips] == [dataclasses.asdict(c) for c in jstats.chips]
    if mode == "chaos":
        assert any(k != "ok" for k, _ in trows)
    for (jp, _), (kind, _), fut in zip(pairs, trows, tfuts):
        if kind == "ok":
            res = fut.result()
            want = jops.ising_energy(jnp.asarray(res.spins.numpy()), jp.h, jp.j, impl="ref")
            np.testing.assert_array_equal(res.energies.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,r,n", [(2, 8, 128), (3, 16, 59)])
def test_batched_phases_match_reference(b, r, n):
    pairs = [_pair(500 + i, n) for i in range(b)]
    scale = lambda h, j: np.float32(2 * np.abs(j).sum(-1).max() + np.abs(h).max())
    hs = np.stack([np.asarray(jp.h) / scale(np.asarray(jp.h), np.asarray(jp.j)) for jp, _ in pairs])
    js = np.stack([np.asarray(jp.j) / scale(np.asarray(jp.h), np.asarray(jp.j)) for jp, _ in pairs])
    phi0 = np.array(jax.random.uniform(jax.random.key(r), (b, r, n), maxval=2 * jnp.pi))
    want = jops.cobi_trajectory_batch(jnp.asarray(js), jnp.asarray(hs), jnp.asarray(phi0),
                                      steps=50, dt=0.35, ks_max=1.2, impl="pallas")
    got = tops.cobi_trajectory_batch(*(torch.from_numpy(a) for a in (js, hs, phi0)),
                                     steps=50, dt=0.35, ks_max=1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_stacked_energies_match_reference_exactly():
    b, r, n = 3, 12, 40
    h, j = (np.stack(x) for x in zip(*(_hj(600 + i, n) for i in range(b))))
    spins = np.where(np.random.default_rng(2).random((b, r, n)) < 0.5, 1, -1).astype(np.int8)
    want = jops.ising_energy(jnp.asarray(spins), jnp.asarray(h), jnp.asarray(j), impl="pallas")
    got = tops.ising_energy(*(torch.from_numpy(a) for a in (spins, h, j)))
    assert got.shape == (b, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prescaled", [False, True])
def test_anneal_batch_best_equals_none_plus_first_argmin(prescaled):
    b, n = 3, 30
    h, j = (torch.from_numpy(np.stack(x)) for x in zip(*(_hj(700 + i, n) for i in range(b))))
    key = _tkey(jax.random.key(3))
    spins, energies = tops.cobi_anneal_batch(h, j, key, replicas=12, steps=STEPS,
                                             ks_max=1.2, prescaled=prescaled)
    best_s, best_e = tops.cobi_anneal_batch(h, j, key, replicas=12, steps=STEPS, ks_max=1.2,
                                            prescaled=prescaled, reduce="best")
    assert spins.shape == (b, 12, n) and best_s.shape == (b, n)
    for i in range(b):
        a = int(np.argmin(energies[i].numpy()))
        assert torch.equal(best_s[i], spins[i, a]) and float(best_e[i]) == float(energies[i, a])


def test_prewarm_sweeps_the_reference_lattice():
    kw = dict(reads=(8,), steps=2, max_bins=2, max_slots=9)
    farm = tfarm.CobiFarm(2, device="cpu")
    launches = farm.prewarm(**kw)
    assert launches == jfarm.CobiFarm(2, impl="ref").prewarm(**kw) > 0
    stats = farm.stats()
    assert stats.jobs_completed == 0 and stats.super_instances == 0 and stats.bytes_h2d == 0


def test_solve_batch_and_solve_many_agree():
    pairs = [_pair(800 + i, n) for i, n in enumerate([30, 45, 20])]
    _, keys = _keys(8, 3)
    probs = [tp for _, tp in pairs]
    a = tsolver.solve_batch(probs, keys, n_chips=2, steps=STEPS, device="cpu", reduce="best")
    b = tfarm.solve_many(probs, keys, n_chips=1, steps=STEPS, device="cpu", reduce="best",
                         policy="timer")
    assert all(_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="reduce"):
        tfarm.CobiFarm(1, device="cpu").submit(probs[0], keys[0], reduce="topk")
    with pytest.raises(ValueError, match="decompose"):
        tfarm.CobiFarm(1, device="cpu").submit(_pair(0, 60)[1], keys[0])


def test_farm_without_a_device_asks_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfarm.CobiFarm()
