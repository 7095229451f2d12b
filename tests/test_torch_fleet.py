"""The port's explicit-collective Ising fleet (``distributed.fleet``) on
the CPU, held against the JAX package's ``repro.distributed.fleet``.

One gloo rank (a file store under ``tmp_path``, in this process) against
the reference's ``fleet_solve`` on tests/test_fleet.py's instances, and four
gloo ranks (data 2 x model 2, in subprocesses) against one.

Bars: phi0 bit for bit with ``jax.random.uniform``; the reference's
quality bar (each best energy within 10% of the exact minimum's span) and
its check that each reported energy is its spins' energy (rtol 1e-5, the
pre-scaling's rounding); at 50 steps, on instances whose pre-scaling is a
power of two (so every energy is exact), spins and energies equal the
reference's wherever no phase lies within 2e-4 of the readout boundary
(the trajectories' bound at 50 steps, tests/test_kernels_ising.py); four
ranks equal one bit for bit.
"""

import contextlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.distributed.fleet import fleet_solve as jfleet_solve
from repro.kernels import ref as jkref
from repro_torch import prng
from repro_torch.distributed import fleet
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_fleet import _exact_min, _instances  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

PHASE_TOL = 2e-4


@contextlib.contextmanager
def one_rank(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store1'}", rank=0,
                            world_size=1)
    try:
        yield tmesh.make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _pow2_instances(d=3, n=12, seed=5):
    """Chip-integer instances with one h entry raised so the fleet's
    pre-scaling denominator is a power of two: the scaled inputs and every
    energy are exact."""
    rng = np.random.default_rng(seed)
    u = np.triu(rng.integers(-14, 15, (d, n, n)), 1)
    j = (u + u.transpose(0, 2, 1)).astype(np.float32)
    h = rng.integers(-14, 15, (d, n)).astype(np.float32)
    row = 2 * np.abs(j).sum(-1).max(-1)
    target = 2.0 ** np.ceil(np.log2(row + np.abs(h).max(-1)))
    h[:, 0] = np.sign(h[:, 0] + 0.5) * (target - row)
    return h, j


def test_phi0_block_is_jax_uniform():
    """Each rank's block of phi0 (``prng.uniform_at`` of its flat indices)
    is the block of jax.random.uniform's global draw, bit for bit."""
    d, r, n = 4, 16, 12
    want = np.asarray(jax.random.uniform(jax.random.key(3), (d, r, n), jnp.float32,
                                         0.0, 2.0 * jnp.pi))
    key = prng.key(3)
    for block in [(slice(None), slice(None), slice(None)),
                  (slice(2, 4), slice(8, 16), slice(None)),
                  (slice(0, 2), slice(0, 8), slice(None))]:
        got = prng.uniform_at(key, prng.block_index((d, r, n), block), 0.0, 2.0 * math.pi)
        np.testing.assert_array_equal(got.numpy(), want[block])


def test_fleet_one_rank_quality_and_energies(tmp_path):
    """tests/test_fleet.py's bar on its instances, 16 replicas, 300 steps."""
    h, j = _instances()
    with one_rank(tmp_path) as mesh:
        spins, energies = fleet.fleet_solve(
            mesh, torch.from_numpy(np.array(h)), torch.from_numpy(np.array(j)),
            prng.key(0), replicas_per_device=16, steps=300)
    assert spins.dtype == torch.int8 and spins.shape == (3, 12) and energies.shape == (3,)
    s = spins.numpy().astype(np.float64)
    hn, jn = np.asarray(h, np.float64), np.asarray(j, np.float64)
    for d in range(3):
        exact = _exact_min(h[d], j[d])
        span = abs(exact) + 1.0
        assert float(energies[d]) <= exact + 0.10 * span, (float(energies[d]), exact)
        e_check = s[d] @ hn[d] + s[d] @ jn[d] @ s[d]
        np.testing.assert_allclose(e_check, float(energies[d]), rtol=1e-5)
    assert fleet.COLLECTIVES["all_reduce"] >= 3 and fleet.COLLECTIVES["all_gather"] >= 2


def test_fleet_one_rank_matches_reference_at_50_steps(tmp_path):
    """Spins and energies equal the reference's fleet_solve wherever the
    document's phases are clear of the readout boundary; every energy is
    its spins' exact energy."""
    h, j = _pow2_instances()
    kw = dict(replicas_per_device=8, steps=50)
    want_s, want_e = jfleet_solve(jax.make_mesh((1, 1), ("data", "model")), jnp.asarray(h),
                                  jnp.asarray(j), jax.random.key(0), **kw)
    with one_rank(tmp_path) as mesh:
        got_s, got_e = fleet.fleet_solve(mesh, torch.from_numpy(h), torch.from_numpy(j),
                                         prng.key(0), **kw)
    s = got_s.numpy().astype(np.float64)
    exact = np.einsum("dn,dn->d", s, h) + np.einsum("di,dij,dj->d", s, j, s)
    np.testing.assert_array_equal(got_e.numpy(), exact.astype(np.float32))
    denom = 2 * np.abs(j).sum(-1).max(-1) + np.abs(h).max(-1)
    phi0 = np.asarray(jax.random.uniform(jax.random.key(0), (3, 8, 12), jnp.float32, 0.0,
                                         2.0 * jnp.pi))
    phi = np.stack([np.asarray(jkref.ref_cobi_trajectory(
        j[i] / denom[i], h[i] / denom[i], phi0[i], steps=50, dt=0.35, ks_max=1.2))
        for i in range(3)])
    clear = (np.abs(np.cos(phi)) > PHASE_TOL * (1 + np.abs(phi))).all(axis=(1, 2))
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got_s.numpy()[clear], np.asarray(want_s)[clear])
    np.testing.assert_array_equal(got_e.numpy()[clear], np.asarray(want_e)[clear])


FLEET_WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from repro_torch import prng
from repro_torch.distributed import fleet
from repro_torch.launch import mesh as tmesh
work = json.loads(open(work).read())
data = np.load(work["instances"])
mesh = tmesh.make_mesh((2, 2), ("data", "model"))
spins, energies = fleet.fleet_solve(mesh, torch.from_numpy(data["h"]),
                                    torch.from_numpy(data["j"]), prng.key(0),
                                    replicas_per_device=8, steps=200)
solve = fleet.make_fleet_solver(mesh, steps=60)
phi0 = prng.uniform(prng.key(4), (4, 16, 12), 0.0, 6.283185307179586, device="cpu")
s2, e2 = solve(torch.from_numpy(data["h"]) / 64, torch.from_numpy(data["j"]) / 64, phi0)
if rank == 0:
    open(work["out"], "w").write(json.dumps({
        "spins": spins.tolist(), "energies": energies.tolist(),
        "spins2": s2.tolist(), "energies2": e2.tolist(),
        "collectives": dict(fleet.COLLECTIVES)}))
dist.destroy_process_group()
"""


def test_fleet_four_ranks_equal_one(tmp_path):
    """data 2 x model 2 (8 replicas a rank) against one rank (16): the
    same spins and energies bit for bit, through fleet_solve and through
    the step maker's mesh route (``make_ising_solve_step(mesh=...)``)."""
    hs, js = _instances(n_docs=4)
    h, j = np.asarray(hs), np.asarray(js)
    np.savez(tmp_path / "inst.npz", h=h, j=j)
    out = run_ranks(FLEET_WORKER, 4, tmp_path, {"instances": str(tmp_path / "inst.npz")})
    with one_rank(tmp_path) as mesh:
        spins, energies = fleet.fleet_solve(mesh, torch.from_numpy(h), torch.from_numpy(j),
                                            prng.key(0), replicas_per_device=16, steps=200)
        solve = tsteps.make_ising_solve_step(steps=60, mesh=mesh)
        assert isinstance(solve, fleet.FleetSolver)
        phi0 = prng.uniform(prng.key(4), (4, 16, 12), 0.0, 2.0 * math.pi, device="cpu")
        s2, e2 = solve(torch.from_numpy(h) / 64, torch.from_numpy(j) / 64, phi0)
    np.testing.assert_array_equal(np.asarray(out["spins"], np.int8), spins.numpy())
    np.testing.assert_array_equal(np.asarray(out["energies"], np.float32), energies.numpy())
    np.testing.assert_array_equal(np.asarray(out["spins2"], np.int8), s2.numpy())
    np.testing.assert_array_equal(np.asarray(out["energies2"], np.float32), e2.numpy())
    # Each call: three all-reduces over "model", one all-gather of spins and
    # one of energies over "data".
    assert out["collectives"] == {"all_reduce": 6, "all_gather": 4}
    # The unsharded step on the same inputs (one device, no mesh).
    p_s, p_e = tsteps.make_ising_solve_step(steps=60)(
        torch.from_numpy(h) / 64, torch.from_numpy(j) / 64, phi0)
    np.testing.assert_array_equal(p_s.numpy(), s2.numpy())
    np.testing.assert_array_equal(p_e.numpy(), e2.numpy())
