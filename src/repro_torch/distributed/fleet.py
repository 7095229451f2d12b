"""Explicit-collective distributed Ising solving: the twin of
``repro.distributed.fleet`` on ``torch.distributed``.

Each rank anneals its own (documents over (pod, data)) x (replicas over
"model") block with the two hand-written kernels ``launch.steps``'s Ising
step launches (``ops.cobi_trajectory_batch``, then the spins' sign and
``ops.ising_energy``) and takes each document's first argmin.  The
best-energy selection then crosses the mesh with hand-placed collectives on
the "model" group, three ``all_reduce``s:

  * MIN of the energies;
  * MIN of the model-rank index among the ranks holding that energy (the
    reference's tie rule: the lowest-index winner sends);
  * SUM of the spins masked to the winner's;

so the payload is a few values a document, not every replica.  The
documents are embarrassingly parallel; an ``all_gather`` over "data" (then
"pod") gives every rank the global result.
"""

from __future__ import annotations

import collections
import math

import torch

from repro_torch import prng
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

# Collectives issued by the solver, by kind (all_reduce, all_gather).
COLLECTIVES: collections.Counter = collections.Counter()


def _block(n: int, parts: int, index: int) -> slice:
    size = n // parts
    return slice(index * size, (index + 1) * size)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(out)


class FleetSolver:
    """solve(h, j, phi0) -> (best_spins (D, N) int8, best_energy (D,)
    float32), the same global result on every rank.

    h (D, N), j (D, N, N) and phi0 (D, R, N) are global values: each rank
    reads its own block (D over (pod, data), R over "model") and moves it
    to the mesh's device.  :meth:`local` takes the blocks themselves.
    """

    def __init__(self, mesh, *, steps: int = 500, dt: float = 0.35, ks_max: float = 1.2):
        self.mesh, self.steps, self.dt, self.ks_max = mesh, steps, dt, ks_max
        sizes = shd.axis_sizes(mesh)
        self.model_size = sizes["model"]
        self.model_index = mesh.get_local_rank("model")
        self.dp_size = shd.dp_size(mesh)
        self.dp_index = 0
        for ax in shd.dp_axes(mesh):
            self.dp_index = self.dp_index * sizes[ax] + mesh.get_local_rank(ax)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    def blocks(self, d: int, r: int) -> tuple[slice, slice]:
        """This rank's (documents, replicas) of a (D, R) fleet."""
        if d % self.dp_size or r % self.model_size:
            raise ValueError(f"{d} documents x {r} replicas do not split over "
                             f"{self.dp_size} x {self.model_size} ranks")
        return _block(d, self.dp_size, self.dp_index), _block(r, self.model_size,
                                                                self.model_index)

    def __call__(self, h, j, phi0):
        docs, reps = self.blocks(phi0.shape[0], phi0.shape[1])
        return self.local(h[docs], j[docs], phi0[docs, reps])

    @torch.no_grad()
    def local(self, h_l, j_l, phi_l):
        import torch.distributed as dist

        h_l, j_l, phi_l = (t.to(self.device) for t in (h_l, j_l, phi_l))
        # The local anneal: this rank's replicas of its documents.
        phi = ops.cobi_trajectory_batch(j_l, h_l, phi_l, steps=self.steps, dt=self.dt,
                                        ks_max=self.ks_max)
        spins = kref.ref_cobi_spins(phi)  # (D_l, R_l, N) int8
        e = ops.ising_energy(spins, h_l, j_l)  # (D_l, R_l)
        best = torch.argmin(e, dim=1)  # the first of equal minima
        rows = torch.arange(e.shape[0], device=self.device)
        spins, energy = spins[rows, best].to(torch.float32), e[rows, best]
        # Cross-replica reduction over "model": the global best energy, then
        # the lowest model index holding it sends its spins.
        group = self.mesh.get_group("model")
        best_e = _all_reduce(energy.clone(), dist.ReduceOp.MIN, group)
        am_best = energy == best_e
        idx = torch.full_like(energy, float(self.model_index))
        winner = _all_reduce(torch.where(am_best, idx, math.inf), dist.ReduceOp.MIN, group)
        send = (am_best & (idx == winner)).to(spins.dtype)
        best_spins = _all_reduce(spins * send[:, None], dist.ReduceOp.SUM, group)
        out_s, out_e = best_spins.to(torch.int8), best_e
        for ax in reversed(shd.dp_axes(self.mesh)):  # "data" within a pod, then "pod"
            group = self.mesh.get_group(ax)
            out_s, out_e = _all_gather(out_s, group), _all_gather(out_e, group)
        return out_s, out_e


def make_fleet_solver(mesh, *, steps: int = 500, dt: float = 0.35,
                      ks_max: float = 1.2) -> FleetSolver:
    return FleetSolver(mesh, steps=steps, dt=dt, ks_max=ks_max)


def fleet_solve(mesh, h: torch.Tensor, j: torch.Tensor, key: torch.Tensor, *,
                replicas_per_device: int = 8, steps: int = 500):
    """A batch of instances on the mesh: phi0 of the global (D, R, N), R =
    replicas_per_device x the "model" axis, is ``jax.random.uniform``'s
    draw bit for bit, each rank drawing only its own block; then the
    dynamics pre-scaling, the solve, and the energies scaled back."""
    d, n = h.shape
    r = replicas_per_device * shd.axis_sizes(mesh).get("model", 1)
    solver = make_fleet_solver(mesh, steps=steps)
    docs, reps = solver.blocks(d, r)
    index = prng.block_index((d, r, n), (docs, reps, slice(None))).to(solver.device)
    phi_l = prng.uniform_at(key, index, 0.0, 2.0 * math.pi)
    # dynamics pre-scaling (the convention of kernels/ops.py)
    denom = 2.0 * torch.amax(torch.sum(torch.abs(j), dim=-1), dim=-1) + torch.amax(
        torch.abs(h), dim=-1)
    denom = torch.clamp(denom, min=1e-9)[:, None]
    h_s, j_s = h / denom, j / denom[..., None]
    spins, energies = solver.local(h_s[docs], j_s[docs], phi_l)
    # H is linear in (h, J): undo the dynamics pre-scaling on the energies.
    return spins, energies * denom[:, 0].to(energies.device)
