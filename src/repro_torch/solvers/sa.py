"""Simulated annealing baseline (vectorized single-spin Metropolis), as plain
PyTorch on the instance's device.

Each of the ``sweeps * n`` steps of the reference splits its carried key
three ways and draws one spin pick (``randint``) and one acceptance uniform
per replica.  Here the key chain is walked once on the host
(:func:`repro_torch.prng.split_chain`) and every step's picks and uniforms
are drawn in one hash pass on the device, so the loop itself issues no host
sync.  The picks, uniforms and initial spins are the reference's bit for
bit; the float32 temperature (``pow``) and ``exp`` may differ from XLA's by
an ulp, which flips a decision only when the uniform falls between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.formulation import IsingProblem
from repro_torch.solvers.base import SolverResult


def _sa(h: torch.Tensor, j: torch.Tensor, key: torch.Tensor, replicas: int, sweeps: int,
        t_hi: float, t_lo: float):
    n = h.shape[-1]
    dev = h.device
    h = h.to(torch.float32)
    j = j.to(torch.float32)
    k_init, k_loop = prng.split(key)
    up = prng.bernoulli(k_init, 0.5, (replicas, n), device=dev)
    s = torch.where(up, 1.0, -1.0).to(torch.float32)
    f = s @ j
    e = s @ h + torch.sum(s * f, dim=-1)
    steps = sweeps * n
    chain = prng.split_chain(k_loop, steps, 3)  # (steps, [k_pick, k_acc], 2)
    picks = prng.randint_many(chain[:, 0], (replicas,), 0, n, device=dev).long()
    accs = prng.uniform_many(chain[:, 1], (replicas,), device=dev)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    t_hi32, t_lo32 = f32(t_hi), f32(t_lo)
    frac = torch.arange(steps, dtype=torch.float32, device=dev) / f32(max(steps - 1, 1))
    temps = torch.maximum(t_hi32 * (t_lo32 / t_hi32) ** frac, f32(1e-9))
    zero = f32(0.0)
    best_e, best_s = e, s
    for t in range(steps):
        k = picks[t]
        onehot = torch.nn.functional.one_hot(k, n).to(torch.float32)
        s_k = torch.gather(s, 1, k[:, None])[:, 0]
        f_k = torch.gather(f, 1, k[:, None])[:, 0]
        de = -2.0 * s_k * (h[k] + 2.0 * f_k)
        # de < 0 always accepts (exp(min(-de/T, 0)) == 1 there).
        accept = accs[t] < torch.exp(torch.minimum(-de / temps[t], zero))
        flip = accept.to(torch.float32)
        s = s * (1.0 - 2.0 * onehot * flip[:, None])
        f = f - 2.0 * (s_k * flip)[:, None] * j[k]
        e = e + de * flip
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_s = torch.where(better[:, None], s, best_s)
    return best_s.to(torch.int8), best_e


def solve(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    replicas: int = 8,
    sweeps: int = 60,
    t_hi: float | None = None,
    t_lo: float = 0.05,
) -> SolverResult:
    if t_hi is None:
        # The reference's host numpy: float32 row sums of |J|.
        j = ising.j.detach().cpu().numpy()
        t_hi = float(2.0 * np.abs(j).sum(-1).max() + 1e-6)
    spins, energies = _sa(ising.h, ising.j, key, replicas, sweeps, t_hi, t_lo)
    return SolverResult(spins=spins, energies=energies)


def solve_ising(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    reads: int = 8,
    steps: int = 400,
    check: bool = False,
    reduce: str = "none",
    **kwargs,
) -> SolverResult:
    """Uniform registry entry point (see ``repro_torch.solvers.base.ising_solver``):
    ``reads`` maps to replicas; ``steps``/``check`` have no SA meaning and
    are ignored; extra kwargs (``sweeps``, ``t_hi``, ``t_lo``) pass through."""
    del steps, check
    return solve(ising, key, replicas=reads, **kwargs).reduced(reduce)
