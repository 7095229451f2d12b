"""Vectorized multi-replica Tabu search for Ising problems (paper baseline [25]).

Classic single-flip tabu with aspiration, run as R independent replicas in
lockstep (each replica = one restart), as plain PyTorch on the instance's
device (the reference has no kernel for it):

  * local fields  f = s J            (rank-1 updated per flip)
  * flip gains    dE_k = -2 s_k (h_k + 2 f_k)
  * tabu rule     flip k allowed if tenure expired OR it beats the best seen

The loop issues no host sync.  On chip-range integer instances every
quantity is an exact integer in float32, so spins and energies equal the
reference's bit for bit: ``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.formulation import IsingProblem
from repro_torch.solvers.base import SolverResult


def _tabu(h: torch.Tensor, j: torch.Tensor, key: torch.Tensor, replicas: int, iters: int,
          tenure: int):
    n = h.shape[-1]
    h = h.to(torch.float32)
    j = j.to(torch.float32)
    up = prng.bernoulli(key, 0.5, (replicas, n), device=h.device)
    s = torch.where(up, 1.0, -1.0).to(torch.float32)
    f = s @ j  # (R, N)
    e = s @ h + torch.sum(s * f, dim=-1)
    expiry = torch.zeros((replicas, n), dtype=torch.int32, device=h.device)
    best_e, best_s = e, s
    inf = torch.full((), float("inf"), dtype=torch.float32, device=h.device)
    for t in range(iters):
        de = -2.0 * s * (h[None] + 2.0 * f)  # (R, N)
        allowed = (expiry <= t) | ((e[:, None] + de) < best_e[:, None])
        score = torch.where(allowed, de, inf)
        # If every move is tabu (rare), fall back to the raw best move.
        score = torch.where(torch.all(~allowed, dim=-1, keepdim=True), de, score)
        k = torch.argmin(score, dim=-1)  # (R,), first minimum
        onehot = torch.nn.functional.one_hot(k, n).to(torch.float32)
        s_k = torch.gather(s, 1, k[:, None])[:, 0]  # pre-flip value
        de_k = torch.gather(de, 1, k[:, None])[:, 0]
        s = s * (1.0 - 2.0 * onehot)
        f = f - 2.0 * s_k[:, None] * j[k]  # rank-1 update, J symmetric
        e = e + de_k
        expiry = torch.where(onehot > 0, t + tenure, expiry)
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_s = torch.where(better[:, None], s, best_s)
    return best_s.to(torch.int8), best_e


def solve(
    ising: IsingProblem,
    key: torch.Tensor,
    *,
    replicas: int = 8,
    iters: int | None = None,
    tenure: int | None = None,
) -> SolverResult:
    """``replicas`` restarts of ``iters`` (default ``max(40, 12 n)``) tabu
    steps on the instance's device."""
    n = ising.n
    iters = iters if iters is not None else max(40, 12 * n)
    tenure = tenure if tenure is not None else max(3, n // 4)
    spins, energies = _tabu(ising.h, ising.j, key, replicas, iters, tenure)
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
    ``reads`` maps to replicas; ``steps``/``check`` have no tabu meaning and
    are ignored; extra kwargs (``iters``, ``tenure``) pass through."""
    del steps, check
    return solve(ising, key, replicas=reads, **kwargs).reduced(reduce)
