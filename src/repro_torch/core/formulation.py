"""McDonald-style extractive summarization as ILP -> QUBO -> Ising.

Implements the paper's Eqs. (3)-(12), as ``repro.core.formulation`` does:

  * :func:`es_objective`       -- Eq. (3) maximization objective (FP reference).
  * :func:`qubo_original`      -- Eq. (8)  penalty-form QUBO.
  * :func:`qubo_improved`      -- Eq. (10) QUBO with the linear bias term mu_b.
  * :func:`qubo_to_ising`      -- Eq. (6)  change of variables x = (1+s)/2.
  * :func:`original_ising`     -- Eq. (9).
  * :func:`improved_ising`     -- Eq. (11)+(12), the paper's contribution C2.

Conventions: QUBO energy H(x) = x^T Q x (ordered pairs, Q symmetric); Ising
energy H(s) = h.s + s^T J s (J symmetric, zero diagonal).  Arrays are float32
torch tensors; every construction runs on the device its inputs live on and
keeps the reference's op order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Problem containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EsProblem:
    """An extractive-summarization instance (Eq. 3).

    Attributes:
      mu:    (N,) relevance score of each sentence.
      beta:  (N, N) symmetric pairwise redundancy, zero diagonal.
      m:     summary length budget.
      lam:   redundancy weight ``lambda``.
    """

    mu: torch.Tensor
    beta: torch.Tensor
    m: int
    lam: float = 1.0

    @property
    def n(self) -> int:
        return int(self.mu.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def to(self, device) -> "EsProblem":
        return dataclasses.replace(
            self, mu=self.mu.to(device), beta=self.beta.to(device)
        )

    def subproblem(self, idx: np.ndarray) -> "EsProblem":
        """Restriction to a subset of sentences (used by decomposition)."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)
        return EsProblem(
            mu=self.mu[idx], beta=self.beta[idx][:, idx], m=self.m, lam=self.lam
        )

    def with_m(self, m: int) -> "EsProblem":
        return dataclasses.replace(self, m=m)


@dataclasses.dataclass(frozen=True)
class QuboProblem:
    """H(x) = x^T Q x over x in {0,1}^N (Q symmetric; diag = linear terms)."""

    q: torch.Tensor  # (N, N)

    @property
    def n(self) -> int:
        return int(self.q.shape[-1])


@dataclasses.dataclass(frozen=True)
class IsingProblem:
    """H(s) = h.s + s^T J s over s in {-1,+1}^N (J symmetric, zero diag)."""

    h: torch.Tensor  # (N,)
    j: torch.Tensor  # (N, N)

    @property
    def n(self) -> int:
        return int(self.h.shape[-1])


# ---------------------------------------------------------------------------
# Objectives / energies
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def es_objective(problem: EsProblem, x: torch.Tensor) -> torch.Tensor:
    """Eq. (3) objective (maximized), batched over leading dims of ``x``.
    The cardinality constraint is NOT included.

    Every sum runs over the lanes in order -- ``x . mu``, ``(beta x)_i`` and
    ``x . (beta x)`` -- which is how XLA's CPU backend takes the reference's
    dots for one selection, so a selection's objective is the reference's
    bit for bit (a library matmul sums in another order).
    """
    x = _f32(x).to(problem.device)
    mu, beta = _f32(problem.mu), _f32(problem.beta)
    lin = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    bx = torch.zeros_like(x)  # (beta x)_i
    for j in range(x.shape[-1]):
        lin = lin + x[..., j] * mu[j]
        bx = bx + beta[:, j] * x[..., j, None]
    quad = torch.zeros_like(lin)
    for i in range(x.shape[-1]):
        quad = quad + x[..., i] * bx[..., i]
    return lin - problem.lam * quad


def qubo_energy(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """H(x) = x^T Q x, batched over leading dims of x."""
    x = _f32(x)
    return torch.einsum("...i,ij,...j->...", x, _f32(q), x)


def ising_energy(h: torch.Tensor, j: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """H(s) = h.s + s^T J s, batched over leading dims of s."""
    s = _f32(s)
    return s @ _f32(h) + torch.einsum("...i,ij,...j->...", s, _f32(j), s)


# ---------------------------------------------------------------------------
# Penalty coefficient
# ---------------------------------------------------------------------------


def gamma_auto(problem: EsProblem, safety: float = 1.1) -> float:
    """A penalty weight making the unconstrained optimum feasible:
    Gamma > max(max_i mu_i, 2 lam max_i top_{M-1}(beta_i.)), plus slack for
    negative couplings (host numpy, as in the reference)."""
    mu = problem.mu.detach().cpu().numpy()
    beta = problem.beta.detach().cpu().numpy()
    kpart = max(min(problem.m - 1, problem.n - 1), 0)
    if kpart > 0:
        top = np.sort(np.maximum(beta, 0.0), axis=-1)[:, -kpart:].sum(axis=-1).max()
        neg = np.maximum(-beta, 0.0).sum(axis=-1).max()
    else:
        top, neg = 0.0, 0.0
    bound = max(
        mu.max(initial=0.0) + 2.0 * problem.lam * neg,
        2.0 * problem.lam * (top + neg),
        1e-6,
    )
    return float(safety * bound)


# ---------------------------------------------------------------------------
# QUBO constructions (Eq. 8 and Eq. 10)
# ---------------------------------------------------------------------------


def row_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Sum over the last dim in the reference's float32 order.

    The reference's sums run through XLA, which on the CPU reduces a
    dimension longer than 32 as windows of 32 (zero-padded, the padding split
    low/high), each summed in order, then reduces the window sums the same
    way.  ``improved_ising``'s fields cancel terms of order Gamma*M down to
    O(1), so a different order would move h by far more than its rounding;
    this order keeps the port's h and J equal to the reference's.
    """
    n = x.shape[-1]
    if n > window:
        k = math.ceil(n / window)
        lo = (k * window - n) // 2
        x = torch.nn.functional.pad(x, (lo, k * window - n - lo))
        return row_sum(row_sum(x.reshape(*x.shape[:-1], k, window)), window)
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for q in range(n):
        acc = acc + x[..., q]
    return acc


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a flat tensor: the midpoint of the two middle values
    for an even count (``torch.median`` would return the lower one)."""
    x = torch.sort(x.reshape(-1)).values
    n = x.numel()
    return (x[(n - 1) // 2] + x[n // 2]) * 0.5


def _offdiag_values(j: torch.Tensor) -> torch.Tensor:
    n = j.shape[-1]
    if n < 2:
        return j.new_zeros((0,))
    return j.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(-1)


def _ising_coeffs(mu, beta, m, lam, gamma, mu_b):
    """Closed-form h, J of the (improved) ES Ising model -- used for Eq. 12."""
    n = mu.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=mu.device)
    quad = (lam * beta + gamma) * (1.0 - eye)
    lin = -(mu + mu_b) - 2.0 * gamma * m + gamma
    h = lin / 2.0 + row_sum(quad) / 2.0
    j = quad / 4.0
    return h, j


def qubo_original(problem: EsProblem, gamma: Optional[float] = None) -> QuboProblem:
    """Eq. (8): the penalty-form QUBO (Eq. 10 with mu_b = 0)."""
    return qubo_improved(problem, gamma=gamma, mu_b=0.0)


def qubo_improved(
    problem: EsProblem,
    gamma: Optional[float] = None,
    mu_b: Optional[float] = None,
) -> QuboProblem:
    """Eq. (10): the improved QUBO with linear bias ``mu_b``; ``None`` selects
    the paper's Eq. (12) median-matching rule, ``0`` recovers Eq. (8)."""
    if gamma is None:
        gamma = gamma_auto(problem)
    mu, beta = _f32(problem.mu), _f32(problem.beta)
    dev = mu.device
    lam = torch.tensor(problem.lam, dtype=torch.float32, device=dev)
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
    n, m = mu.shape[-1], problem.m
    if mu_b is None:
        h, j = _ising_coeffs(mu, beta, m, lam, g, 0.0)
        b = 2.0 * (median(h) - median(_offdiag_values(j)))
    else:
        b = torch.tensor(mu_b, dtype=torch.float32, device=dev)
    lin = -(mu + b) - 2.0 * g * m + g
    quad = lam * beta + g
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    return QuboProblem(q=quad * (1.0 - eye) + torch.diag(lin))


# ---------------------------------------------------------------------------
# QUBO -> Ising (Eq. 6 with the ordered-pair convention, derived exactly)
# ---------------------------------------------------------------------------


def qubo_to_ising(qubo: QuboProblem) -> IsingProblem:
    """Exact change of variables x = (1+s)/2 on H(x) = x^T Q x:
    h_i = Q_ii / 2 + (1/2) sum_{j != i} Q_ij,  J_ij = Q_ij / 4 (i != j)."""
    q = _f32(qubo.q)
    n = q.shape[-1]
    off = q * (1.0 - torch.eye(n, dtype=torch.float32, device=q.device))
    h = torch.diagonal(q) / 2.0 + row_sum(off) / 2.0
    return IsingProblem(h=h, j=off / 4.0)


def ising_offset(qubo: QuboProblem) -> float:
    """Constant c with H_qubo(x) = H_ising(s) + c under x = (1+s)/2 (host
    numpy in float64, as in the reference)."""
    q = _f32(qubo.q).detach().cpu().numpy().astype(np.float64)
    off = q * (1.0 - np.eye(qubo.n))
    return float(np.diag(q).sum() / 2.0 + off.sum() / 4.0)


def original_ising(problem: EsProblem, gamma: Optional[float] = None) -> IsingProblem:
    """Eq. (9): Ising form of the original QUBO."""
    return qubo_to_ising(qubo_original(problem, gamma=gamma))


def improved_ising(
    problem: EsProblem,
    gamma: Optional[float] = None,
    mu_b: Optional[float] = None,
) -> IsingProblem:
    """Eq. (11) with mu_b from Eq. (12) by default: the paper's contribution C2."""
    return qubo_to_ising(qubo_improved(problem, gamma=gamma, mu_b=mu_b))


def spins_to_selection(s: torch.Tensor) -> torch.Tensor:
    """s in {-1,+1} -> x in {0,1} (int32)."""
    return torch.div(s.to(torch.int32) + 1, 2, rounding_mode="floor")


def selection_to_spins(x: torch.Tensor) -> torch.Tensor:
    """x in {0,1} -> s in {-1,+1} (float32)."""
    return (2 * torch.as_tensor(x) - 1).to(torch.float32)
