"""Plain NumPy, in float64, of what the solver is handed: the improved k-of-n
Ising formulation (paper Eqs. 10-12 with the Eq. 6 change of variables),
the properties of its rounding into [-R, R], and the Ising energy.

Formulation: Gamma = 1.1 max(max(mu, 0) + 2 lam neg, 2 lam (top + neg))
(top: the largest row sum of the M - 1 largest positive betas, neg: the
largest row sum of the negative ones); quad = lam beta + Gamma off the
diagonal; the Eq. 12 bias mu_b = 2 (median h0 - median of J0's off-diagonal
entries) of the formulation with mu_b = 0; then the QUBO Q = quad +
diag(-(mu + mu_b) - 2 Gamma M + Gamma) and h = diag(Q) / 2 + (row sums of
Q's off-diagonal) / 2, J = Q's off-diagonal / 4.

Rounding: one scale R / max(|h|, |J|); each entry is floor or ceil of the
scaled value (stochastic rounding), clipped to [-R, R]; J is rounded on its
upper triangle and mirrored, its diagonal zero.
"""

from __future__ import annotations

import numpy as np

SAFETY = 1.1


def gamma_auto(mu: np.ndarray, beta: np.ndarray, m: int, lam: float) -> float:
    n = len(mu)
    kpart = max(min(m - 1, n - 1), 0)
    if kpart > 0:
        top = np.sort(np.maximum(beta, 0.0), axis=-1)[:, -kpart:].sum(axis=-1).max()
        neg = np.maximum(-beta, 0.0).sum(axis=-1).max()
    else:
        top = neg = 0.0
    bound = max(mu.max(initial=0.0) + 2.0 * lam * neg, 2.0 * lam * (top + neg), 1e-6)
    return SAFETY * float(bound)


def _offdiag(a: np.ndarray) -> np.ndarray:
    return a[~np.eye(len(a), dtype=bool)]


def _bf16(a):
    import torch

    return torch.as_tensor(np.asarray(a, np.float64)).to(torch.bfloat16).to(
        torch.float64).numpy()


def improved_ising(mu, beta, m: int, lam: float, gamma: float | None = None,
                   quant: str | None = None):
    """(h, J) of the improved formulation, float64; with ``quant="bf16"``
    (the control, one precision below the pipeline's float32) every
    operand, sum and result rounded to bfloat16."""
    if quant not in (None, "bf16"):
        raise ValueError(f"unknown control precision {quant!r}")
    rnd = _bf16 if quant == "bf16" else (lambda a: a)
    mu = rnd(np.asarray(mu, np.float64))
    beta = rnd(np.asarray(beta, np.float64))
    n = len(mu)
    g = float(rnd(gamma_auto(mu, beta, m, lam) if gamma is None else float(gamma)))
    off = 1.0 - np.eye(n)
    quad = rnd((lam * beta + g) * off)
    rows = rnd(quad.sum(axis=1))
    h0 = rnd(rnd(-mu - 2.0 * g * m + g) / 2.0 + rows / 2.0)
    j0 = rnd(quad / 4.0)
    mu_b = float(rnd(2.0 * (np.median(h0) - np.median(_offdiag(j0))))) if n > 1 else 0.0
    lin = rnd(-(mu + mu_b) - 2.0 * g * m + g)
    return rnd(lin / 2.0 + rows / 2.0), j0


def formulation_gap(h, j, h_ref, j_ref) -> float:
    """The largest gap of the program's (h, J) from the reference's, over the
    reference's largest magnitude: the unit that rounding maps onto R."""
    scale = max(np.abs(h_ref).max(initial=0.0), np.abs(j_ref).max(initial=0.0), 1e-12)
    gap = max(np.abs(np.asarray(h, np.float64) - h_ref).max(initial=0.0),
              np.abs(np.asarray(j, np.float64) - j_ref).max(initial=0.0))
    return float(gap / scale)


def rounding_ok(h_real, j_real, h_q, j_q, int_range: int) -> bool:
    """Whether (h_q, J_q) is a rounding of (h_real, J_real) into [-R, R]:
    integers, inside the range, each within one step of its value under the
    one scale, J symmetric with a zero diagonal."""
    h_real, j_real = np.asarray(h_real, np.float64), np.asarray(j_real, np.float64)
    h_q, j_q = np.asarray(h_q, np.float64), np.asarray(j_q, np.float64)
    if h_q.shape != h_real.shape or j_q.shape != j_real.shape:
        return False
    peak = max(np.abs(h_real).max(initial=0.0), np.abs(j_real).max(initial=0.0), 1e-12)
    scale = int_range / peak
    q = np.concatenate([h_q, j_q.ravel()])
    v = np.clip(np.concatenate([h_real, j_real.ravel()]) * scale, -int_range, int_range)
    # Float32 scaling moves a value by a few ulps of R at most.
    return bool(np.all(q == np.round(q)) and np.all(np.abs(q) <= int_range)
                and np.all(np.abs(q - v) < 1.0 + 1e-4 * int_range)
                and np.array_equal(j_q, j_q.T) and not np.any(np.diag(j_q)))


def energy(h, j, s) -> float:
    """H(s) = h.s + s^T J s."""
    h, j, s = (np.asarray(a, np.float64) for a in (h, j, s))
    return float(h @ s + s @ j @ s)
