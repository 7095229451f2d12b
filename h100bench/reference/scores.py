"""Plain NumPy scoring of a k-of-n selection, in float64 (paper Eqs. 1-3):
mu_i = cos(e_i, mean of the unit rows), beta_ij = cos(e_i, e_j) off the
diagonal, and the objective mu . x - lam x^T beta x of a 0/1 selection x.

Bounds of the objective over |x| = m: exact enumeration while C(N, m) is at
most ``ENUM_LIMIT``; above it, the reference's own search (greedy start,
then best-improvement single swaps, from the greedy set and from
``RESTARTS`` random sets drawn from a fixed seed), run to maximise and to
minimise.  The search's maximum is a best-known value, not a proof: a
selection may score above it.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations
from math import comb

import numpy as np

ENUM_LIMIT = 2_000_000
RESTARTS = 16


def scores(e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, beta) of embeddings e (N, d); a zero row scores 0."""
    e = np.asarray(e, np.float64)
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    e = e / np.maximum(norms, 1e-9)
    doc = e.mean(axis=0)
    doc = doc / max(np.linalg.norm(doc), 1e-9)
    beta = e @ e.T
    np.fill_diagonal(beta, 0.0)
    return e @ doc, beta


def objective(mu: np.ndarray, beta: np.ndarray, lam: float, x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    return float(mu @ x - lam * x @ beta @ x)


@lru_cache(maxsize=64)
def _subsets(n: int, m: int) -> np.ndarray:
    return np.fromiter((i for c in combinations(range(n), m) for i in c),
                       dtype=np.int16, count=comb(n, m) * m).reshape(-1, m)


def _enumerate(mu, beta, lam, m) -> np.ndarray:
    idx = _subsets(len(mu), m)
    vals = mu[idx].sum(axis=1)
    for a in range(m):
        for b in range(a + 1, m):
            vals -= 2.0 * lam * beta[idx[:, a], idx[:, b]]
    return vals


def _search(mu, beta, lam, m, sign: float) -> tuple[float, np.ndarray]:
    """Best-improvement single-swap search maximising sign * objective."""
    n = len(mu)
    rng = np.random.default_rng(0)
    starts = [None] + [rng.choice(n, m, replace=False) for _ in range(RESTARTS)]
    best_val, best_x = -np.inf, None
    for start in starts:
        if start is None:  # greedy: add the item that raises the objective most
            sel = []
            for _ in range(m):
                gain = sign * (mu - 2.0 * lam * beta[:, sel].sum(axis=1))
                gain[sel] = -np.inf
                sel.append(int(np.argmax(gain)))
            x = np.zeros(n)
            x[sel] = 1.0
        else:
            x = np.zeros(n)
            x[start] = 1.0
        while True:
            inside, outside = np.nonzero(x)[0], np.nonzero(x == 0)[0]
            field = beta @ x  # sum over the selection of beta_ik
            # Swap i out, j in: mu_j - mu_i - 2 lam (field_j - beta_ji - field_i).
            delta = (mu[outside][None, :] - mu[inside][:, None]
                     - 2.0 * lam * (field[outside][None, :] - beta[np.ix_(inside, outside)]
                                    - field[inside][:, None]))
            delta *= sign
            a, b = np.unravel_index(np.argmax(delta), delta.shape)
            if delta[a, b] <= 1e-12:
                break
            x[inside[a]], x[outside[b]] = 0.0, 1.0
        val = sign * objective(mu, beta, lam, x)
        if val > best_val:
            best_val, best_x = val, x.copy()
    return sign * best_val, best_x


def bounds(mu: np.ndarray, beta: np.ndarray, lam: float, m: int) -> tuple[float, float, bool]:
    """(max, min, exact) of the objective over selections of m items."""
    m = min(m, len(mu))
    if comb(len(mu), m) <= ENUM_LIMIT:
        vals = _enumerate(mu, beta, lam, m)
        return float(vals.max()), float(vals.min()), True
    hi, _ = _search(mu, beta, lam, m, 1.0)
    lo, _ = _search(mu, beta, lam, m, -1.0)
    return hi, lo, False


def best_selection(mu: np.ndarray, beta: np.ndarray, lam: float, m: int) -> np.ndarray:
    """The selection of m items that maximises the objective: exact where
    enumeration is in reach, else the search's best."""
    m = min(m, len(mu))
    n = len(mu)
    x = np.zeros(n)
    if comb(n, m) <= ENUM_LIMIT:
        x[_subsets(n, m)[int(np.argmax(_enumerate(mu, beta, lam, m)))]] = 1.0
        return x
    return _search(mu, beta, lam, m, 1.0)[1]
