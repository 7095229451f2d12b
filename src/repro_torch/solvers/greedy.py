"""Greedy baseline for McDonald-style ES (classic approximate inference [3]),
in host numpy as in the reference."""

from __future__ import annotations

import numpy as np

from repro_torch.core.formulation import EsProblem


def greedy_select(problem: EsProblem) -> np.ndarray:
    """Iteratively add the sentence with the best marginal gain until |S| = M.

    Marginal gain of adding i given selection S (ordered-pair convention):
        mu_i - 2 * lam * sum_{j in S} beta_ij
    """
    mu = problem.mu.detach().cpu().numpy().astype(np.float64)
    beta = problem.beta.detach().cpu().numpy().astype(np.float64)
    n, m = problem.n, problem.m
    selected = np.zeros(n, bool)
    red = np.zeros(n, np.float64)  # sum_{j in S} beta_ij
    for _ in range(min(m, n)):
        gain = mu - 2.0 * problem.lam * red
        gain[selected] = -np.inf
        i = int(np.argmax(gain))
        selected[i] = True
        red += beta[:, i]
    return selected.astype(np.int32)
