"""General k-of-n linear-coefficient rebalancing (paper contribution C2,
generalized): shift the local fields of any cardinality-constrained
QUBO/Ising instance so that the median field matches the median coupling,
which changes every feasible energy by the same constant."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formulation import IsingProblem, QuboProblem, qubo_to_ising


def kofn_bias(ising: IsingProblem) -> float:
    """The Eq. (12)-style bias c = 2*(median(h) - median(offdiag(J))),
    in host float64 as the reference computes it."""
    h = ising.h.detach().cpu().numpy().astype(np.float64)
    j = ising.j.detach().cpu().numpy().astype(np.float64)
    n = j.shape[-1]
    off = j[~np.eye(n, dtype=bool)]
    return float(2.0 * (np.median(h) - np.median(off)))


def rebalance_ising(ising: IsingProblem) -> Tuple[IsingProblem, float]:
    """Shift local fields so median(h') == median(offdiag(J)); returns the
    shifted problem and the applied bias ``c`` (h' = h - c/2)."""
    c = kofn_bias(ising)
    return IsingProblem(h=ising.h - c / 2.0, j=ising.j), c


def rebalance_qubo(qubo: QuboProblem) -> Tuple[QuboProblem, float]:
    """QUBO-level version: Q'_ii = Q_ii - c with c chosen as in Eq. (12)."""
    c = kofn_bias(qubo_to_ising(qubo))
    q = qubo.q - c * torch.eye(qubo.n, dtype=qubo.q.dtype, device=qubo.q.device)
    return QuboProblem(q=q), c
