"""Random-selection baseline (paper Sec. IV-A): each iteration draws a random
cardinality-M selection; the best under the FP objective is kept."""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.formulation import EsProblem, es_objective


def random_selections(key: torch.Tensor, n: int, m: int, iterations: int, *,
                      device=None) -> torch.Tensor:
    """(iterations, n) {0,1} int32 selections with exactly m ones each: a
    random m-subset per split key, via permutation ranks."""
    keys = prng.split(key, iterations)
    return (prng.permutation_many(keys, n, device=device) < m).to(torch.int32)


def solve(problem: EsProblem, key: torch.Tensor, iterations: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (best selection (n,), objectives per iteration (iterations,)),
    on the problem's device."""
    xs = random_selections(key, problem.n, problem.m, iterations, device=problem.device)
    objs = es_objective(problem, xs)
    return xs[torch.argmax(objs)], objs
