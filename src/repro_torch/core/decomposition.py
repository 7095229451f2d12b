"""Decomposition of a large ES problem into COBI-sized subproblems (Fig. 4, C4).

While the working paragraph has more than P sentences: take the window of P
consecutive sentences starting at the cursor (wrapping around the end),
summarize it to Q sentences with the sub-solver, replace the window by its Q
survivors (document order preserved), and move the cursor to just after the
window.  When <= P sentences remain, one final solve produces the
M-sentence summary.

The sub-solver is a callback ``solve(problem: EsProblem, m: int, key) -> x``.
The reference's speculative ``PipelinedDecomposition`` ports with the chip
farm (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.formulation import EsProblem

SubSolver = Callable[[EsProblem, int, torch.Tensor], np.ndarray]


@dataclasses.dataclass
class DecompositionTrace:
    """One entry per sub-solve: (window indices, kept indices)."""

    windows: List[np.ndarray]
    kept: List[np.ndarray]
    num_solves: int = 0


def window_indices(length: int, start: int, p: int) -> np.ndarray:
    """P consecutive positions from ``start`` with wrap-around."""
    return (start + np.arange(p)) % length


def decompose_steps_indexed(
    problem: EsProblem,
    key: torch.Tensor,
    *,
    p: int = 20,
    q: int = 10,
):
    """Generator form of the decomposition loop (Fig. 4), with indices.

    Yields ``(window, subproblem, m, key)`` for each sub-solve -- ``window``
    is the sub-solve's original sentence indices in document order -- and
    expects the selection ``x`` over the subproblem back via ``send``;
    returns ``(selection, trace)`` on exhaustion.
    """
    if q >= p:
        raise ValueError(f"need q < p, got p={p} q={q}")
    if q < problem.m:
        raise ValueError(
            f"intermediate summaries of q={q} cannot reach final m={problem.m}"
        )
    alive = np.arange(problem.n)  # original indices, document order
    cursor = 0
    trace = DecompositionTrace(windows=[], kept=[])

    while alive.size > p:
        key, sub = prng.split(key)
        pos = window_indices(alive.size, cursor, p)
        window = alive[np.sort(pos)]  # window in document order
        subproblem = problem.subproblem(window)
        x = np.asarray((yield window, subproblem, q, sub))
        keep_local = np.nonzero(x)[0]
        trace.windows.append(window)
        trace.kept.append(window[keep_local])
        trace.num_solves += 1
        drop = set(window[np.setdiff1d(np.arange(p), keep_local)].tolist())
        # Cursor: first position after the window, in the NEW list's coords.
        end_pos = int(pos[-1])
        after = alive[(end_pos + 1) % alive.size] if alive.size else 0
        alive = np.array([i for i in alive if i not in drop], dtype=np.int64)
        nxt = np.nonzero(alive == after)[0]
        cursor = int(nxt[0]) if nxt.size else 0

    key, sub = prng.split(key)
    subproblem = problem.subproblem(alive)
    x = np.asarray((yield alive, subproblem, problem.m, sub))
    trace.windows.append(alive)
    trace.kept.append(alive[np.nonzero(x)[0]])
    trace.num_solves += 1

    selection = np.zeros(problem.n, np.int32)
    selection[trace.kept[-1]] = 1
    return selection, trace


def decompose_steps(problem: EsProblem, key: torch.Tensor, *, p: int = 20, q: int = 10):
    """Index-free wrapper of :func:`decompose_steps_indexed` (yields
    ``(subproblem, m, key)``)."""
    gen = decompose_steps_indexed(problem, key, p=p, q=q)
    item = next(gen)
    while True:
        _, subproblem, m, sub = item
        x = yield subproblem, m, sub
        try:
            item = gen.send(x)
        except StopIteration as done:
            return done.value


def decompose_solve(
    problem: EsProblem,
    solve: SubSolver,
    key: torch.Tensor,
    *,
    p: int = 20,
    q: int = 10,
) -> tuple[np.ndarray, DecompositionTrace]:
    """Returns (selection x over the ORIGINAL N sentences, trace)."""
    gen = decompose_steps(problem, key, p=p, q=q)
    item = next(gen)
    while True:
        try:
            item = gen.send(np.asarray(solve(*item)))
        except StopIteration as done:
            return done.value
