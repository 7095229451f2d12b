"""Decomposition of a large ES problem into COBI-sized subproblems (Fig. 4, C4).

While the working paragraph has more than P sentences: take the window of P
consecutive sentences starting at the cursor (wrapping around the end),
summarize it to Q sentences with the sub-solver, replace the window by its Q
survivors (document order preserved), and move the cursor to just after the
window.  When <= P sentences remain, one final solve produces the
M-sentence summary.

The sub-solver is a callback ``solve(problem: EsProblem, m: int, key) -> x``.

Pipelining (:class:`PipelinedDecomposition`): the loop above is sequential --
window k+1's membership is only *formally* defined once window k's survivors
are known.  In practice consecutive windows tile disjoint stretches of the
sentence list, so most memberships do not depend on earlier outcomes at all,
and the rest can be *speculated*: guess each unresolved window's survivors
(top-q by relevance ``mu``), plan every later window against the guess, and
reconcile when real survivors arrive -- windows whose membership the guess
got right keep their in-flight solves (same membership + same per-window key
=> the exact result the sequential loop would have produced), windows it got
wrong are re-planned and re-submitted.  The final selection is therefore
bit-identical to :func:`decompose_solve`; mis-speculation only wastes solver
work, it never changes the answer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Pipelined (speculative) window planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One plannable sub-solve of a decomposition.

    ``indices`` are original sentence indices (document order); ``key`` is
    the window's sub-solver key, a pure function of ``seq`` (the sequential
    loop splits once per window, regardless of contents), so a re-planned
    window keeps its key.  ``speculative`` marks memberships that currently
    rest on guessed survivors of an unresolved earlier window; a
    non-speculative membership is *guess-invariant*: every guess keeps
    exactly q survivors, so the projected list's positional structure does
    not depend on WHICH survivors were guessed, and a window whose replayed
    membership contains no guessed survivor is exactly the window the
    sequential loop will eventually form.
    """

    seq: int
    indices: Tuple[int, ...]
    m: int
    key: torch.Tensor
    speculative: bool


def guess_top_mu(subproblem: EsProblem, m: int) -> np.ndarray:
    """Default survivor speculation: the m most relevant sentences by ``mu``.

    The sub-solve maximizes relevance minus redundancy, so top-relevance is
    a cheap, deterministic (stable argsort) approximation of its outcome --
    good enough to keep the window pipeline mostly right, and always safe:
    a wrong guess is re-planned, never kept.
    """
    mu = subproblem.mu.detach().cpu().numpy()
    x = np.zeros(mu.shape[0], np.int32)
    x[np.argsort(mu, kind="stable")[::-1][:m]] = 1
    return x


class PipelinedDecomposition:
    """Plan a decomposition's windows ahead of their dependencies.

    Replays :func:`decompose_steps_indexed` against ``resolved`` outcomes
    followed by speculated ones (``guess``), which yields the COMPLETE
    current window plan -- every window's membership, budget and key -- in
    one pass of the exact sequential bookkeeping.  The caller:

      1. submits solver work for every spec in :meth:`pending_specs`
         (memoized by ``(seq, indices)``: a re-plan that reproduces the same
         membership reuses in-flight work);
      2. reduces the frontier window (:meth:`next_spec` -- always firm, its
         membership depends only on resolved results) and feeds the real
         selection to :meth:`resolve`, which re-plans;
      3. repeats until :meth:`done`, then reads ``final``.

    ``mispeculations`` counts windows whose planned membership a resolve
    invalidated (their submitted work is wasted); ``replans`` counts resolve
    steps.  Guesses never leak into ``final``: it is only set when a full
    replay consumed exclusively resolved outcomes.
    """

    def __init__(
        self,
        problem: EsProblem,
        key: torch.Tensor,
        *,
        p: int = 20,
        q: int = 10,
        speculate: bool = True,
        guess: Callable[[EsProblem, int], np.ndarray] = guess_top_mu,
    ):
        self.problem = problem
        self.key = key
        self.p = p
        self.q = q
        self.speculate = speculate
        self.guess = guess
        self.final: Optional[tuple] = None
        self.mispeculations = 0
        self.replans = 0
        self._resolved: List[np.ndarray] = []
        self._specs: List[WindowSpec] = []
        self._replay()

    # ---------------------------------------------------------------- plan

    def done(self) -> bool:
        return self.final is not None

    def n_resolved(self) -> int:
        return len(self._resolved)

    def pending_specs(self) -> List[WindowSpec]:
        """Every planned-but-unresolved window, frontier first."""
        return self._specs[len(self._resolved):]

    def next_spec(self) -> WindowSpec:
        """The frontier window: firm membership, next to be resolved."""
        return self._specs[len(self._resolved)]

    def resolve(self, x: np.ndarray) -> None:
        """Feed the frontier window's REAL selection (local coords); re-plan."""
        if self.done():
            raise RuntimeError("decomposition already complete")
        before = {s.seq: s.indices for s in self.pending_specs()[1:]}
        self._resolved.append(np.asarray(x))
        self._replay()
        self.replans += 1
        after = {s.seq: s.indices for s in self.pending_specs()}
        self.mispeculations += sum(
            1 for seq, idx in before.items() if after.get(seq) != idx
        )

    def _replay(self) -> None:
        gen = decompose_steps_indexed(self.problem, self.key, p=self.p, q=self.q)
        specs: List[WindowSpec] = []
        guessed: set = set()  # original indices whose survival is a guess
        item = next(gen)  # a decomposition always has >= 1 window
        try:
            while True:
                window, subproblem, m, sub_key = item
                seq = len(specs)
                indices = tuple(int(i) for i in window)
                specs.append(
                    WindowSpec(
                        seq=seq,
                        indices=indices,
                        m=m,
                        key=sub_key,
                        # Guess-invariance (see WindowSpec): only windows that
                        # contain speculated survivors can be invalidated by a
                        # resolve; everything else is firm even when earlier
                        # windows are still in flight.
                        speculative=not guessed.isdisjoint(indices),
                    )
                )
                if seq < len(self._resolved):
                    x = self._resolved[seq]
                elif self.speculate:
                    x = np.asarray(self.guess(subproblem, m))
                    if int(x.sum()) != m:
                        # Guess-invariance of firm memberships rests on every
                        # outcome keeping exactly m survivors.
                        raise ValueError(
                            f"speculation guess kept {int(x.sum())} of window "
                            f"{seq}, must keep exactly {m}"
                        )
                    guessed.update(int(i) for i in window[np.nonzero(x)[0]])
                else:
                    break
                item = gen.send(x)
        except StopIteration as stop:
            # Only a replay fed exclusively by REAL outcomes defines `final`.
            if len(self._resolved) == len(specs):
                self.final = stop.value
        self._specs = specs
