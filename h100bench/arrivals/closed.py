"""Closed loop: ``clients`` callers, each sending its next request the
moment its answer returns.  The window owns the requests answered in it."""

from __future__ import annotations

import math


def in_flight(mix: dict) -> int:
    return int(mix["clients"])


def drive(loop, traffic, tick) -> None:
    for _ in range(in_flight(traffic.mix)):
        loop.submit_next()
    tick(math.inf)


def on_answer(loop) -> None:
    loop.submit_next()


def owns(r, t0: float, t1: float) -> bool:
    """Whether the window owns a request, once it is answered."""
    return not math.isnan(r.t_done) and t0 <= r.t_done < t1
