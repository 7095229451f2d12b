"""Helpers the metric readers share: spans and counters of the window, and
the traced slice's device operations.  A reader returns None where it finds
nothing to read; the harness then leaves its metric out of the line.

A reader's ``ctx`` holds: ``cell``, ``config``, ``mix``, ``seed``,
``seconds``; ``t0``, ``t1`` (the window, ``perf_counter`` seconds) and
``setup_s``; ``requests`` (those the window owns), each with ``t_sub``,
``t_done``, ``sentences``, ``response``, ``ok``;
``counters`` (the registry's counters at the window's two edges); ``spans``
(the program's span records, times on ``perf_counter``; traced runs only);
``device`` (a ``devtrace.DeviceTrace`` of the window's last seconds, or
None); ``host_spans``."""

from __future__ import annotations

import numpy as np

from h100bench import frozen


def window_spans(ctx, name: str, window=None) -> list[dict]:
    """The program's spans named ``name`` that ended inside ``window``
    (default: the measured window)."""
    t0, t1 = window or (ctx.t0, ctx.t1)
    return [s for s in ctx.spans if s["name"] == name and t0 <= s["t1"] < t1]


def span_p50_ms(ctx, name: str) -> float | None:
    durations = [s["t1"] - s["t0"] for s in window_spans(ctx, name)]
    return 1e3 * float(np.median(durations)) if durations else None


def counter_delta(ctx, name: str) -> float | None:
    c0, c1 = ctx.counters
    if c0 is None or c1 is None or name not in c1:
        return None
    return c1[name] - c0.get(name, 0.0)


def ratio(num: float | None, den: float | None) -> float | None:
    if num is None or not den:
        return None
    return num / den


def trace_window(ctx):
    return None if ctx.device is None else (ctx.device.t0, ctx.device.t1)


def device_seconds(ctx, names) -> float:
    return sum(ctx.device.seconds_by_name(names).values())


def roofline(flops: float, nbytes: float, seconds: float, peak: float) -> float | None:
    """100 x the least time the card could take over the time it took."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * max(flops / peak, nbytes / frozen.PEAK_BYTES_PER_S) / seconds


def idle_share(ctx) -> float | None:
    if ctx.device is None or not ctx.device.ops or ctx.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.device.busy_s / ctx.device.window_s)
