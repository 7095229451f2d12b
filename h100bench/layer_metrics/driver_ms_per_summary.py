"""Wall milliseconds the engine's driver thread spent inside its rounds
within the window (the ``engine.round`` spans, cut at the window's edges)
over the summaries of the window: what one summary costs the single thread
that formulates, rounds, submits, drains and reduces for every request in
flight.  The spans are those whose durations the counter
``engine_driver_busy_seconds_total`` sums; the counter alone would count a
round that straddles an edge whole.  Where the driver is never idle, this
is the window over its summaries, 1000 / ``summaries_per_s``; its parts
are the other readers of the layer."""

from h100bench.readers import ratio


def read(ctx):
    t0, t1 = ctx.t0, ctx.t1
    rounds = [s for s in ctx.spans if s["name"] == "engine.round" and s["t1"] > t0 and s["t0"] < t1]
    busy = sum(min(s["t1"], t1) - max(s["t0"], t0) for s in rounds) if rounds else None
    per = ratio(busy, sum(r.ok for r in ctx.requests))
    return None if per is None else 1e3 * per
