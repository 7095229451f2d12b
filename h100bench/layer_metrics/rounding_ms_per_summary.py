"""Milliseconds of the program's ``pipeline.rounding`` spans (each request's
stochastic rounding of its iterations, on the driver thread) ending in the
window, over the summaries of the window."""

from h100bench.readers import ratio, window_spans


def read(ctx):
    spans = window_spans(ctx, "pipeline.rounding")
    per = ratio(sum(s["t1"] - s["t0"] for s in spans) if spans else None,
                sum(r.ok for r in ctx.requests))
    return None if per is None else 1e3 * per
