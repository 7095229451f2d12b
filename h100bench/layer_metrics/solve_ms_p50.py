"""Median of the engine's ``request.solve`` spans (formulation, rounding,
anneals on the farm, repair and best-of, decomposition) ending in the window."""

from h100bench.readers import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "request.solve")
