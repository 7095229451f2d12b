"""Median of the program's ``request.queue`` spans ending in the window:
from a request's entry into the engine's queue to the driver adopting it
at the start of a round."""

from h100bench.readers import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "request.queue")
