"""Median of the engine's ``request.encode`` spans ending in the window:
from the encode job's submission to its embeddings, queueing included."""

from h100bench.readers import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "request.encode")
