"""Milliseconds the engine's driver thread spent blocked polling encode
futures (``engine_encode_wait_seconds_total``) over the summaries of the
window: time every other request in flight waited for its next step."""

from h100bench.readers import counter_delta, ratio


def read(ctx):
    wait = counter_delta(ctx, "engine_encode_wait_seconds_total")
    per = ratio(wait, sum(r.ok for r in ctx.requests))
    return None if per is None else 1e3 * per
