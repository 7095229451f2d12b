"""Share of the window the encoder stage spent inside its passes
(encoder_busy_seconds_total, each pass timed up to a device synchronise)."""

from h100bench.readers import counter_delta, ratio


def read(ctx):
    share = ratio(counter_delta(ctx, "encoder_busy_seconds_total"), ctx.t1 - ctx.t0)
    return None if share is None else 100.0 * share
