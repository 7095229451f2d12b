"""Encode jobs a pass of the encoder stage in the window."""

from h100bench.readers import counter_delta, ratio


def read(ctx):
    return ratio(counter_delta(ctx, "encoder_jobs_total"),
                 counter_delta(ctx, "encoder_launches_total"))
