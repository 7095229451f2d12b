"""Anneal jobs a drain of the COBI farm in the window."""

from h100bench.readers import counter_delta, ratio


def read(ctx):
    return ratio(counter_delta(ctx, "farm_jobs_total"), counter_delta(ctx, "farm_drains_total"))
