"""Summaries completed in the window over the window's length."""


def read(ctx):
    return sum(r.ok for r in ctx.requests) / (ctx.t1 - ctx.t0)
