"""Share of the traced slice in which no operation ran on the card."""

from h100bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
