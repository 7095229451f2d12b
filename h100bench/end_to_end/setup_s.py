"""Process start to the window's first request: imports, the kernels'
build or load, the weights, the shapes' warm-up and the warm traffic."""


def read(ctx):
    return ctx.setup_s
