"""The whole served step's share of the card's bf16 peak: the encoder's
model FLOPs (frozen count) for the real tokens of every encode job that
finished in the window, over the window's length times 989.4 TFLOP/s."""

from h100bench import frozen
from h100bench.readers import window_spans


def read(ctx):
    enc = ctx.config.get("encoder")
    jobs = window_spans(ctx, "encode.job")
    if enc is None or not jobs:
        return None
    flops = sum(frozen.encoder_flops(enc, s["attrs"]["n_tokens"]) for s in jobs)
    return 100.0 * flops / ((ctx.t1 - ctx.t0) * frozen.PEAK_BF16_FLOPS)
