"""The flash kernels' share of their roofline in the traced slice: the
frozen flash count (4 B H D a causal pair, every layer) of the real tokens
of every encode job that finished there, at bf16's peak, over the device
time of the flash kernels there."""

from h100bench import frozen
from h100bench.readers import device_seconds, roofline, trace_window, window_spans


def read(ctx):
    window, enc = trace_window(ctx), ctx.config.get("encoder")
    if window is None or enc is None:
        return None
    heads, layers = enc["num_attention_heads"], enc["num_hidden_layers"]
    hd = enc["hidden_size"] // heads
    flops = sum(layers * frozen.flash_flops(1, heads, hd, s["attrs"]["n_tokens"])
                for s in window_spans(ctx, "encode.job", window))
    # Q, K, V read and O written once, bf16, for each real token and layer.
    nbytes = sum(layers * 4 * 2 * enc["hidden_size"] * s["attrs"]["n_tokens"]
                 for s in window_spans(ctx, "encode.job", window))
    return roofline(flops, nbytes, device_seconds(ctx, frozen.FLASH_KERNELS),
                    frozen.PEAK_BF16_FLOPS)
