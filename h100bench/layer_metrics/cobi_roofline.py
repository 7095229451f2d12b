"""The COBI kernels' share of their roofline in the traced slice: the frozen
operations and bytes of every job the farm finished there, at the job's own
spins and reads (fused anneal, read-out and best-of), over the device time
of the COBI kernels there."""

from h100bench import frozen
from h100bench.readers import device_seconds, roofline, trace_window, window_spans


def read(ctx):
    window = trace_window(ctx)
    if window is None:
        return None
    reads = ctx.config["solve"]["reads"]
    steps = ctx.config["solve"]["steps"]
    shapes = [(reads, s["attrs"]["lanes"], 1)
              for s in window_spans(ctx, "farm.job", window)]
    if not shapes:
        return None
    flops, nbytes = frozen.batched_work("cobi_fused_best_batched", shapes, steps=steps)
    return roofline(flops, nbytes, device_seconds(ctx, frozen.COBI_KERNELS),
                    frozen.PEAK_F32_FLOPS)
