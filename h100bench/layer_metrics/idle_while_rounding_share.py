"""Share of the traced slice in which the card was idle while the program's
``pipeline.rounding`` span was open: the device trace's idle gaps
intersected with the rounding spans, both on the host's ``perf_counter``."""

from h100bench.readers import trace_window, window_spans


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(ctx):
    window = trace_window(ctx)
    if window is None or not ctx.device.ops or ctx.device.window_s <= 0:
        return None
    t0, t1 = window
    rounding = _union((max(s["t0"], t0), min(s["t1"], t1))
                      for s in window_spans(ctx, "pipeline.rounding", (t0, float("inf")))
                      if s["t0"] < t1)
    if not rounding:
        return None
    idle, i = 0.0, 0
    for g0, g1 in ctx.device.gaps():  # sorted, disjoint
        while i < len(rounding) and rounding[i][1] <= g0:
            i += 1
        j = i
        while j < len(rounding) and rounding[j][0] < g1:
            idle += min(g1, rounding[j][1]) - max(g0, rounding[j][0])
            j += 1
    return 100.0 * idle / ctx.device.window_s
