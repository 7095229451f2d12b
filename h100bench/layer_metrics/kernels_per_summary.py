"""Device kernels in the traced slice (copies and sets not counted) over the
summaries completed in it."""


def read(ctx):
    if ctx.device is None or not ctx.device.ops:
        return None
    t0, t1 = ctx.device.t0, ctx.device.t1
    done = sum(r.ok and t0 <= r.t_done < t1 for r in ctx.requests)
    kernels = sum(not name.startswith(("Memcpy", "Memset")) for name, _, _ in ctx.device.ops)
    return kernels / done if done else None
