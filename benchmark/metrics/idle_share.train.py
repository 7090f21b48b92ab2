"""Share of the window's time in which no kernel runs on the device: one
minus the device's busy time over the window's time. The busy time is the
union of the kernels' intervals over the profiled steps (whole steps after
the window, so that profiling slows none of it), scaled from their pixels
to the window's steps' pixels, so that a window whose buckets differ from
the profiled steps' is weighed by its own mix."""


def read(ctx):
    tr, traced, window = ctx.get("trace"), ctx.get("trace_hw"), ctx.get("window_hw")
    if not tr or not traced or not window or not ctx.get("window_s"):
        return None
    busy = tr["busy_s"] * sum(h * w for h, w in window) / sum(h * w for h, w in traced)
    return 100.0 * (1.0 - busy / ctx["window_s"])
