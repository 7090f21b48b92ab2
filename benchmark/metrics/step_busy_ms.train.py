"""Device busy time per training step: the union of the kernels'
intervals in the profiled sub-window over its whole steps."""


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("trace_steps")
    if not tr or not steps:
        return None
    return 1000.0 * tr["busy_s"] / steps
