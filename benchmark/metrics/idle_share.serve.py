"""Share of the profiled sub-window with no kernel on the device: one
minus the union of the kernels' intervals over the sub-window's length.
The serving sub-window is one whole period of the engine after the window:
from the start of a full call to the start of the next, so the call's own
gaps and the turn-around between calls (PNGs, HTTP, batching window,
prompt encoding) weigh as they do in the window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
