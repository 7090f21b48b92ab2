"""Device time of the program's ``kd.backward`` phase (the student UNet's
recompute and its gradient to the adapter, on the autograd engine's
thread), per profiled training step (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found, steps = spans.of(ctx), ctx.get("trace_steps")
    if not found or not steps or not found.count("kd.backward"):
        return None
    return found.device_us(lambda d: d.phase == "kd.backward") / steps / 1e3
