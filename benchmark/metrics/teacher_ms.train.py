"""Device time of the program's ``kd.teacher`` phase (the teacher towers and
UNet, without gradient), per profiled training step (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found, steps = spans.of(ctx), ctx.get("trace_steps")
    if not found or not steps or not found.count("kd.teacher"):
        return None
    return found.device_us(lambda d: d.phase == "kd.teacher") / steps / 1e3
