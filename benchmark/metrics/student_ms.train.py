"""Device time of the program's ``kd.student`` phase (the student tower, the
adapter and the student UNet's first forward), per profiled training step
(benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found, steps = spans.of(ctx), ctx.get("trace_steps")
    if not found or not steps or not found.count("kd.student"):
        return None
    return found.device_us(lambda d: d.phase == "kd.student") / steps / 1e3
