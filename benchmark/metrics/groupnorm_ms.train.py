"""Device time of the UNets' GroupNorms per profiled training step: under
the program's ``groupnorm`` span (the teacher's and the student's forward,
the student's recompute) or in a backward node whose forward op ran under
one, outside the ``kd.vae_encode`` phase (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found, steps = spans.of(ctx), ctx.get("trace_steps")
    if not found or not steps or not found.count("groupnorm"):
        return None
    return found.device_us(lambda d: d.component == "groupnorm"
                           and "kd.vae_encode" not in d.under) / steps / 1e3
