"""Device time of the program's ``kd.vae_encode`` phase (the fp32 VAE encode
and sample), per profiled training step (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found, steps = spans.of(ctx), ctx.get("trace_steps")
    if not found or not steps or not found.count("kd.vae_encode"):
        return None
    return found.device_us(lambda d: d.phase == "kd.vae_encode") / steps / 1e3
