"""Device time of the UNet's GroupNorms (the program's ``groupnorm`` span,
fused or plain, with the time-bias add and the SiLU) inside its
``pipe.unet`` span, per UNet forward of the profiled engine period
(benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    forwards = found and found.count("pipe.unet")
    if not forwards:
        return None
    return found.device_us(lambda d: d.component == "groupnorm"
                           and "pipe.unet" in d.under) / forwards / 1e3
