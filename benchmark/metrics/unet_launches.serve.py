"""Device events (kernels, copies, sets; hand-written or library) launched
under the program's ``pipe.unet`` span, per UNet forward of the profiled
engine period (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    forwards = found and found.count("pipe.unet")
    if not forwards:
        return None
    return sum(1 for d in found.device if d.phase == "pipe.unet") / forwards
