"""Device time of the ControlNet's conditioning embedder (its eight
convolutions over the control maps at the served size) a denoising step:
the device events launched under the program's ``controlnet.cond_embed``
span, over the ControlNet forwards of the profiled engine period
(benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    forwards = found and found.count("pipe.controlnet")
    if not forwards or not found.count("controlnet.cond_embed"):
        return None
    return found.device_us(lambda d: "controlnet.cond_embed" in d.under) / forwards / 1e3
