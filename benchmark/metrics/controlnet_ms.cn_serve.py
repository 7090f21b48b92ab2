"""Device time of one ControlNet forward (one denoising step of a call, the
CFG pair of every row): the device events launched under the program's
``pipe.controlnet`` span, the embedder and the zero convs with it, over the
forwards of the profiled engine period (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    forwards = found and found.count("pipe.controlnet")
    if not forwards:
        return None
    return found.device_us(lambda d: "pipe.controlnet" in d.under) / forwards / 1e3
