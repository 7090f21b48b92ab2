"""Model FLOPs of the images completed in the window over the window's
time and the H100's bf16 peak (989 TFLOP/s)."""
from benchmark import roofline


def read(ctx):
    if not ctx.get("window_s") or "trace" not in ctx:
        return None
    flops = roofline.serve_flops_per_image(ctx["config"], ctx["traffic"]) * ctx["images"]
    return 100.0 * flops / (ctx["window_s"] * roofline.PEAK_FLOPS)
