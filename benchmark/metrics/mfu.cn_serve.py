"""Model FLOPs of the ControlNet images completed in the window (the
prompts, 30 UNet and 30 ControlNet forwards of the CFG pair with the
embedder, one decode: roofline_controlnet.py) over the window's time and
the H100's bf16 peak (989 TFLOP/s)."""
from benchmark import roofline, roofline_controlnet


def read(ctx):
    if not ctx.get("window_s") or "trace" not in ctx:
        return None
    flops = roofline_controlnet.serve_flops_per_image(ctx["config"], ctx["traffic"]) \
        * ctx["images"]
    return 100.0 * flops / (ctx["window_s"] * roofline.PEAK_FLOPS)
