"""Model FLOPs of the samples trained in the window (no recomputation; each
step at its batch's image size) over the window's time and the H100's
bf16 peak (989 TFLOP/s). A step's FLOPs depend on its pixel count alone
(every product scales with the positions of its level, whose sides the
buckets' multiples of 64 halve exactly), so each count is made once a
pixel count."""
from benchmark import roofline


def read(ctx):
    if not ctx.get("window_s") or "trace" not in ctx or not ctx.get("window_hw"):
        return None
    shape_of = {h * w: (h, w) for h, w in ctx["window_hw"]}
    per_sample = {n: roofline.train_flops_per_sample(ctx["config"], ctx["traffic"], hw)
                  for n, hw in shape_of.items()}
    flops = ctx["traffic"]["batch"] * sum(per_sample[h * w] for h, w in ctx["window_hw"])
    return 100.0 * flops / (ctx["window_s"] * roofline.PEAK_FLOPS)
