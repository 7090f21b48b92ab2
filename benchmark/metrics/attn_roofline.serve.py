"""The UNet attention cores' share of their roofline in the profiled
sub-window: the least time of the cores those UNet forwards ran (query
lengths the hand-written kernels serve; each at the larger of its FLOPs
over the bf16 peak and its bytes over HBM bandwidth, counted from the
configuration's shapes) over the device time of the kernels that
implement them."""
from benchmark import roofline


def read(ctx):
    tr, rows = ctx.get("trace"), ctx.get("trace_forwards")
    if not tr or not rows:
        return None
    tf = ctx["traffic"]
    lat = tf["size"] // 8
    calls = roofline.unet_attention(ctx["config"]["components"]["unet"]["config"], lat, lat,
                                    tf["max_length"])
    least = sum(roofline.attention_least_s(calls, b) for b in rows)
    return roofline.share(least, tr["kernels"])
