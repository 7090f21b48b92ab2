"""The attention cores' share of their roofline in the profiled sub-window
of the ControlNet cell: the least time of the cores that its UNet and
ControlNet forwards ran (query lengths the hand-written kernels serve; each
at the larger of its FLOPs over the bf16 peak and its bytes over HBM
bandwidth, counted from the configuration's shapes: roofline.py,
roofline_controlnet.py) over the device time of the kernels that implement
them, both models' launches alike."""
from benchmark import roofline, roofline_controlnet


def read(ctx):
    tr, rows = ctx.get("trace"), ctx.get("trace_forwards")
    cn_rows = ctx.get("trace_controlnet_forwards")
    if not tr or not rows or not cn_rows:
        return None
    tf, comp = ctx["traffic"], ctx["config"]["components"]
    lat = tf["size"] // 8
    unet = roofline.unet_attention(comp["unet"]["config"], lat, lat, tf["max_length"])
    cn = roofline_controlnet.controlnet_attention(comp["controlnet"]["config"], lat, lat,
                                                  tf["max_length"])
    least = sum(roofline.attention_least_s(unet, b) for b in rows) + sum(
        roofline.attention_least_s(cn, b) for b in cn_rows)
    return roofline.share(least, tr["kernels"])
