"""The UNet attention cores' share of their roofline over the profiled
training steps: per step the teacher's forward, the student's forward and
the student's backward to the adapter (recomputation not counted), each
core at the larger of its FLOPs over the bf16 peak and its bytes over HBM
bandwidth, from the configuration's shapes at the step's image size, over
the device time of the kernels that implement them."""
from benchmark import roofline


def read(ctx):
    tr, shapes = ctx.get("trace"), ctx.get("trace_hw")
    if not tr or not shapes:
        return None
    tf = ctx["traffic"]
    unet = ctx["config"]["components"]["unet"]["config"]
    f = 2 ** (len(ctx["config"]["components"]["vae"]["config"]["block_out_channels"]) - 1)
    least = 0.0
    for h, w in shapes:
        teacher = roofline.unet_attention(unet, h // f, w // f, tf["teacher_tokens"])
        student = roofline.unet_attention(unet, h // f, w // f, tf["text_tokens"])
        least += (roofline.attention_least_s(teacher, tf["batch"])
                  + roofline.attention_least_s(student, tf["batch"], backward=True))
    return roofline.share(least, tr["kernels"])
