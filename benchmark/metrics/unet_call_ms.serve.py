"""Mean device time of one UNet forward (one denoising step of a call, the
CFG pair of every row), CUDA events around the module's forward, over the
window's calls."""


def read(ctx):
    ms = ctx.get("unet_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
