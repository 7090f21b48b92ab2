"""Device time of the VAE decode per decoded row, CUDA events around the
decoder, mean over the window's calls."""


def read(ctx):
    ms = ctx.get("decode_ms_per_image")
    if not ms:
        return None
    return sum(ms) / len(ms)
