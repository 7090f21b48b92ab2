"""Mean time from a request's submit to the engine to the start of the
pipeline call that carried it, over the window's requests (host clock)."""


def read(ctx):
    waits = ctx.get("queue_wait_s")
    if not waits:
        return None
    return 1000.0 * sum(waits) / len(waits)
