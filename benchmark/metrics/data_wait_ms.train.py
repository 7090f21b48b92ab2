"""Host time the trainer waits in ``next()`` on its batch iterator, mean
per step of the window. It times the program's data pipeline only in a mix
fed from shards (``kd-b10-shards``); a mix kept in host memory bypasses
that layer, so no cell of such a mix lists this metric."""


def read(ctx):
    waits = ctx.get("data_wait_s")
    if not waits:
        return None
    return 1000.0 * sum(waits) / len(waits)
