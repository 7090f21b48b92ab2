"""Requests per pipeline call over the window's calls (the engine's
co-batching, from the call specs it hands the pipeline)."""


def read(ctx):
    calls = ctx.get("calls")
    if not calls:
        return None
    return sum(len(c["requests"]) for c in calls) / len(calls)
