"""Host time the engine's worker waits in the profiled period for the
first request of its next drain (the program's ``engine.refill_wait``
span): the clients' PNG encode, HTTP and next send as the engine sees
them."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    waits = found and [s for s in found.spans if s.name == "engine.refill_wait"]
    if not waits:
        return None
    return sum(s.end - s.start for s in waits) / 1e3
