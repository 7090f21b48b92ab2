"""Device idle inside the profiled engine call: between the first and the
last device event launched under the program's ``engine.call`` span, the
time no device event runs (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    call = found and [d for d in found.device if "engine.call" in d.under]
    if not call:
        return None
    return found.idle_us(min(d.start for d in call), max(d.end for d in call)) / 1e3
