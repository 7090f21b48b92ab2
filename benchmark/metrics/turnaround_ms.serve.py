"""Device idle of the profiled engine period after its call: from the end
of the last device event launched under the program's ``engine.call`` or
``engine.to_pil`` span (the decode, the images' copy to the host) to the
period's end, the start of the next call (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    found = spans.of(ctx)
    call = found and [d for d in found.device
                      if {"engine.call", "engine.to_pil"} & set(d.under)]
    if not call:
        return None
    return found.idle_us(max(d.end for d in call), found.host_end) / 1e3
