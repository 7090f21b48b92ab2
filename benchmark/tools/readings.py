"""The readings that a cell's correctness limits are set from, on the chip,
in one process (the kernel library loads once): the compared numbers of
sound runs of the program over many seeds (a whole run each, with a short
window), of the control, and for a training cell of each fault planted in
the reference put in the program's place. One JSON line a reading.

  python3 benchmark/tools/readings.py --workload sdxl-serve-dpm30-c8 \\
      --seeds 11,12,13 --variant program --seconds 16
  python3 benchmark/tools/readings.py --workload sd15-kd-train-b40 \\
      --seeds 11,12,13 --variant faults --seconds 1

Variants: "program"; "control" (serving: the program's int8 UNet convs and
bf16 VAE); "faults" (training: the control of ``reference/lowp.py``, then the faults
"half" and "altered" of ``reference/checks.py::train_reference``, each
against the fp32 reference).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers import train  # noqa: E402
from benchmark.reference import checks  # noqa: E402


def train_faults(config, tr, seed, device="cuda"):
    hp = train.hyper(config, tr)
    n = tr["checked_steps"]
    source = train.batch_source(config, tr, seed, device)
    try:
        for s in range(n):
            source.next(s)
        batches = source.checked()
    finally:
        source.close()
    draws = [int(seed) * 1_000_003 + s for s in range(n)]
    chunk = tr["reference_chunk"]
    t = time.perf_counter()
    ref = checks.train_reference(config, hp, seed, batches, draws, device, chunk)
    yield "reference_s", {"seconds": time.perf_counter() - t, "losses": ref["losses"]}
    for name, kw in (("control", {"control": True}), ("half", {"fault": "half"}),
                     ("altered", {"fault": "altered"})):
        other = checks.train_reference(config, hp, seed, batches, draws, device, chunk, **kw)
        yield name, checks.train_numbers(other, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variant", default="program", choices=("program", "control", "faults"))
    ap.add_argument("--seconds", type=float, default=16.0)
    args = ap.parse_args(argv)
    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    harness.require_cards(wl["chips"])
    config = harness.config(man, wl["config"])
    tr = harness.traffic(wl["traffic"])
    lims = harness.limits(wl["name"])
    drv = harness.driver(tr["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.variant == "faults":
            for name, values in train_faults(config, tr, seed):
                print(json.dumps({"seed": seed, "variant": name, "compared": values}),
                      flush=True)
        else:
            res = drv.run(config, tr, lims, seed, args.seconds, False, t,
                          variant=args.variant)
            print(json.dumps({"seed": seed, "variant": args.variant,
                              "compared": res["info"]["compared"], "e2e": res["e2e"],
                              "seconds": time.perf_counter() - t,
                              "peak": res["device"]["memory_peak_bytes"]}), flush=True)
            del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
