"""Runs one cell of the benchmark once and prints its result line.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, driver, limits and per-layer
readers are files found by the names in BENCHMARK.json (harness.py). With
--trace 0 the line carries the cell's end-to-end metrics, with --trace 1
its per-layer ones (and the profiled sub-window's busy time, length and
breakdown). The check that decides ``correct`` runs after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    harness.require_cards(wl["chips"])
    config = harness.config(man, wl["config"])
    traffic = harness.traffic(wl["traffic"])
    lims = harness.limits(wl["name"])
    print(json.dumps({"card": harness.card_record(), "workload": wl["name"],
                      "seed": args.seed}), flush=True)
    res = harness.driver(traffic["driver"]).run(
        config, traffic, lims, args.seed, args.seconds, bool(args.trace), T_START)
    print(json.dumps({"info": res["info"]}), flush=True)
    metrics = {}
    for m in harness.cell_metrics(man, wl["name"], bool(args.trace)):
        if m["name"] in res["e2e"]:
            value = res["e2e"][m["name"]]
        else:
            value = harness.reader(m["name"])(res["ctx"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = res["device"]
    breakdown = None
    if args.trace:
        tr = res["ctx"].get("trace")
        if tr is None:
            print("benchmark: the profiled sub-window never closed", file=sys.stderr)
            return 1
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = tr["breakdown"]
    # after every reader has run: what any of them loaded counts too
    leaked = harness.forbidden_loaded(list(sys.modules))
    if leaked:
        print(f"benchmark: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 1
    harness.emit(res["correct"], res["attempted"], res["failed"], metrics, device,
                 res["checks"], breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
