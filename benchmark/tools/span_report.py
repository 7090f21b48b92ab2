"""A traced run of one cell with the profiled sub-window put down to the
program's spans (benchmark/spans.py): the cell's per-layer metrics, the
sub-window's busy time and length, device time by phase and component,
idle by the span over it, and the checks of the attribution against the
benchmark's own timings. One JSON line a seed.

  python3 benchmark/tools/span_report.py --workload sdxl-serve-dpm30-c8 --seeds 11
  python3 benchmark/tools/span_report.py --workload sd15-kd-train-b40 --seeds 11,12
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

from benchmark import harness, spans  # noqa: E402


def summary(ctx) -> dict:
    """The attribution's report and its checks: the unattributed share of
    the busy time; the most launched kernels, the costliest and the
    components' seconds by phase; kernels of the harness's reduction named
    as spans (none: spans are no device work); a serving period's device
    time under ``pipe.unet`` a forward and under ``pipe.decode`` a row; a
    training step's phases."""
    found, tr = spans.of(ctx), ctx["trace"]
    if found is None:
        return {"spans": None}
    rep = spans.report(found)
    busy = tr["busy_s"]
    launches, seconds = {}, {}
    for d in found.device:
        key = (d.phase, d.component, d.name[:80])
        launches[key] = launches.get(key, 0) + 1
        seconds[key] = seconds.get(key, 0.0) + (d.end - d.start) / 1e6
    by_phase, components = {}, {}
    for (phase, comp, name), sec in sorted(seconds.items(), key=lambda kv: -kv[1]):
        by_phase.setdefault(str(phase), []).append([comp, name, sec])
        if comp:
            components[f"{phase}/{comp}"] = components.get(f"{phase}/{comp}", 0.0) + sec
    out = {"report": rep, "busy_s": busy, "window_s": tr["window_s"],
           "unattributed_share": rep["device_s"].get("unattributed", 0.0) / busy if busy else None,
           "span_counts": {n: found.count(n) for n in sorted({s.name for s in found.spans})},
           "launches": [[*k, n] for k, n in sorted(launches.items(), key=lambda kv: -kv[1])[:15]],
           "top_kernels": {phase: rows[:8] for phase, rows in by_phase.items()},
           "component_s_by_phase": components,
           "span_named_kernels": sum(1 for k in tr["kernels"] if k[0].startswith(spans.PREFIX))}
    forwards = ctx.get("trace_forwards")
    if forwards:
        unet = found.device_us(lambda d: "pipe.unet" in d.under) / 1e3
        decode = found.device_us(lambda d: "pipe.decode" in d.under) / 1e3
        out["unet_ms_a_forward"] = unet / found.count("pipe.unet")
        out["decode_ms_a_row"] = decode / (forwards[0] // 2)
    steps = ctx.get("trace_steps")
    if steps:
        out["step_ms"] = {k: 1e3 * v / steps for k, v in rep["device_s"].items()}
        out["phases_ms_a_step"] = sum(v for k, v in out["step_ms"].items()
                                      if k != "unattributed")
        out["busy_ms_a_step"] = 1e3 * busy / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    harness.require_cards(wl["chips"])
    config = harness.config(man, wl["config"])
    tr = harness.traffic(wl["traffic"])
    lims = harness.limits(wl["name"])
    print(json.dumps({"card": harness.card_record()}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.driver(tr["driver"]).run(config, tr, lims, seed, args.seconds, True,
                                               time.perf_counter())
        ctx = res["ctx"]
        metrics = {m["name"]: harness.reader(m["name"])(ctx)
                   for m in harness.cell_metrics(man, wl["name"], True)}
        print(json.dumps({"seed": seed, "correct": res["correct"], "e2e": res["e2e"],
                          "metrics": metrics, "breakdown": ctx["trace"]["breakdown"],
                          "spans": summary(ctx)}), flush=True)
        del res, ctx
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
