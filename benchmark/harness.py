"""What every cell shares: the manifest and the files found by name in it,
the measured window, the percentile, the device record, the profiled
sub-window and its reduction, the per-layer readers and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``<config entry's file>``: the configuration (widths, types, sources);
- ``traffic/<traffic>.json``: the mix, with ``"driver"`` naming
  ``drivers/<driver>.py``;
- ``limits/<workload>.json``: the cell's correctness limits;
- ``metrics/<metric>.py``: a per-layer reader, ``read(ctx) -> float | None``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pea_diffusion_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> Dict:
    return load_json(bench / "traffic" / f"{name}.json")


def limits(workload_name: str, bench: Path = BENCH) -> Dict:
    return load_json(bench / "limits" / f"{workload_name}.json")


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(metric: str, bench: Path = BENCH):
    """The `read` function of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(man: Dict, wl: str, trace: bool) -> List[Dict]:
    """The metrics a run of workload `wl` reports: its end-to-end ones with
    trace 0, its per-layer ones with trace 1 (a metric without
    ``workloads`` in every cell that reports the metric it moves)."""
    e2e = [m for m in man["end_to_end"] if wl in m.get("workloads", [wl])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (wl in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_loaded(modules: Sequence[str]) -> List[str]:
    """The forbidden top-level names among `modules`, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


# --- the measured window -------------------------------------------------------


def window(events: Sequence[Tuple[float, float]], seconds: float) -> Tuple[float, float, float]:
    """(opening time, closing time, units) of the window over completion
    `events` (time, units): it opens at the first event and closes at the
    first one at least `seconds` after it, so that it holds whole calls or
    steps and a stall anywhere in those seconds lengthens it; the units are
    those completed after the opening, up to and with the closing event."""
    events = sorted(events)
    t0 = events[0][0] if events else None
    closing = [i for i, e in enumerate(events) if e[0] - t0 >= seconds]
    if not closing:
        raise RuntimeError(f"no completion {seconds} s after the window's opening")
    inside = events[1:closing[0] + 1]
    return t0, inside[-1][0], sum(u for _, u in inside)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q % of the values at
    or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


# --- device ------------------------------------------------------------------


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"benchmark: the cell needs {n} CUDA device(s), found {have}")


def card_record() -> Dict:
    """The card's name and power limit and the TF32 switches, for the
    line before the result."""
    import torch

    rec = {"card": torch.cuda.get_device_name(0),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        rec["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        rec["nvidia_smi"] = f"unavailable: {e}"
    return rec


def device_record(count: int = 1) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


# --- the profiled sub-window ---------------------------------------------------


class SubWindow:
    """``torch.profiler`` (host and device activity) over a bounded part of
    the window, started and stopped from whichever thread runs the work;
    the device is synchronised at both ends so that every kernel of the
    sub-window, and none before it, lands in it."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.seconds = None
        self.result = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self._t = time.perf_counter()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t
        self.prof.stop()

    @property
    def done(self) -> bool:
        return self.seconds is not None

    def reduce(self) -> Dict:
        """busy_s, window_s, kernels [(name, start_us, end_us)], and the
        breakdown's device_ops and idle_gaps."""
        if self.result is None:
            self.result = reduce_events(self.prof.events(), self.seconds)
        return self.result


def reduce_events(events, window_s: float, annotation: str = "bench/") -> Dict:
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(annotation)):
                kernels.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    kernels.sort(key=lambda k: k[1])
    busy, gaps, cur = 0.0, [], None
    for _, s, t in kernels:
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    by_name: Dict[str, float] = {}
    for name, s, t in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6

    if kernels and host:  # the idle stretches before the first kernel and after the last
        ends = [(min(h[1] for h in host), kernels[0][1]),
                (max(k[2] for k in kernels), max(h[2] for h in host))]
        gaps += [g for g in ends if g[1] > g[0]]
    idle = _name_gaps(sorted(gaps, key=lambda g: g[0] - g[1])[:200], host, annotation)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy / 1e6, "window_s": window_s, "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def _name_gaps(gaps, host, annotation: str) -> Dict[str, float]:
    """Seconds of idle `gaps` by what the host did at each one's middle:
    the innermost host range or op over it, else "after" the annotated
    range that ended last before it, else "no host op"."""
    import numpy as np

    idle: Dict[str, float] = {}
    if not gaps:
        return idle
    start = np.array([h[1] for h in host], dtype=np.float64)
    end = np.array([h[2] for h in host], dtype=np.float64)
    length = end - start
    marks = [h for h in host if h[0].startswith(annotation)]
    mark_end = np.array([h[2] for h in marks], dtype=np.float64)
    for s, t in gaps:
        at = (s + t) / 2
        over = np.where((start <= at) & (at <= end), length, np.inf)
        if over.size and np.isfinite(over.min()):
            name = host[int(over.argmin())][0]
        else:
            before = np.where(mark_end < at, mark_end, -np.inf)
            name = ("after " + marks[int(before.argmax())][0]
                    if before.size and np.isfinite(before.max()) else "no host op")
        idle[name] = idle.get(name, 0.0) + (t - s) / 1e6
    return idle


def annotate(name: str):
    """A host range the breakdown names idle gaps by (free while no
    profiler runs)."""
    from torch.profiler import record_function

    return record_function("bench/" + name)


# --- the result ----------------------------------------------------------------


def checks_report(values: Dict[str, float], lims: Dict[str, Dict]) -> Tuple[bool, Dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at or under its limit."""
    out, ok = {}, True
    for name, lim in lims["numbers"].items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok &= good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out


def emit(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
         checks: Dict, breakdown: Optional[Dict] = None) -> None:
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
