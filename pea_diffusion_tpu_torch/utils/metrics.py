"""JSONL metric stream (port of ``pea_diffusion_tpu/utils/metrics.py::
MetricLogger``): one record per logged step with the wall time since the
logger started and the steps per second since the last record. The EMA
summary and the profiler window are not ported: nothing in the port reads
them, and ``torch.profiler`` wraps the steps where a trace is wanted."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, directory: Optional[str] = None):
        self.path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(directory, "metrics.jsonl")
        self._t0 = time.time()
        self._last_step = 0
        self._last_t = self._t0

    def log(self, step: int, metrics: Dict[str, float]) -> Dict[str, float]:
        now = time.time()
        rec = {"step": step, "time": round(now - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if step > self._last_step:
            dt = now - self._last_t
            rec["steps_per_sec"] = round((step - self._last_step) / dt, 4) if dt > 0 else 0.0
            self._last_step, self._last_t = step, now
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
