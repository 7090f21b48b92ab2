"""JSONL metric stream and profiler window (port of
``pea_diffusion_tpu/utils/metrics.py``): ``MetricLogger`` writes one record
per logged step with the wall time since the logger started and the steps
per second since the last record; ``ProfilerWindow`` traces a window of
steps with ``torch.profiler``. The EMA summary is not ported: nothing in the
port reads it."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


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


class ProfilerWindow:
    """A ``torch.profiler`` trace of steps [start, stop): ``step(i)`` before
    step i starts the profiler at `start` and stops it at `stop`, writing a
    Chrome trace to ``<logdir>/trace_steps_<start>_<stop>.json`` (``path``),
    with the CUDA activity when `device` is a card. ``close`` stops a window
    that the run ended inside."""

    def __init__(self, logdir: str, start: int, stop: int, device="cpu"):
        if not start < stop:
            raise ValueError(f"profiler window [{start}, {stop}) is empty")
        self.logdir, self.start, self.stop = logdir, start, stop
        self.path = os.path.join(logdir, f"trace_steps_{start}_{stop}.json")
        self._cuda = torch.device(device).type == "cuda"
        self._activities = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = None

    def step(self, i: int):
        if i == self.start and self._prof is None:
            self._prof = torch.profiler.profile(activities=self._activities)
            self._prof.__enter__()
        elif i == self.stop:
            self.close()

    def close(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self._cuda:  # the window's kernels end inside the trace
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(self.path)
