"""Named spans at the port's layer boundaries, on the profiler's timeline.

``span(name)`` is ``torch.profiler.record_function("pea/" + name)`` while a
``torch.profiler`` runs, so a span lands on the same clock as the kernels
it launches (Kineto records host ranges and CUPTI activity on one
timeline), and a reader of the trace can put each kernel and each idle gap
of the device down to the span that was open on the host. With no profiler
running it returns one shared object that does nothing, after a single
check of the profiler's enabled flag: a ``record_function`` built and
entered with no profiler costs microseconds, and serving enters about 1,400
GroupNorm spans a call. The profiler holds the events; nothing is kept
here.

Spans (what each covers; ``benchmark/spans.py`` reads them):

- ``engine.refill_wait``, ``engine.batch_window``, ``engine.prepare``,
  ``engine.call`` (args: the call's rows), ``engine.to_pil``:
  ``cli/serve.py::BatchingEngine``;
- ``pipe.encode_prompt``, ``pipe.sampler_step`` (one denoising step),
  ``pipe.unet`` (its UNet forward, inside it), ``pipe.decode``:
  ``pipelines/text2image.py``;
- ``groupnorm``: every ``models/layers.py::GroupNorm`` call;
- ``train.h2d``: ``train/trainer.py``; ``kd.vae_encode``, ``kd.student``,
  ``kd.teacher``, ``kd.loss``, ``kd.backward``, ``kd.optimizer``:
  ``train/kd.py``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "pea/"
NO_SPAN = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A context manager: the host range ``pea/<name>`` (with `args` as its
    string argument) while a profiler runs, else ``NO_SPAN``."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return record_function(PREFIX + name, args)
