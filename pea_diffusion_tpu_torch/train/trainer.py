"""Training loop (port of ``pea_diffusion_tpu/train/trainer.py``): the KD
step over a stream of batches, on one device or over a mesh
(parallel/mesh.py), the JSONL metric log, checkpoint rotation with the
adapter exported in the reference's format, and resume.

The train state (step, adapter, optimizer) goes through ``torch.save`` to
``<output_dir>/checkpoints/step_<N>.pt`` (the newest ``save_top_k`` kept);
the adapter also goes to ``<output_dir>/proj_<N>/pytorch_model.bin`` (and
its ``model.safetensors`` sibling) under the reference's names, through
``checkpoints/orbax_io.export_adapter``. ``warmup`` runs the step once per
aspect bucket before ``fit`` (the JAX package compiles there; here the
kernels build, the convolutions meet their shapes and the allocator grows
to its peak), and a ``profile_window`` (start, stop) traces those steps
with ``torch.profiler`` under ``<output_dir>/trace``.

Over a mesh (``mesh``, or ``make_mesh(cfg.mesh_shape)`` when a process group
is up): the frozen UNet is sharded over fsdp (``shard_params``), each rank
takes its rows of the global batch (``shard_batch``; with
``local_batches=True`` the batches are already the rank's own, as a reader
that splits shards by rank gives them), the adapter gradient is averaged
over dcn x data in one ``all_reduce`` before the update, and
``consumed_samples`` counts every data rank's rows. Rank 0 alone writes the
metric log, the checkpoints and the trace, behind a barrier; ``resume``
runs on every rank. Training has no tensor parallelism, as in the JAX
package.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoints.orbax_io import export_adapter
from ..configs.train import TrainConfig
from ..data.buckets import BUCKETS
from ..parallel import distributed as pdist
from ..parallel import mesh as pmesh
from ..utils.metrics import MetricLogger, ProfilerWindow
from .kd import KDModels, KDState, kd_loss, make_train_step

ARRAY_KEYS = (
    "pixel_values", "input_ids", "input_ids_uncond",
    "input_ids_zh", "input_ids_uncond_zh",  # mul_zh second tower
    "teacher_ids_1", "teacher_ids_2",
    "teacher_uncond_ids_1", "teacher_uncond_ids_2",
    "time_ids", "zh_or_not",
)


def _batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k in ARRAY_KEYS:
        if k in batch:
            v = batch[k]
            out[k] = (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v).to(device)
    return out


def _sum_over(group):
    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    return reduce


class KDTrainer:
    def __init__(self, models: KDModels, cfg: TrainConfig, mesh=None,
                 profile_window: Optional[Tuple[int, int]] = None,
                 local_batches: bool = False):
        self.models, self.cfg = models, cfg
        if mesh is None and dist.is_initialized():
            mesh = pmesh.make_mesh(cfg.mesh_shape)
        self.mesh, self.local_batches = mesh, local_batches
        self.data_shard, reduce = (0, 1), None
        if mesh is not None:
            pmesh.shard_params(models, mesh)
            self.data_shard = pmesh.batch_shards(mesh)
            reduce = _sum_over(pmesh.batch_group(mesh))
        init_fn, self.step_fn = make_train_step(models, cfg, self.data_shard, reduce)
        self.state: KDState = init_fn()
        self.main = pdist.is_main()
        self.logger = MetricLogger(cfg.output_dir if self.main else None)
        self.ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
        self.host_step = 0
        # rows of the last batch fed to fit(): consumed_samples follows the
        # step counter, as the reference restores it
        self._batch_rows: Optional[int] = None
        self.profiler = (ProfilerWindow(os.path.join(cfg.output_dir, "trace"),
                                        *profile_window, device=models.device)
                         if profile_window and self.main else None)

    def _checkpoints(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        steps = [int(m.group(1)) for f in os.listdir(self.ckpt_dir)
                 if (m := re.fullmatch(r"step_(\d+)\.pt", f))]
        return sorted(steps)

    def resume(self) -> int:
        """Restores the newest checkpoint, if any; returns the step."""
        steps = self._checkpoints()
        if steps:
            ck = torch.load(os.path.join(self.ckpt_dir, f"step_{steps[-1]}.pt"),
                            map_location=self.models.device, weights_only=True)
            self.models.adapter.load_state_dict(ck["adapter"])
            self.state = KDState(step=ck["step"], optimizer=ck["optimizer"])
            self.host_step = ck["step"]
            print(f"resumed from step {self.host_step} "
                  f"(consumed_samples={self.consumed_samples})")
        return self.host_step

    @property
    def consumed_samples(self) -> int:
        """Global samples so far: steps x a rank's rows x the data ranks."""
        rows = self._batch_rows or self.cfg.batch_size_per_device
        return self.host_step * rows * self.data_shard[1]

    def fit(self, batches: Iterable[Dict], max_steps: Optional[int] = None) -> KDState:
        cfg = self.cfg
        start = self.host_step
        limit = max_steps if max_steps is not None else cfg.total_steps
        dev = self.models.device
        for batch in batches:
            step = self.host_step
            if step >= limit:
                break
            if self.profiler:
                self.profiler.step(step)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + step)
            if self.mesh is not None and not self.local_batches:
                batch = pmesh.shard_batch(batch, self.mesh, max(1, cfg.grad_accum_steps))
            batch = _batch_to_device(batch, dev)
            self._batch_rows = batch["pixel_values"].shape[0]
            self.state, metrics = self.step_fn(self.state, batch, gen)
            new_step = self.host_step = step + 1
            if self.main and (new_step % cfg.log_every_n_steps == 0 or new_step == start + 1):
                m = {k: float(v) for k, v in metrics.items()}
                m["consumed_samples"] = self.consumed_samples
                rec = self.logger.log(new_step, m)
                print(f"step {new_step}: " + " ".join(
                    f"{k}={v:.5g}" for k, v in rec.items() if k not in ("step", "time")))
            if new_step % cfg.every_n_steps == 0:
                self.checkpoint(new_step)
        if self.profiler:
            self.profiler.close()
        return self.state

    def warmup(self, batch_size: int, text_len: int, teacher_len: int = 77,
               buckets: Optional[Sequence[int]] = None, text_len_zh: Optional[int] = None):
        """One student and teacher forward and backward of the KD loss per
        aspect bucket (all nine by default) at a micro-batch of the step, on
        zeros, so that the kernels build, the convolutions meet their shapes
        and the allocator grows before `fit`. The gradient goes through
        ``torch.autograd.grad``: the adapter, its ``.grad``, the optimizer
        state, ``host_step`` and the metric log stay as they were."""
        m, dev = self.models, self.models.device
        rows = batch_size // max(1, self.cfg.grad_accum_steps)
        buckets = range(len(BUCKETS)) if buckets is None else buckets
        params = [p for p in m.adapter.parameters() if p.requires_grad]

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        for b in buckets:
            w, h = BUCKETS[b]
            batch = {
                "pixel_values": zeros(rows, h, w, 3, dtype=torch.float32),
                "input_ids": zeros(rows, text_len),
                "input_ids_uncond": zeros(rows, text_len),
                "teacher_ids_1": zeros(rows, teacher_len),
                "teacher_uncond_ids_1": zeros(rows, teacher_len),
                "zh_or_not": zeros(rows, dtype=torch.float32),
            }
            if text_len_zh is not None:  # mul_zh dual tokenization
                batch["input_ids_zh"] = zeros(rows, text_len_zh)
                batch["input_ids_uncond_zh"] = zeros(rows, text_len_zh)
            if m.teacher_clip2 is not None:
                batch["teacher_ids_2"] = zeros(rows, teacher_len)
                batch["teacher_uncond_ids_2"] = zeros(rows, teacher_len)
                batch["time_ids"] = zeros(rows, 6, dtype=torch.float32)
            gen = torch.Generator(device=dev).manual_seed(b)
            loss, _ = kd_loss(m, self.cfg, batch, gen)
            torch.autograd.grad(loss, params, allow_unused=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"warmup: bucket {b} ({w}x{h}) ready")

    def checkpoint(self, step: int):
        """Rank 0 writes; every rank waits for it at a barrier."""
        if self.main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            torch.save({"step": step, "adapter": self.models.adapter.state_dict(),
                        "optimizer": self.state.optimizer},
                       os.path.join(self.ckpt_dir, f"step_{step}.pt"))
            for old in self._checkpoints()[:-self.cfg.save_top_k]:
                os.remove(os.path.join(self.ckpt_dir, f"step_{old}.pt"))
            export_adapter(self.models.adapter, self.cfg.output_dir, step)
            print(f"checkpointed step {step}")
        pdist.barrier()
