"""Training loop on one device (port of
``pea_diffusion_tpu/train/trainer.py``): the KD step over a stream of
batches, the JSONL metric log, checkpoint rotation with the adapter exported
in the reference's format, and resume.

The train state (step, adapter, optimizer) goes through ``torch.save`` to
``<output_dir>/checkpoints/step_<N>.pt`` (the newest ``save_top_k`` kept);
the adapter also goes to ``<output_dir>/proj_<N>/pytorch_model.bin`` (and
its ``model.safetensors`` sibling) under the reference's names, through
``checkpoints/orbax_io.export_adapter``. DDP/FSDP and the
per-bucket warmup are not ported (ROADMAP Queue A items 14 and 17).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..checkpoints.orbax_io import export_adapter
from ..configs.train import TrainConfig
from ..utils.metrics import MetricLogger
from .kd import KDModels, KDState, make_train_step

ARRAY_KEYS = (
    "pixel_values", "input_ids", "input_ids_uncond",
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


class KDTrainer:
    def __init__(self, models: KDModels, cfg: TrainConfig):
        self.models, self.cfg = models, cfg
        init_fn, self.step_fn = make_train_step(models, cfg)
        self.state: KDState = init_fn()
        self.logger = MetricLogger(cfg.output_dir)
        self.ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
        self.host_step = 0
        # rows of the last batch fed to fit(): consumed_samples follows the
        # step counter, as the reference restores it
        self._batch_rows: Optional[int] = None

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
        rows = self._batch_rows or self.cfg.batch_size_per_device
        return self.host_step * rows

    def fit(self, batches: Iterable[Dict], max_steps: Optional[int] = None) -> KDState:
        cfg = self.cfg
        start = self.host_step
        limit = max_steps if max_steps is not None else cfg.total_steps
        dev = self.models.device
        for batch in batches:
            step = self.host_step
            if step >= limit:
                break
            gen = torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + step)
            batch = _batch_to_device(batch, dev)
            self._batch_rows = batch["pixel_values"].shape[0]
            self.state, metrics = self.step_fn(self.state, batch, gen)
            new_step = self.host_step = step + 1
            if new_step % cfg.log_every_n_steps == 0 or new_step == start + 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["consumed_samples"] = self.consumed_samples
                rec = self.logger.log(new_step, m)
                print(f"step {new_step}: " + " ".join(
                    f"{k}={v:.5g}" for k, v in rec.items() if k not in ("step", "time")))
            if new_step % cfg.every_n_steps == 0:
                self.checkpoint(new_step)
        return self.state

    def checkpoint(self, step: int):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        torch.save({"step": step, "adapter": self.models.adapter.state_dict(),
                    "optimizer": self.state.optimizer},
                   os.path.join(self.ckpt_dir, f"step_{step}.pt"))
        for old in self._checkpoints()[:-self.cfg.save_top_k]:
            os.remove(os.path.join(self.ckpt_dir, f"step_{old}.pt"))
        export_adapter(self.models.adapter, self.cfg.output_dir, step)
        print(f"checkpointed step {step}")
