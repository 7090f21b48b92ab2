"""DDPM forward process for KD training (port of the training side of
``pea_diffusion_tpu/schedulers/ddpm.py``; parity target diffusers
DDPMScheduler(beta_start=0.00085, beta_end=0.012,
beta_schedule="scaled_linear")). The ancestral sampling step is not ported
(ROADMAP Queue A item 15)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import common
from .common import NoiseScheduleConfig, make_alphas_cumprod


class DDPMSchedule(NamedTuple):
    alphas_cumprod: torch.Tensor  # [T] fp32
    betas: torch.Tensor           # [T] fp32
    num_train_timesteps: int
    prediction_type: str = "epsilon"


def make_schedule(cfg: NoiseScheduleConfig) -> DDPMSchedule:
    acp = make_alphas_cumprod(cfg)
    alphas = np.empty_like(acp)
    alphas[0] = acp[0]
    alphas[1:] = acp[1:] / acp[:-1]
    return DDPMSchedule(
        alphas_cumprod=torch.from_numpy(acp.astype(np.float32)),
        betas=torch.from_numpy((1 - alphas).astype(np.float32)),
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type,
    )


def add_noise(sched: DDPMSchedule, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    return common.add_noise(sched.alphas_cumprod, sample, noise, timesteps)
