"""DDPM: the forward process for KD training and the ancestral sampling
step (port of ``pea_diffusion_tpu/schedulers/ddpm.py``; parity target
diffusers DDPMScheduler(beta_start=0.00085, beta_end=0.012,
beta_schedule="scaled_linear"))."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import common
from .common import NoiseScheduleConfig, make_alphas_cumprod, predict_x0


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


def get_velocity(sched: DDPMSchedule, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    return common.get_velocity(sched.alphas_cumprod, sample, noise, timesteps)


def step(sched: DDPMSchedule, t: int, sample: torch.Tensor, model_output: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral p(x_{t-1} | x_t) step at train timestep `t`: the posterior
    mean (Ho et al. eq. 7), plus sqrt(variance) * `noise` (a draw in the
    sample's type; none at t = 0, and none without a draw). Computed in
    float32, the type the JAX step promotes to from its float32 tables, and
    returned in it."""
    f32 = np.float32
    acp = sched.alphas_cumprod
    acp_t, beta_t = f32(acp[t]), f32(sched.betas[t])
    acp_prev = f32(acp[max(t - 1, 0)]) if t > 0 else f32(1.0)
    a_t, s_t = np.sqrt(acp_t), np.sqrt(f32(1) - acp_t)
    x = sample.float()
    x0 = predict_x0(sched.prediction_type, x, model_output.float(), float(a_t), float(s_t))
    coef_x0 = np.sqrt(acp_prev) * beta_t / (f32(1) - acp_t)
    coef_xt = np.sqrt(acp_t / acp_prev) * (f32(1) - acp_prev) / (f32(1) - acp_t)
    mean = float(coef_x0) * x0 + float(coef_xt) * x
    if noise is not None and t > 0:
        var = max((f32(1) - acp_prev) / (f32(1) - acp_t) * beta_t, f32(1e-20))
        mean = mean + float(np.sqrt(var)) * noise.float()
    return mean
