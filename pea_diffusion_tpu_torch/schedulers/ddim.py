"""DDIM sampler (deterministic, eta=0)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .common import NoiseScheduleConfig, inference_timesteps, make_alphas_cumprod, predict_x0


class DDIMSchedule(NamedTuple):
    timesteps: np.ndarray      # [S] descending train-timestep indices
    alpha_t: np.ndarray        # [S] float32 sqrt(acp) at each step
    sigma_t: np.ndarray        # [S] float32 sqrt(1-acp)
    alpha_prev: np.ndarray     # [S] float32 sqrt(acp) at the next (earlier-time) step
    sigma_prev: np.ndarray
    init_noise_sigma: float
    num_steps: int
    prediction_type: str = "epsilon"


def make_schedule(cfg: NoiseScheduleConfig, num_steps: int) -> DDIMSchedule:
    acp = make_alphas_cumprod(cfg)
    ts = inference_timesteps(cfg, num_steps)
    a = acp[ts]
    prev_ts = ts - cfg.num_train_timesteps // num_steps
    final = 1.0 if cfg.set_alpha_to_one else acp[0]
    a_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], final)
    return DDIMSchedule(
        timesteps=ts,
        alpha_t=np.sqrt(a).astype(np.float32),
        sigma_t=np.sqrt(1 - a).astype(np.float32),
        alpha_prev=np.sqrt(a_prev).astype(np.float32),
        sigma_prev=np.sqrt(1 - a_prev).astype(np.float32),
        init_noise_sigma=1.0,
        num_steps=num_steps,
        prediction_type=cfg.prediction_type,
    )


def step(sched: DDIMSchedule, i: int, sample: torch.Tensor,
         model_output: torch.Tensor) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev}."""
    a_t, s_t = float(sched.alpha_t[i]), float(sched.sigma_t[i])
    a_p, s_p = float(sched.alpha_prev[i]), float(sched.sigma_prev[i])
    x0 = predict_x0(sched.prediction_type, sample, model_output, a_t, s_t)
    eps = (sample - a_t * x0) / s_t
    return a_p * x0 + s_p * eps
