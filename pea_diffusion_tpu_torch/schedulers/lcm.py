"""LCM scheduler for few-step sampling with LCM-LoRA (port of
``pea_diffusion_tpu/schedulers/lcm.py``).

Consistency-model boundary conditions (Luo et al. 2023, arXiv:2311.05556):
denoised = c_out(t) * x0(t) + c_skip(t) * x_t; between steps the denoised
estimate is re-noised to the next (coarser -> finer) timestep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import NoiseScheduleConfig, make_alphas_cumprod, predict_x0


class LCMSchedule(NamedTuple):
    timesteps: np.ndarray    # [S]
    alpha_t: np.ndarray      # [S] float32
    sigma_t: np.ndarray      # [S]
    alpha_next: np.ndarray   # [S]; last entry unused
    sigma_next: np.ndarray
    c_skip: np.ndarray       # [S]
    c_out: np.ndarray        # [S]
    init_noise_sigma: float
    num_steps: int
    prediction_type: str = "epsilon"


def make_schedule(cfg: NoiseScheduleConfig, num_steps: int,
                  original_inference_steps: int = 50, timestep_scaling: float = 10.0,
                  sigma_data: float = 0.5) -> LCMSchedule:
    acp = make_alphas_cumprod(cfg)
    k = cfg.num_train_timesteps // original_inference_steps
    origin = np.arange(1, original_inference_steps + 1) * k - 1  # ascending
    # diffusers LCMScheduler.set_timesteps picks by endpoint-free linspace
    # indices, not a fixed stride: they differ whenever
    # original_inference_steps is not a multiple of num_steps
    idx = np.floor(np.linspace(0, len(origin), num_steps, endpoint=False)).astype(int)
    ts = origin[::-1][idx]
    a = np.sqrt(acp[ts])
    s = np.sqrt(1 - acp[ts])
    scaled = timestep_scaling * ts
    f32 = np.float32
    return LCMSchedule(
        timesteps=ts,
        alpha_t=a.astype(f32), sigma_t=s.astype(f32),
        alpha_next=np.concatenate([a[1:], [1.0]]).astype(f32),
        sigma_next=np.concatenate([s[1:], [0.0]]).astype(f32),
        c_skip=(sigma_data**2 / (scaled**2 + sigma_data**2)).astype(f32),
        c_out=(scaled / np.sqrt(scaled**2 + sigma_data**2)).astype(f32),
        init_noise_sigma=1.0, num_steps=len(ts), prediction_type=cfg.prediction_type)


def scale_model_input(sched: LCMSchedule, i: int, sample: torch.Tensor) -> torch.Tensor:
    return sample


def step(sched: LCMSchedule, i: int, sample: torch.Tensor, model_output: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The denoised estimate at the last step, else the estimate re-noised
    to the next timestep with `noise` (the step's draw, in the sample's
    type; without one, the deterministic part: the JAX step's rng=None).
    Computed in float32, the type the JAX step promotes to from its float32
    tables, and returned in it."""
    x = sample.float()
    x0 = predict_x0(sched.prediction_type, x, model_output.float(),
                    float(sched.alpha_t[i]), float(sched.sigma_t[i]))
    denoised = float(sched.c_out[i]) * x0 + float(sched.c_skip[i]) * x
    if i == sched.num_steps - 1:
        return denoised
    out = float(sched.alpha_next[i]) * denoised
    if noise is not None:
        out = out + float(sched.sigma_next[i]) * noise.float()
    return out
