"""Euler discrete sampler and its ancestral variant (port of
``pea_diffusion_tpu/schedulers/euler.py``). EulerAncestralDiscrete with
trailing timesteps and no CFG is SDXL-Turbo's operating point.

Both steps compute in float32 and cast back to the sample's type. The
schedule's scalars are float32 and combine in float32 as the JAX step's
traced scalars do (numpy float32 arithmetic here)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import NoiseScheduleConfig, inference_timesteps, make_alphas_cumprod

f32 = np.float32


class EulerSchedule(NamedTuple):
    timesteps: np.ndarray  # [S]
    sigmas: np.ndarray     # [S+1] float32, last entry 0
    init_noise_sigma: float
    num_steps: int
    prediction_type: str = "epsilon"


def make_schedule(cfg: NoiseScheduleConfig, num_steps: int) -> EulerSchedule:
    acp = make_alphas_cumprod(cfg)
    ts = inference_timesteps(cfg, num_steps)
    sig = np.sqrt((1 - acp[ts]) / acp[ts])
    sigmas = np.concatenate([sig, [0.0]])
    # diffusers: the largest sigma for linspace/trailing spacing, else
    # sqrt(max^2 + 1)
    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_sigma = float(sigmas.max())
    else:
        init_sigma = float(np.sqrt(sigmas.max() ** 2 + 1))
    return EulerSchedule(timesteps=ts, sigmas=sigmas.astype(f32),
                         init_noise_sigma=init_sigma, num_steps=num_steps,
                         prediction_type=cfg.prediction_type)


def scale_model_input(sched: EulerSchedule, i: int, sample: torch.Tensor) -> torch.Tensor:
    """sample / sqrt(sigma^2 + 1), the divisor rounded to the sample's type."""
    sigma = sched.sigmas[i]
    c = torch.tensor(float(np.sqrt(sigma * sigma + f32(1))), dtype=sample.dtype,
                     device=sample.device)
    return sample / c


def _x0(sched: EulerSchedule, sigma, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    if sched.prediction_type == "epsilon":
        return x - float(sigma) * eps
    if sched.prediction_type == "v_prediction":
        c = sigma * sigma + f32(1)
        return x / float(c) - eps * float(sigma) / float(np.sqrt(c))
    raise ValueError(sched.prediction_type)


def step(sched: EulerSchedule, i: int, sample: torch.Tensor,
         model_output: torch.Tensor) -> torch.Tensor:
    sigma = sched.sigmas[i]
    x, eps = sample.float(), model_output.float()
    d = (x - _x0(sched, sigma, x, eps)) / float(sigma)
    return (x + d * float(sched.sigmas[i + 1] - sigma)).to(sample.dtype)


def ancestral_sigmas(sched: EulerSchedule, i: int):
    """diffusers EulerAncestralDiscreteScheduler.step's (sigma_down,
    sigma_up) split of the sigma_from -> sigma_to move: the deterministic
    Euler step goes to sigma_down, fresh noise restores the marginal to
    sigma_to. sigma_to = 0 at the final step makes both 0."""
    s_from, s_to = sched.sigmas[i], sched.sigmas[i + 1]
    up2 = s_to * s_to * (s_from * s_from - s_to * s_to) / max(s_from * s_from, f32(1e-20))
    sigma_up = np.sqrt(max(up2, f32(0)))
    sigma_down = np.sqrt(max(s_to * s_to - up2, f32(0)))
    return sigma_down, sigma_up


def step_ancestral(sched: EulerSchedule, i: int, sample: torch.Tensor,
                   model_output: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euler-ancestral step; `noise` is the step's draw (float32, the type
    the JAX step draws in). Without a draw it returns the deterministic part
    (the JAX step's rng=None)."""
    sigma = sched.sigmas[i]
    x, eps = sample.float(), model_output.float()
    sigma_down, sigma_up = ancestral_sigmas(sched, i)
    d = (x - _x0(sched, sigma, x, eps)) / float(sigma)
    out = x + d * float(sigma_down - sigma)
    if noise is not None:
        out = out + float(sigma_up) * noise.float()
    return out.to(sample.dtype)
