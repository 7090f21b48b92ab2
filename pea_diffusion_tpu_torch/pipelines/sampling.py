"""Unified sampler interface (port of ``pea_diffusion_tpu/pipelines/sampling.py``):

    state0 = sampler.init()
    x_in   = sampler.scale(i, x)
    x, st  = sampler.step(i, x, model_output, st)

so one denoise loop serves every sampler.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..schedulers import NoiseScheduleConfig, ddim, dpm_solver


class Sampler(NamedTuple):
    name: str
    num_steps: int
    timesteps: np.ndarray
    init_noise_sigma: float
    init: Callable[[], Any]
    scale: Callable[..., torch.Tensor]
    step: Callable[..., tuple]


def make_sampler(name: str, cfg: NoiseScheduleConfig, num_steps: int) -> Sampler:
    if name == "ddim":
        sched = ddim.make_schedule(cfg, num_steps)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: x,
            step=lambda i, x, out, st: (ddim.step(sched, i, x, out), st),
        )
    if name in ("dpm++", "dpmsolver++", "dpm"):
        sched = dpm_solver.make_schedule(cfg, num_steps)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: x,
            step=lambda i, x, out, st: dpm_solver.step(sched, i, x, out, st),
        )
    if name in ("euler", "euler_a", "euler_ancestral", "lcm"):
        raise NotImplementedError(
            f"sampler {name!r} is not ported yet (ROADMAP Queue A item 15)")
    raise ValueError(f"unknown sampler {name}")


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale):
    """CFG overexposure fix (Lin et al. 2023); population std over all but
    the batch axis, as ``jnp.std``."""
    axes = tuple(range(1, noise_cfg.ndim))
    std_text = torch.std(noise_pred_text, dim=axes, keepdim=True, correction=0)
    std_cfg = torch.std(noise_cfg, dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
