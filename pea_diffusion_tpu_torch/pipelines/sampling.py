"""Unified sampler interface (port of ``pea_diffusion_tpu/pipelines/sampling.py``):

    state0 = sampler.init()
    x_in   = sampler.scale(i, x)
    noise  = sampler.draw(x, generator)      # None for deterministic samplers
    x, st  = sampler.step(i, x, model_output, st, noise)

so one denoise loop serves every sampler. The JAX step takes a key per step
(`rng`); here a step takes its draw, made by `draw` from the request's
``torch.Generator`` in step order or passed in (the parity tests pass the
JAX draws). A step without a draw returns its deterministic part, as the
JAX step with rng=None.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..schedulers import NoiseScheduleConfig, ddim, dpm_solver, euler, lcm


class Sampler(NamedTuple):
    name: str
    num_steps: int
    timesteps: np.ndarray
    init_noise_sigma: float
    init: Callable[[], Any]
    scale: Callable[..., torch.Tensor]
    step: Callable[..., tuple]
    draw: Callable[..., Any] = lambda x, generator: None


def _randn(dtype=None):
    """The draw of a stochastic step: N(0, 1) of the latent's shape, in
    `dtype` (None: the latent's)."""
    return lambda x, generator: torch.randn(x.shape, generator=generator, device=x.device,
                                            dtype=dtype or x.dtype)


def make_sampler(name: str, cfg: NoiseScheduleConfig, num_steps: int, **kw) -> Sampler:
    """`kw` goes to the schedule of dpm++ and lcm (lcm:
    original_inference_steps, timestep_scaling, sigma_data)."""
    if name == "ddim":
        sched = ddim.make_schedule(cfg, num_steps)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: x,
            step=lambda i, x, out, st, noise=None: (ddim.step(sched, i, x, out), st),
        )
    if name in ("dpm++", "dpmsolver++", "dpm"):
        sched = dpm_solver.make_schedule(cfg, num_steps, **kw)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: x,
            step=lambda i, x, out, st, noise=None: dpm_solver.step(sched, i, x, out, st),
        )
    if name == "euler":
        sched = euler.make_schedule(cfg, num_steps)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: euler.scale_model_input(sched, i, x),
            step=lambda i, x, out, st, noise=None: (euler.step(sched, i, x, out), st),
        )
    if name in ("euler_a", "euler_ancestral"):
        # SDXL-Turbo's scheduler (trailing spacing and guidance 0 at the
        # pipeline level); the JAX step draws its noise in float32
        sched = euler.make_schedule(cfg, num_steps)
        return Sampler(
            name, num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: euler.scale_model_input(sched, i, x),
            step=lambda i, x, out, st, noise=None: (
                euler.step_ancestral(sched, i, x, out, noise), st),
            draw=_randn(torch.float32),
        )
    if name == "lcm":
        # the JAX step draws its noise in the sample's type
        sched = lcm.make_schedule(cfg, num_steps, **kw)
        return Sampler(
            name, sched.num_steps, sched.timesteps, sched.init_noise_sigma,
            init=lambda: None,
            scale=lambda i, x: x,
            step=lambda i, x, out, st, noise=None: (lcm.step(sched, i, x, out, noise), st),
            draw=_randn(),
        )
    raise ValueError(f"unknown sampler {name}")


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale):
    """CFG overexposure fix (Lin et al. 2023); population std over all but
    the batch axis, as ``jnp.std``."""
    axes = tuple(range(1, noise_cfg.ndim))
    std_text = torch.std(noise_pred_text, dim=axes, keepdim=True, correction=0)
    std_cfg = torch.std(noise_cfg, dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
