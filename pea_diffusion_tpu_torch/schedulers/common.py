"""Shared diffusion-schedule math (the port's counterpart of the JAX package's
``schedulers/common.py``).

Schedules are numpy tables built once per (config, num_steps); samplers index
them with the Python loop counter. Coefficients are float32, as in the JAX
package, and enter the tensor math as Python floats holding those float32
values, so each update rounds as the JAX one does.

Noise schedule constants reproduce the reference training scheduler
(DDPMScheduler(beta_start=0.00085, beta_end=0.012, beta_schedule=
"scaled_linear", num_train_timesteps=1000)).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # scaled_linear | linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    timestep_spacing: str = "leading"  # leading | linspace | trailing
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    rescale_betas_zero_snr: bool = False


def make_alphas_cumprod(cfg: NoiseScheduleConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, T) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, T)
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(T + 1) / T
        f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(cfg.beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    if cfg.rescale_betas_zero_snr:
        # Lin et al. 2023: shift sqrt(acp) so last-step SNR == 0
        s = np.sqrt(alphas_cumprod)
        s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
        alphas_cumprod = s**2
    return alphas_cumprod.astype(np.float64)


def inference_timesteps(cfg: NoiseScheduleConfig, num_steps: int) -> np.ndarray:
    """Descending training-timestep indices for a sampling run."""
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps).round()[::-1]
    elif cfg.timestep_spacing == "leading":
        step = T // num_steps
        ts = (np.arange(num_steps) * step).round()[::-1] + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ts = np.arange(T, 0, -T / num_steps).round() - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts.astype(np.int64)


def predict_x0(prediction_type: str, sample: torch.Tensor,
               model_output: torch.Tensor, alpha_t: float,
               sigma_t: float) -> torch.Tensor:
    """x0 estimate from a model output, where alpha_t=sqrt(acp), sigma_t=sqrt(1-acp)."""
    if prediction_type == "epsilon":
        return (sample - sigma_t * model_output) / alpha_t
    if prediction_type == "v_prediction":
        return alpha_t * sample - sigma_t * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(prediction_type)


def predict_eps(prediction_type: str, sample: torch.Tensor,
                model_output: torch.Tensor, alpha_t: float,
                sigma_t: float) -> torch.Tensor:
    """The noise estimate from a model output (alpha_t, sigma_t as in
    `predict_x0`)."""
    if prediction_type == "epsilon":
        return model_output
    if prediction_type == "v_prediction":
        return alpha_t * model_output + sigma_t * sample
    if prediction_type == "sample":
        return (sample - alpha_t * model_output) / sigma_t
    raise ValueError(prediction_type)


def _acp_coefficients(alphas_cumprod, sample, timesteps):
    """sqrt(acp) and sqrt(1 - acp) at `timesteps` in the sample's type,
    shaped to broadcast over each sample."""
    acp = alphas_cumprod.to(sample.device)[timesteps].to(sample.dtype)
    shape = (-1,) + (1,) * (sample.ndim - 1)
    return torch.sqrt(acp).reshape(shape), torch.sqrt(1.0 - acp).reshape(shape)


def add_noise(alphas_cumprod: torch.Tensor, sample: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0), the forward diffusion (DDPMScheduler.add_noise parity):
    the schedule's fp32 alphas_cumprod at `timesteps`, cast to the sample's
    type, then sqrt(acp) * sample + sqrt(1 - acp) * noise in that type."""
    a, s = _acp_coefficients(alphas_cumprod, sample, timesteps)
    return a * sample + s * noise


def get_velocity(alphas_cumprod: torch.Tensor, sample: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """The v-prediction target sqrt(acp) * noise - sqrt(1 - acp) * sample,
    in the sample's type as `add_noise`."""
    a, s = _acp_coefficients(alphas_cumprod, sample, timesteps)
    return a * noise - s * sample
