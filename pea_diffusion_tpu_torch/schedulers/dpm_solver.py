"""DPM-Solver++ (2M, multistep): data-prediction parametrization, midpoint
2nd-order multistep, first order at the first and the final step (Lu et al.
2022, arXiv:2211.01095). The port's counterpart of the JAX package's
``schedulers/dpm_solver.py``; the running state is the previous x0."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import NoiseScheduleConfig, inference_timesteps, make_alphas_cumprod, predict_x0


class DPMSchedule(NamedTuple):
    timesteps: np.ndarray   # [S]
    alpha_s: np.ndarray     # [S] float32 sqrt(acp) at current step s0
    sigma_s: np.ndarray     # [S]
    alpha_next: np.ndarray  # [S] target (t) values for the update out of step i
    sigma_next: np.ndarray
    h: np.ndarray           # [S] lambda_t - lambda_s0
    r0: np.ndarray          # [S] h_prev / h (2nd-order ratio; unused at i=0)
    use_second: np.ndarray  # [S] bool: apply the 2nd-order update at step i
    init_noise_sigma: float
    num_steps: int
    prediction_type: str = "epsilon"


def make_schedule(cfg: NoiseScheduleConfig, num_steps: int) -> DPMSchedule:
    acp = make_alphas_cumprod(cfg)
    ts = inference_timesteps(cfg, num_steps)
    a = np.sqrt(acp[ts])
    s = np.sqrt(1 - acp[ts])
    lam = np.log(a / s)
    # step i targets timestep i+1; the last step targets the clean sample
    # (sigma -> 0, alpha -> 1)
    a_next = np.concatenate([a[1:], [1.0]])
    s_next = np.concatenate([s[1:], [np.finfo(np.float64).tiny]])
    lam_next = np.log(a_next / s_next)
    h = lam_next - lam
    h_prev = np.concatenate([[1.0], h[:-1]])
    r0 = h_prev / h
    use_second = np.ones(num_steps, bool)
    use_second[0] = False
    # the final sigma is 0, so h -> inf there and the 2nd-order term
    # diverges: the last step is always first order (diffusers
    # final_sigmas_type="zero")
    use_second[-1] = False
    h = np.clip(h, -700, 700)
    f32 = np.float32
    return DPMSchedule(
        timesteps=ts,
        alpha_s=a.astype(f32), sigma_s=s.astype(f32),
        alpha_next=a_next.astype(f32), sigma_next=s_next.astype(f32),
        h=h.astype(f32), r0=r0.astype(f32), use_second=use_second,
        init_noise_sigma=1.0, num_steps=num_steps,
        prediction_type=cfg.prediction_type,
    )


def step(sched: DPMSchedule, i: int, sample: torch.Tensor,
         model_output: torch.Tensor, prev_x0: Optional[torch.Tensor]):
    """One DPM-Solver++(2M) update; returns (prev_sample, x0) where x0 is the
    state the next step takes as `prev_x0`."""
    a_s, s_s = sched.alpha_s[i], sched.sigma_s[i]
    a_t, s_t = sched.alpha_next[i], sched.sigma_next[i]
    x0 = predict_x0(sched.prediction_type, sample, model_output,
                    float(a_s), float(s_s)).float()
    sample32 = sample.float()
    emh1 = np.expm1(-sched.h[i])  # exp(-h) - 1, float32
    ratio = float(s_t / s_s)
    first = ratio * sample32 - float(a_t * emh1) * x0
    if sched.use_second[i]:
        d1 = (x0 - prev_x0) / float(sched.r0[i])
        out = first - float(np.float32(0.5) * a_t * emh1) * d1
    else:
        out = first
    return out.to(sample.dtype), x0
