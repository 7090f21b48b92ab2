"""Plain reference of the sampling and training arithmetic: the noise
schedule, DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095; data
prediction, first order at the first and the last step, the last step to
sigma 0), classifier-free guidance with a per-row scale, the forward
diffusion, the PEA KD loss (reference train_sdxl_zh.py / train_sd_zh.py:
denoise MSE on Chinese-native rows, output and feature distillation from
the English teacher on parallel rows, CFG dropout, offset noise) and
AdamW after clipping the global norm at 1. fp64 schedule tables, fp32
tensors. Imports only numpy and torch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def alphas_cumprod(s: Dict) -> np.ndarray:
    assert s["beta_schedule"] == "scaled_linear", s["beta_schedule"]
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                        s["num_train_timesteps"]) ** 2
    return np.cumprod(1.0 - betas)


def timesteps(s: Dict, steps: int) -> np.ndarray:
    assert s["timestep_spacing"] == "leading", s["timestep_spacing"]
    stride = s["num_train_timesteps"] // steps
    return (np.arange(steps) * stride)[::-1] + s["steps_offset"]


class DPMSolver:
    """DPM-Solver++(2M): x_{i+1} = (s_{i+1}/s_i) x_i - a_{i+1} (e^{-h} - 1) D_i,
    D_i = x0_i + (x0_i - x0_{i-1}) / (2 r) at second order."""

    def __init__(self, s: Dict, steps: int):
        acp = alphas_cumprod(s)
        self.t = timesteps(s, steps)
        a = np.sqrt(acp[self.t])
        sg = np.sqrt(1 - acp[self.t])
        self.a, self.s = a, sg
        self.a_next = np.append(a[1:], 1.0)
        self.s_next = np.append(sg[1:], 0.0)
        lam = np.log(a / sg)
        with np.errstate(divide="ignore"):
            lam_next = np.log(self.a_next / self.s_next)
        self.h = lam_next - lam
        self.steps = steps

    def x0(self, i: int, x, eps):
        return (x - float(self.s[i]) * eps) / float(self.a[i])

    def step(self, i: int, x, eps, prev_x0: Optional[torch.Tensor]):
        x0 = self.x0(i, x, eps)
        last = i == self.steps - 1
        if last:  # sigma -> 0: the update is the data prediction
            return x0
        emh1 = float(np.expm1(-self.h[i]))
        out = float(self.s_next[i] / self.s[i]) * x - float(self.a_next[i] * emh1) * x0
        if i > 0:
            r = float(self.h[i - 1] / self.h[i])
            out = out - 0.5 * float(self.a_next[i] * emh1) * (x0 - prev_x0) / r
        return out


def cfg_combine(eps_uncond, eps_cond, scale):
    """Per-row guidance `scale` [B], clamped to >= 1."""
    g = torch.clamp(torch.as_tensor(scale, dtype=torch.float32, device=eps_cond.device),
                    min=1.0).reshape(-1, *([1] * (eps_cond.ndim - 1)))
    return eps_uncond + g * (eps_cond - eps_uncond)


def add_noise(acp: np.ndarray, x0, noise, t):
    a = torch.as_tensor(np.sqrt(acp), dtype=torch.float32, device=x0.device)[t]
    s = torch.as_tensor(np.sqrt(1 - acp), dtype=torch.float32, device=x0.device)[t]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return a.reshape(shape) * x0 + s.reshape(shape) * noise


def kd_draws(seed: int, rows: int, latent_hw, device) -> Dict[str, torch.Tensor]:
    """A step's random draws in the program's order from its generator
    (``torch.Generator(device).manual_seed(seed)``): VAE eps, noise, offset
    noise, timesteps in [0, 1000), CFG-drop uniforms."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = latent_hw
    return {
        "vae_eps": torch.randn((rows, h, w, 4), generator=g, device=device),
        "noise": torch.randn((rows, h, w, 4), generator=g, device=device),
        "offset_noise": torch.randn((rows, 1, 1, 4), generator=g, device=device),
        "timesteps": torch.randint(0, 1000, (rows,), generator=g, device=device),
        "cfg_uniform": torch.rand((rows, 1, 1), generator=g, device=device),
    }


def _mse(a, b, w):
    """Per-row mean of (a - b)^2, non-finite rows dropped, times w [rows]:
    the summands of the batch mean."""
    per = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
    return torch.where(torch.isfinite(per), per, torch.zeros_like(per)) * w


def kd_loss_rows(m: Dict, hp: Dict, batch: Dict, draws: Dict, acp: np.ndarray,
                 rows: slice, batch_rows: int):
    """The KD loss's share of `rows` (its summands over the batch's
    `batch_rows`), differentiable in m["adapter"]; and the three terms.
    `m`: reference modules vae, text_encoder, adapter, unet, teacher_1
    (and teacher_2 for SDXL), all in one floating type, which the batch's
    and the draws' floating tensors are cast to."""
    dt = next(m["unet"].parameters()).dtype

    def cast(v):
        return v[rows].to(dt) if v.is_floating_point() else v[rows]

    b = {k: cast(v) for k, v in batch.items()}
    d = {k: cast(v) for k, v in draws.items()}
    sdxl = "teacher_2" in m
    with torch.no_grad():
        lat = m["vae"].encode(b["pixel_values"], d["vae_eps"]) * hp["vae_scaling"]
        noise = d["noise"] + hp["noise_offset"] * d["offset_noise"]
        noisy = add_noise(acp, lat, noise, d["timesteps"]).to(dt)
        hs = m["text_encoder"](b["input_ids"])
        hs_u = m["text_encoder"](b["input_ids_uncond"])
    drop = d["cfg_uniform"] < hp["cfg_dropout"]
    if sdxl:
        pooled, seq = m["adapter"](hs)
        _, seq_u = m["adapter"](hs_u)
        added = {"text_embeds": pooled, "time_ids": b["time_ids"]}
    else:
        seq, seq_u, added = m["adapter"](hs), m["adapter"](hs_u), None
    seq = torch.where(drop, seq_u, seq)
    pred, feats = m["unet"](noisy, d["timesteps"], seq, added, features=True)
    with torch.no_grad():
        if sdxl:
            _, p1, _ = m["teacher_1"](b["teacher_ids_1"])
            _, p2, pr = m["teacher_2"](b["teacher_ids_2"])
            _, u1, _ = m["teacher_1"](b["teacher_uncond_ids_1"])
            _, u2, _ = m["teacher_2"](b["teacher_uncond_ids_2"])
            t_seq, tu_seq = torch.cat([p1, p2], -1), torch.cat([u1, u2], -1)
            t_added = {"text_embeds": pr, "time_ids": b["time_ids"]}
        else:
            t_seq = m["teacher_1"](b["teacher_ids_1"])[0]
            tu_seq = m["teacher_1"](b["teacher_uncond_ids_1"])[0]
            t_added = None
        t_seq = torch.where(drop, tu_seq, t_seq)
        t_pred, t_feats = m["unet"](noisy, d["timesteps"], t_seq, t_added, features=True)
    zh = b["zh_or_not"].float()
    denoise = _mse(pred, noise, zh).sum() / batch_rows
    teacher = _mse(pred, t_pred, 1 - zh).sum() / batch_rows
    feat = sum(_mse(feats[k], t_feats[k], 1 - zh).sum() for k in sorted(feats)) / batch_rows
    loss = denoise + teacher + hp["feature_loss_weight"] * feat
    return loss, (denoise.detach(), teacher.detach(), feat.detach())


def decay_mask(names: List[str], shapes: Dict[str, tuple]) -> Dict[str, bool]:
    """Weight decay on matrices that are not biases and not in a norm."""
    return {n: not (n.endswith("bias") or "norm" in n.rsplit(".", 1)[0].lower()
                    or len(shapes[n]) < 2) for n in names}


class AdamW:
    """clip_by_global_norm(1.0) then AdamW (bias-corrected moments, decay
    on the masked leaves). `dtype` is the moments' type."""

    def __init__(self, params: Dict[str, torch.Tensor], hp: Dict, dtype=torch.float32):
        self.hp, self.count = hp, 0
        self.mu = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        self.mask = decay_mask(list(params), {k: tuple(p.shape) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        hp = self.hp
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if norm >= 1.0:
            grads = {k: g / norm for k, g in grads.items()}
        b1, b2 = hp["adam_beta1"], hp["adam_beta2"]
        c1, c2 = 1 - b1 ** (self.count + 1), 1 - b2 ** (self.count + 1)
        for k, p in params.items():
            g = grads[k].to(self.mu[k].dtype)
            self.mu[k].mul_(b1).add_((1 - b1) * g)
            self.nu[k].mul_(b2).add_((1 - b2) * g * g)
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + hp["adam_epsilon"])
            if self.mask[k]:
                upd = upd + hp["weight_decay"] * p
            p.add_((-self.lr() * upd).to(p.dtype))
        self.count += 1
        return norm

    def lr(self) -> float:
        """Polynomial (linear) decay from the learning rate to the minimum
        over the run's total steps, no warm-up."""
        hp = self.hp
        done = min(self.count, hp["total_steps"]) / hp["total_steps"]
        return (hp["learning_rate"] - hp["min_learning_rate"]) * (1 - done) \
            + hp["min_learning_rate"]
