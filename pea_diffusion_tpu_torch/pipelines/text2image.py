"""PEA text-to-image for SDXL (port of ``pea_diffusion_tpu/pipelines/text2image.py``).

Prompt ids go through the text tower and the PEA adapter (the negative prompt
too), the UNet runs the CFG pair as one batch ([uncond; cond]) under the
sampler with `cfg_combine` after each step, and the VAE decodes the latents
to NHWC images in [0, 1]. Generation runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models.adapter import PEAAdapter
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..schedulers import NoiseScheduleConfig
from .sampling import Sampler, make_sampler, rescale_noise_cfg


@dataclasses.dataclass
class PEAModels:
    """The modules of one PEA deployment, their weights inside them."""

    text_encoder: nn.Module
    # ids [B, T] -> token hidden states [B, T, D]
    text_encoder_fn: Callable[[torch.Tensor], torch.Tensor]
    adapter: PEAAdapter
    unet: UNet2DCondition
    vae: AutoencoderKL
    schedule: NoiseScheduleConfig
    vae_scaling: float
    device: torch.device


def denoise_loop(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 sampler: Sampler, noise: torch.Tensor, start: int = 0,
                 end: Optional[int] = None,
                 init_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampling loop over steps [start, end). eps_fn(x, i) -> the
    CFG-combined model output for latent x at step i."""
    x = noise * sampler.init_noise_sigma if init_latents is None else init_latents
    state = sampler.init()
    end = sampler.num_steps if end is None else end
    for i in range(start, end):
        out = eps_fn(sampler.scale(i, x), i)
        x, state = sampler.step(i, x, out, state)
    return x


def _per_sample(g, ndim: int, device) -> torch.Tensor:
    """A scalar passes through; a [B] vector broadcasts over each sample."""
    g = torch.as_tensor(g, dtype=torch.float32, device=device)
    if g.ndim == 0:
        return g
    return g.reshape(g.shape + (1,) * (ndim - 1))


def cfg_combine(eps_pair: torch.Tensor, guidance_scale, guidance_rescale=None):
    """eps_pair: [2B, ...] with [uncond; cond] halves. `guidance_scale` and
    `guidance_rescale` are scalars or [B] vectors (one per request). The
    scale is clamped to >= 1, so a row with guidance <= 1 gets exactly
    eps_cond, as it would without CFG; rescale 0 leaves the output as it is."""
    eps_u, eps_t = eps_pair.chunk(2, dim=0)
    scale = torch.clamp(_per_sample(guidance_scale, eps_u.ndim, eps_u.device), min=1.0)
    eps = eps_u + scale * (eps_t - eps_u)
    if guidance_rescale is not None:
        eps = rescale_noise_cfg(
            eps, eps_t, _per_sample(guidance_rescale, eps_u.ndim, eps_u.device))
    return eps


def decode_latents(models: PEAModels, latents: torch.Tensor,
                   chunk: int = 0) -> torch.Tensor:
    """VAE decode -> NHWC images in [0, 1]. `chunk` > 0 decodes `chunk` rows
    at a time; a ragged tail is padded with the last row and cut after, so
    every decode sees a batch of `chunk` rows."""
    b = latents.shape[0]
    if 0 < chunk < b:
        nchunks = -(-b // chunk)
        pad = nchunks * chunk - b
        z = latents
        if pad:
            z = torch.cat([z, z[-1:].expand(pad, *z.shape[1:])], dim=0)
        imgs = [decode_latents(models, zc) for zc in z.split(chunk)]
        return torch.cat(imgs, dim=0)[:b]
    z = latents.float() / models.vae_scaling
    img = models.vae.decode(z)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


def to_pil(images: torch.Tensor):
    """[B, H, W, 3] floats in [0, 1] -> list of PIL images."""
    from PIL import Image

    arr = (images.float().cpu().numpy() * 255).round().astype(np.uint8)
    return [Image.fromarray(a) for a in arr]


def make_add_time_ids(original_size, crops_coords_top_left, target_size,
                      batch: int, device=None) -> torch.Tensor:
    """SDXL micro-conditioning [B, 6]."""
    ids = torch.tensor(list(original_size) + list(crops_coords_top_left)
                       + list(target_size), dtype=torch.float32, device=device)
    return ids[None].repeat(batch, 1)


def encode_prompt_sdxl(models: PEAModels, ids: torch.Tensor,
                       uncond_ids: torch.Tensor):
    """Adapter-projected (context [2B, T, 2048], pooled [2B, 1280]),
    CFG-stacked [uncond; cond]. The negative prompt also goes through the
    adapter: the PEA plug-in replaces the whole prompt-encoding stage."""
    hs = models.text_encoder_fn(ids)
    hs_u = models.text_encoder_fn(uncond_ids)
    pooled, seq = models.adapter(hs)
    pooled_u, seq_u = models.adapter(hs_u)
    return torch.cat([seq_u, seq], dim=0), torch.cat([pooled_u, pooled], dim=0)


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)


def generate_sdxl(models: PEAModels, ids, uncond_ids, *,
                  generator: Optional[torch.Generator] = None,
                  sampler_name: str = "dpm++", height: int = 1024,
                  width: int = 1024, num_steps: int = 30,
                  guidance_scale=7.5, guidance_rescale=0.0,
                  original_size=None, crops_coords_top_left=(0, 0),
                  target_size=None, do_cfg: Optional[bool] = None,
                  init_noise=None) -> torch.Tensor:
    """ids, uncond_ids [B, T] -> images [B, height, width, 3] in [0, 1].

    `guidance_scale` / `guidance_rescale` may be [B] vectors (one per
    request). `do_cfg` defaults to "some guidance > 1"; without CFG only the
    conditional half runs. `init_noise` [B, H/8, W/8, 4] replaces the
    initial latents drawn from `generator`."""
    device = models.device
    if do_cfg is None:
        do_cfg = bool(np.max(np.asarray(guidance_scale)) > 1.0)
    with torch.inference_mode():
        ids, uncond_ids = _ids(ids, device), _ids(uncond_ids, device)
        context, pooled = encode_prompt_sdxl(models, ids, uncond_ids)
        b = ids.shape[0]
        if not do_cfg:
            context, pooled = context[b:], pooled[b:]
        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        if init_noise is None:
            noise = torch.randn((b, height // 8, width // 8, 4),
                                generator=generator, dtype=torch.float32,
                                device=device)
        else:
            noise = torch.as_tensor(init_noise, dtype=torch.float32, device=device)
        mult = 2 if do_cfg else 1
        time_ids = make_add_time_ids(
            original_size or (height, width), crops_coords_top_left,
            target_size or (height, width), mult * b, device)
        added = {"text_embeds": pooled, "time_ids": time_ids}
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
        gr = torch.as_tensor(guidance_rescale, dtype=torch.float32, device=device)

        def eps_fn(x, i):
            x_in = torch.cat([x] * mult, dim=0)
            t = torch.full((mult * b,), int(sampler.timesteps[i]),
                           dtype=torch.long, device=device)
            out = models.unet(x_in, t, context, added).float()
            return cfg_combine(out, gs, gr) if do_cfg else out

        latents = denoise_loop(eps_fn, sampler, noise)
        return decode_latents(models, latents)


class StableDiffusionXLPEAPipeline:
    """SDXL + PEA adapter (pooled 1280 + seq 2048). Calling it returns the
    images as a [B, H, W, 3] tensor in [0, 1]; `to_pil` turns them into
    PIL images."""

    def __init__(self, models: PEAModels, sampler_name: str = "dpm++"):
        self.models, self.sampler_name = models, sampler_name

    def __call__(self, ids, uncond_ids, *, height=1024, width=1024,
                 num_steps=30, guidance_scale=7.5, guidance_rescale=0.0,
                 seed=0, init_noise=None) -> torch.Tensor:
        gen = torch.Generator(device=self.models.device).manual_seed(seed)
        return generate_sdxl(
            self.models, ids, uncond_ids, generator=gen,
            sampler_name=self.sampler_name, height=height, width=width,
            num_steps=num_steps, guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, init_noise=init_noise)
