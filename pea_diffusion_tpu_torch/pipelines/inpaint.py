"""SDXL inpainting with PEA prompt encoding (port of
``pea_diffusion_tpu/pipelines/inpaint.py``).

Covers the mask's binarisation and its resize to the latents' size, the VAE
encode of the image and of the masked image, the strength -> start-step
window (or `denoising_start`, the refiner's hand-off), the 9-channel UNet
input cat([latents, mask, masked-image latents]) and, for a 4-channel UNet,
the blend after each step that keeps the unmasked region on the image's
noised trajectory. Generation runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..schedulers import ddpm
from .sampling import make_sampler
from .text2image import (PEAModels, as_ids, _initial_noise, cfg_combine, decode_latents,
                         encode_prompt_sdxl, encode_vae_image, make_add_time_ids,
                         timestep_cutoff)


def preprocess_mask(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8/float mask -> binarized [1,H,W,1] float (1 = repaint region)."""
    from PIL import Image
    arr = np.asarray(mask, np.float32)
    if arr.ndim == 3:
        arr = arr.mean(-1)
    if arr.max() > 1.5:
        arr = arr / 255.0
    pil = Image.fromarray((arr * 255).astype(np.uint8))
    arr = np.asarray(pil.resize((width, height), resample=2), np.float32) / 255.0
    return (arr > 0.5).astype(np.float32)[None, :, :, None]


def preprocess_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 RGB -> [1,H,W,3] in [-1,1]."""
    from PIL import Image
    pil = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    arr = np.asarray(pil.resize((width, height), resample=2), np.float32) / 255.0
    return (arr * 2 - 1)[None]


def strength_start(num_steps: int, strength) -> int:
    """The first step of a request at `strength`: int(num_steps * (1 -
    strength)) in float32, as the JAX package computes it on its float32
    strength (10 steps at 0.6 start at 3; float64 would give 4), at most
    num_steps - 1."""
    start = np.float32(num_steps) * (np.float32(1.0) - np.float32(strength))
    return min(int(start), num_steps - 1)


def denoising_start_index(timesteps: np.ndarray, schedule, denoising_start) -> int:
    """The first index whose timestep lies below the cutoff of
    `denoising_start` (`timestep_cutoff`); 0 when none does, so that the
    whole loop runs (the JAX package's argmax over an all-False mask)."""
    return int(np.argmax(timesteps < timestep_cutoff(schedule, denoising_start)))


def mask_to_latents(mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, 1] -> [B, height, width, 1], nearest at half-pixel centres
    (``jax.image.resize(..., "nearest")``: a 16 -> 2 resize picks rows 4 and
    12, not 0 and 8)."""
    m = F.interpolate(mask.permute(0, 3, 1, 2), size=(height, width), mode="nearest-exact")
    return m.permute(0, 2, 3, 1)


def generate_sdxl_inpaint(
        models: PEAModels, ids, uncond_ids, image, mask, *,
        generator: Optional[torch.Generator] = None, sampler_name: str = "ddim",
        height: int = 1024, width: int = 1024, num_steps: int = 30, guidance_scale=7.5,
        guidance_rescale=0.0, strength: float = 0.85, aesthetic_score=None,
        negative_aesthetic_score: float = 2.5, denoising_start: Optional[float] = None,
        init_noise=None, vae_eps=None) -> torch.Tensor:
    """ids, uncond_ids [B, T]; image [1|B, H, W, 3] in [-1, 1]; mask [1|B, H,
    W, 1] binarized (1 = repaint) -> images [B, H', W', 3] in [0, 1], with
    CFG. The loop runs from `strength_start` (pure noise times the sampler's
    initial sigma at strength >= 1, else the image's latents noised to that
    step's timestep), or, with `denoising_start`, from
    `denoising_start_index` on the image's latents as they are (the hand-off
    of a noised trajectory: no re-noising). A 9-channel UNet
    (in_channels == 9) takes cat([x, mask, masked-image latents]); a
    4-channel one gets its unmasked region reset after each step to the
    image's latents noised to the next timestep (the latents themselves
    after the last). With `aesthetic_score` the time ids take the refiner's
    [B, 5] form (the unconditional half with `negative_aesthetic_score`).

    Random draws, in the JAX package's order: `init_noise` [B, h, w, 4]
    (float32) and `vae_eps`, the pair of encoder draws (image, masked image)
    in the VAE's type; each one not given is drawn from `generator` in that
    order. As in the JAX package the loop itself gets no random source."""
    device = models.device
    with torch.inference_mode():
        ids, uncond_ids = as_ids(ids, device), as_ids(uncond_ids, device)
        context, pooled = encode_prompt_sdxl(models, ids, uncond_ids)
        b = ids.shape[0]
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        image = image.expand(b, *image.shape[1:])
        mask = mask.expand(b, *mask.shape[1:])
        vae_cfg = models.vae.config
        stride = 2 ** (len(vae_cfg.block_out_channels) - 1)
        lat_shape = (b, image.shape[1] // stride, image.shape[2] // stride,
                     vae_cfg.latent_channels)
        noise = _initial_noise(lat_shape, generator, init_noise, device)
        vae_dtype = models.vae.quant_conv.weight.dtype
        eps = [torch.randn(lat_shape, generator=generator, device=device, dtype=vae_dtype)
               if e is None else torch.as_tensor(e, device=device)
               for e in (vae_eps or (None, None))]

        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        start = strength_start(num_steps, strength)
        if denoising_start is not None:
            start = denoising_start_index(sampler.timesteps, models.schedule, denoising_start)

        image_latents = encode_vae_image(models, image, eps=eps[0])
        masked_latents = encode_vae_image(models, image * (mask < 0.5), eps=eps[1])
        mask_lat = mask_to_latents(mask, image_latents.shape[1], image_latents.shape[2])

        sched = ddpm.make_schedule(models.schedule)

        def timesteps_at(i):
            return torch.full((b,), int(sampler.timesteps[i]), dtype=torch.long, device=device)

        if np.float32(strength) >= 1.0:
            latents = noise * sampler.init_noise_sigma
        else:
            latents = ddpm.add_noise(sched, image_latents, noise, timesteps_at(start))
        if denoising_start is not None:
            latents = image_latents

        if aesthetic_score is not None:
            time_ids = torch.cat([
                make_add_time_ids((height, width), (0, 0), (height, width), b, device,
                                  aesthetic_score=score)
                for score in (negative_aesthetic_score, aesthetic_score)])
        else:
            time_ids = make_add_time_ids((height, width), (0, 0), (height, width), 2 * b,
                                         device)
        added = {"text_embeds": pooled, "time_ids": time_ids}
        nine_channels = models.unet.config.in_channels == 9
        mask2 = torch.cat([mask_lat, mask_lat], dim=0)
        masked2 = torch.cat([masked_latents, masked_latents], dim=0)
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
        gr = torch.as_tensor(guidance_rescale, dtype=torch.float32, device=device)

        x, state, last = latents, sampler.init(), sampler.num_steps - 1
        for i in range(start, sampler.num_steps):
            x_in = sampler.scale(i, x)
            x2 = torch.cat([x_in, x_in], dim=0)
            if nine_channels:
                x2 = torch.cat([x2, mask2, masked2.to(x2.dtype)], dim=-1)
            t = torch.full((2 * b,), int(sampler.timesteps[i]), dtype=torch.long,
                           device=device)
            out = models.unet(x2, t, context, added).float()
            x, state = sampler.step(i, x, cfg_combine(out, gs, gr), state, None)
            if not nine_channels:
                init_prop = (image_latents if i == last else
                             ddpm.add_noise(sched, image_latents, noise, timesteps_at(i + 1)))
                x = (1 - mask_lat) * init_prop + mask_lat * x
        return decode_latents(models, x)
