"""SDXL ControlNet text-to-image with PEA prompt encoding (port of
``pea_diffusion_tpu/pipelines/controlnet.py``).

Covers the control image's preprocessing, the per-step keep schedule
(control_guidance_start/end: the residuals' scale is multiplied by 1 inside
the window and 0 outside), guess mode (the ControlNet sees only the
conditional half; the unconditional half's residuals are zeros) and the
residuals' injection into the UNet. Generation runs under
``torch.inference_mode()``. `StableDiffusionXLControlNetPEAPipeline` is the
form the serving engine calls (``cli/serve.py``): one control map, guidance
and conditioning scale per request.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.controlnet import ControlNet
from ..utils.trace import span
from .sampling import make_sampler
from .text2image import (PEAModels, StableDiffusionXLPEAPipeline, as_ids, _initial_noise,
                         cfg_combine, decode_latents, denoise_loop, encode_prompt_sdxl,
                         make_add_time_ids)


def prepare_control_image(image: np.ndarray, height: int, width: int, batch: int,
                          device=None) -> torch.Tensor:
    """HWC (or HW) uint8 or [0, 1] float control map -> [B, H, W, 3] float32
    in [0, 1]. Quantised to uint8 as the JAX package does; resized through
    PIL (bicubic) only where its size differs from (height, width)."""
    arr = np.asarray(image, np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    q = (arr * 255).astype(np.uint8)
    if q.shape[:2] != (height, width):
        from PIL import Image

        q = np.asarray(Image.fromarray(q).resize((width, height), resample=2))
    arr = q.astype(np.float32) / 255.0
    return torch.from_numpy(arr)[None].repeat(batch, 1, 1, 1).to(device)


def keep_schedule(num_steps: int, start: float, end: float) -> torch.Tensor:
    """[S] control weights: 1.0 where the step's fraction i / (S - 1) lies in
    [start, end], else 0.0."""
    frac = np.arange(num_steps, dtype=np.float32) / max(num_steps - 1, 1)
    return torch.from_numpy(((frac >= start) & (frac <= end)).astype(np.float32))


def generate_sdxl_controlnet(
        models: PEAModels, controlnet: ControlNet, ids, uncond_ids, control_image, *,
        generator: Optional[torch.Generator] = None, sampler_name: str = "dpm++",
        height: int = 1024, width: int = 1024, num_steps: int = 30,
        guidance_scale=7.5, guidance_rescale=0.0, controlnet_conditioning_scale=1.0,
        guess_mode: bool = False, control_guidance_start: float = 0.0,
        control_guidance_end: float = 1.0, init_noise=None) -> torch.Tensor:
    """ids, uncond_ids [B, T], control_image [B, height, width, 3] in [0, 1]
    -> images [B, height, width, 3] in [0, 1], always with CFG. Each step
    runs the ControlNet (on the CFG pair, or on the conditional half in guess
    mode) with scale keep[i] * controlnet_conditioning_scale, then the UNet
    on the pair with its residuals. `guidance_scale`, `guidance_rescale` and
    `controlnet_conditioning_scale` may be [B] vectors (one per request); a
    row's conditioning scale multiplies the residuals of both rows of its
    CFG pair. `init_noise` [B, H/8, W/8, 4] replaces the initial latents
    drawn from `generator`."""
    device = models.device
    with torch.inference_mode():
        ids, uncond_ids = as_ids(ids, device), as_ids(uncond_ids, device)
        context, pooled = encode_prompt_sdxl(models, ids, uncond_ids)
        b = ids.shape[0]
        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        noise = _initial_noise((b, height // 8, width // 8, 4), generator, init_noise, device)
        time_ids = make_add_time_ids((height, width), (0, 0), (height, width), 2 * b, device)
        added = {"text_embeds": pooled, "time_ids": time_ids}
        added_c = {"text_embeds": pooled[b:], "time_ids": time_ids[b:]}
        keep = keep_schedule(num_steps, control_guidance_start, control_guidance_end)
        control = torch.as_tensor(control_image, dtype=torch.float32, device=device)
        control_pair = torch.cat([control, control], dim=0)
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
        gr = torch.as_tensor(guidance_rescale, dtype=torch.float32, device=device)
        cscale = torch.as_tensor(controlnet_conditioning_scale, dtype=torch.float32,
                                 device=device)
        pair_scale = cscale
        if cscale.ndim:  # one a row: [B, 1, 1, 1], and the pair's [uncond; cond] rows
            cscale = cscale.reshape(b, 1, 1, 1)
            pair_scale = torch.cat([cscale, cscale])

        def eps_fn(x, i):
            t = torch.full((2 * b,), int(sampler.timesteps[i]), dtype=torch.long,
                           device=device)
            x2 = torch.cat([x, x], dim=0)
            with span("pipe.controlnet"):
                if guess_mode:
                    down_c, mid_c = controlnet(x, t[b:], context[b:], control,
                                               keep[i].item() * cscale, added_c)
                    down = tuple(torch.cat([torch.zeros_like(d), d]) for d in down_c)
                    mid = torch.cat([torch.zeros_like(mid_c), mid_c])
                else:
                    down, mid = controlnet(x2, t, context, control_pair,
                                           keep[i].item() * pair_scale, added)
            with span("pipe.unet"):
                out = models.unet(x2, t, context, added, down_block_additional_residuals=down,
                                  mid_block_additional_residual=mid).float()
            return cfg_combine(out, gs, gr)

        return decode_latents(models, denoise_loop(eps_fn, sampler, noise))


class StableDiffusionXLControlNetPEAPipeline(StableDiffusionXLPEAPipeline):
    """SDXL + PEA adapter + a ControlNet, with the text-to-image pipeline's
    call and two more operands: with a `control_image` [B, H, W, 3] in
    [0, 1] a call runs `generate_sdxl_controlnet` (the keep schedule over
    every step, guess mode off) at `controlnet_conditioning_scale`, a
    number or a [B] vector; without one it is the text-to-image call, as
    the parent class makes it."""

    def __init__(self, models: PEAModels, controlnet: ControlNet, sampler_name: str = "dpm++",
                 aot_dir: Optional[str] = None):
        super().__init__(models, sampler_name, aot_dir=aot_dir)
        self.controlnet = controlnet

    def _denoisers(self) -> tuple:
        return (self.models.unet, self.controlnet)

    def __call__(self, ids, uncond_ids, *, height=1024, width=1024, num_steps=30,
                 guidance_scale=7.5, guidance_rescale=0.0, seed=0, init_noise=None,
                 control_image=None, controlnet_conditioning_scale=1.0) -> torch.Tensor:
        if control_image is None:
            return super().__call__(ids, uncond_ids, height=height, width=width,
                                    num_steps=num_steps, guidance_scale=guidance_scale,
                                    guidance_rescale=guidance_rescale, seed=seed,
                                    init_noise=init_noise)
        gen = torch.Generator(device=self.models.device).manual_seed(seed)
        return generate_sdxl_controlnet(
            self.models, self.controlnet, ids, uncond_ids, control_image, generator=gen,
            sampler_name=self.sampler_name, height=height, width=width, num_steps=num_steps,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            controlnet_conditioning_scale=controlnet_conditioning_scale, init_noise=init_noise)


def canny_edges(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edges of an [H, W] or [H, W, 3] uint8 image, as [H, W, 3] uint8:
    OpenCV's where it is installed, else ``_canny_numpy``."""
    try:
        import cv2
        edges = cv2.Canny(np.asarray(image, np.uint8), low, high)
    except ImportError:
        edges = _canny_numpy(np.asarray(image, np.uint8), low, high)
    return edges[:, :, None].repeat(3, axis=2)


def _canny_numpy(image: np.ndarray, low: float, high: float) -> np.ndarray:
    """Canny in numpy: [H, W] or [H, W, 3] uint8 -> [H, W] uint8 edges (a
    5-tap gaussian, Sobel, non-maximum suppression along the quantised
    gradient direction, hysteresis over 8-connected components with scipy's
    labelling, or by growing one ring per pass without scipy)."""
    g = image.astype(np.float32)
    if g.ndim == 3:
        g = g @ np.array([0.299, 0.587, 0.114], np.float32)
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    pad = np.pad(g, 2, mode="edge")
    g = sum(k[i] * pad[i:i + g.shape[0], 2:-2] for i in range(5))
    pad = np.pad(g, 2, mode="edge")
    g = sum(k[i] * pad[2:-2, i:i + g.shape[1]] for i in range(5))

    p = np.pad(g, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2 + (p[:-2, 2:] - p[:-2, :-2]) \
        + (p[2:, 2:] - p[2:, :-2])
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2 + (p[2:, :-2] - p[:-2, :-2]) \
        + (p[2:, 2:] - p[:-2, 2:])
    mag = np.hypot(gx, gy)
    ang = np.mod(np.arctan2(gy, gx), np.pi)

    mp = np.pad(mag, 1)
    shifts = {  # direction bin -> the two neighbours along the gradient
        0: (mp[1:-1, 2:], mp[1:-1, :-2]),
        1: (mp[2:, 2:], mp[:-2, :-2]),
        2: (mp[2:, 1:-1], mp[:-2, 1:-1]),
        3: (mp[2:, :-2], mp[:-2, 2:]),
    }
    dbin = np.floor((ang + np.pi / 8) / (np.pi / 4)).astype(np.int32) % 4
    keep = np.zeros_like(mag, bool)
    for b, (n1, n2) in shifts.items():
        m = dbin == b
        keep |= m & (mag >= n1) & (mag >= n2)
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high
    weak = nms >= low
    try:
        from scipy import ndimage
        labels, _ = ndimage.label(weak, structure=np.ones((3, 3), np.int8))
        keep_ids = np.unique(labels[strong])
        strong = weak & np.isin(labels, keep_ids[keep_ids > 0])
    except ImportError:
        for _ in range(max(mag.shape)):  # each pass reaches one ring further
            sp = np.pad(strong, 1)
            grown = weak & (
                sp[:-2, :-2] | sp[:-2, 1:-1] | sp[:-2, 2:] | sp[1:-1, :-2]
                | sp[1:-1, 2:] | sp[2:, :-2] | sp[2:, 1:-1] | sp[2:, 2:])
            new = strong | grown
            if (new == strong).all():
                break
            strong = new
    return (strong * 255).astype(np.uint8)
