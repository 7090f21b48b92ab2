"""PEA text-to-image for SD1.5 and SDXL (port of
``pea_diffusion_tpu/pipelines/text2image.py``).

Prompt ids go through the text tower and the PEA adapter (the negative prompt
too), the UNet runs the CFG pair as one batch ([uncond; cond]) under the
sampler with `cfg_combine` after each step, and the VAE decodes the latents
to NHWC images in [0, 1]. SD1.5's adapter gives the cross-attention states
only; SDXL's also the pooled embedding for the added conditioning. The SDXL
ensemble of experts splits the steps at a timestep cutoff: the base's
`generate_sdxl(..., denoising_end=f)` hands its latents to `refine_sdxl`
(the refiner's UNet and adapter, aesthetic-score time ids).
Generation runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models.adapter import PEAAdapter
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..schedulers import NoiseScheduleConfig
from ..utils.trace import span
from .sampling import Sampler, make_sampler, rescale_noise_cfg


@dataclasses.dataclass
class PEAModels:
    """The modules of one PEA deployment, their weights inside them."""

    text_encoder: nn.Module
    # ids [B, T] (mul_zh: {"mul", "zh"} dict) -> token hidden states [B, T, D]
    text_encoder_fn: Callable[..., torch.Tensor]
    adapter: PEAAdapter
    unet: UNet2DCondition
    vae: AutoencoderKL
    schedule: NoiseScheduleConfig
    vae_scaling: float
    device: torch.device


def denoise_loop(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 sampler: Sampler, noise: torch.Tensor,
                 generator: Optional[torch.Generator] = None, step_noise=None,
                 start: int = 0, end: Optional[int] = None,
                 init_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampling loop over steps [start, end). eps_fn(x, i) -> the
    CFG-combined model output for latent x at step i. A stochastic sampler's
    step i takes `step_noise[i]` if given, else its draw from `generator` (in
    step order), else no noise (the JAX loop's rng=None)."""
    x = noise * sampler.init_noise_sigma if init_latents is None else init_latents
    state = sampler.init()
    end = sampler.num_steps if end is None else end
    for i in range(start, end):
        with span("pipe.sampler_step"):
            out = eps_fn(sampler.scale(i, x), i)
            if step_noise is not None:
                draw = step_noise[i]
            else:
                draw = None if generator is None else sampler.draw(x, generator)
            x, state = sampler.step(i, x, out, state, draw)
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
    with span("pipe.decode"):
        return _decode(models, latents, chunk)


def _decode(models: PEAModels, latents: torch.Tensor, chunk: int) -> torch.Tensor:
    b = latents.shape[0]
    if 0 < chunk < b:
        nchunks = -(-b // chunk)
        pad = nchunks * chunk - b
        z = latents
        if pad:
            z = torch.cat([z, z[-1:].expand(pad, *z.shape[1:])], dim=0)
        imgs = [_decode(models, zc, 0) for zc in z.split(chunk)]
        return torch.cat(imgs, dim=0)[:b]
    z = latents.float() / models.vae_scaling
    img = models.vae.decode(z)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


def to_pil(images: torch.Tensor):
    """[B, H, W, 3] floats in [0, 1] -> list of PIL images."""
    from PIL import Image

    arr = (images.float().cpu().numpy() * 255).round().astype(np.uint8)
    return [Image.fromarray(a) for a in arr]


def encode_vae_image(models: PEAModels, image: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[-1, 1] NHWC image -> scaled latent sample: the image in fp32 on
    entry, a draw from the VAE encoder's Gaussian (`eps` [B, H/f, W/f, 4] if
    given, else drawn from `generator`), times the VAE's scaling."""
    z = models.vae.encode_sample(image.float(), generator=generator, eps=eps)
    return z * models.vae_scaling


def make_add_time_ids(original_size, crops_coords_top_left, target_size,
                      batch: int, device=None, aesthetic_score=None) -> torch.Tensor:
    """SDXL micro-conditioning [B, 6]; with `aesthetic_score`, the refiner's
    [B, 5] form original_size + crops_coords_top_left + (score,)."""
    tail = list(target_size) if aesthetic_score is None else [float(aesthetic_score)]
    ids = torch.tensor(list(original_size) + list(crops_coords_top_left) + tail,
                       dtype=torch.float32, device=device)
    return ids[None].repeat(batch, 1)


def timestep_cutoff(schedule: NoiseScheduleConfig, fraction) -> np.float32:
    """num_train_timesteps * (1 - fraction), in float32 as the JAX package
    computes it on its float32 fraction (float64 moves the cut: at 30 steps
    a fraction of 0.9 keeps timestep 100 above it in float64, not in
    float32)."""
    return np.float32(schedule.num_train_timesteps) * (np.float32(1.0) - np.float32(fraction))


def steps_at_or_above(sampler: Sampler, schedule: NoiseScheduleConfig, fraction) -> int:
    """How many of the sampler's timesteps lie at or above the cutoff of
    `fraction`: the end of a `denoising_end` window, the start of a
    `denoising_start` one in `refine_sdxl`."""
    return int(np.sum(sampler.timesteps >= timestep_cutoff(schedule, fraction)))


def encode_prompt_sd(models: PEAModels, ids, uncond_ids) -> torch.Tensor:
    """Adapter-projected cross-attention states [2B, T, 768], CFG-stacked
    [uncond; cond]. The negative prompt also goes through the adapter."""
    with span("pipe.encode_prompt"):
        seq = models.adapter(models.text_encoder_fn(ids))
        seq_u = models.adapter(models.text_encoder_fn(uncond_ids))
        return torch.cat([seq_u, seq], dim=0)


def encode_prompt_sdxl(models: PEAModels, ids, uncond_ids):
    """Adapter-projected (context [2B, T, 2048], pooled [2B, 1280]),
    CFG-stacked [uncond; cond]. The negative prompt also goes through the
    adapter: the PEA plug-in replaces the whole prompt-encoding stage."""
    with span("pipe.encode_prompt"):
        hs = models.text_encoder_fn(ids)
        hs_u = models.text_encoder_fn(uncond_ids)
        pooled, seq = models.adapter(hs)
        pooled_u, seq_u = models.adapter(hs_u)
        return torch.cat([seq_u, seq], dim=0), torch.cat([pooled_u, pooled], dim=0)


def ids_batch_size(ids) -> int:
    """Leading batch dim of token ids: a [B, T] array, or the mul_zh
    family's {"mul": [B, T], "zh": [B, T]} dict (two tokenizers)."""
    if isinstance(ids, dict):
        return next(iter(ids.values())).shape[0]
    return ids.shape[0]


def as_ids(ids, device):
    """Token ids (an array or a list) -> int64 on `device`, mapped over
    the mul_zh family's dict of ids."""
    if isinstance(ids, dict):
        return {k: as_ids(v, device) for k, v in ids.items()}
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)


def _initial_noise(shape, generator, init_noise, device) -> torch.Tensor:
    if init_noise is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return torch.as_tensor(init_noise, dtype=torch.float32, device=device)


def generate_sd(models: PEAModels, ids, uncond_ids, *,
                generator: Optional[torch.Generator] = None,
                sampler_name: str = "dpm++", height: int = 512, width: int = 512,
                num_steps: int = 30, guidance_scale: float = 7.5,
                init_noise=None) -> torch.Tensor:
    """SD1.5: ids, uncond_ids [B, T] -> images [B, height, width, 3] in
    [0, 1], always with CFG. `init_noise` [B, H/8, W/8, C] replaces the
    initial latents drawn from `generator`. As in the JAX package, the
    denoise loop gets no random source here: an ancestral or LCM sampler
    takes no fresh noise on this path."""
    device = models.device
    with torch.inference_mode():
        ids, uncond_ids = as_ids(ids, device), as_ids(uncond_ids, device)
        context = encode_prompt_sd(models, ids, uncond_ids)
        b = ids_batch_size(ids)
        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        noise = _initial_noise((b, height // 8, width // 8, models.unet.config.in_channels),
                               generator, init_noise, device)
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)

        def eps_fn(x, i):
            t = torch.full((2 * b,), int(sampler.timesteps[i]), dtype=torch.long,
                           device=device)
            with span("pipe.unet"):
                out = models.unet(torch.cat([x, x], dim=0), t, context).float()
            return cfg_combine(out, gs)

        return decode_latents(models, denoise_loop(eps_fn, sampler, noise))


def generate_sdxl(models: PEAModels, ids, uncond_ids, *,
                  generator: Optional[torch.Generator] = None,
                  sampler_name: str = "dpm++", height: int = 1024,
                  width: int = 1024, num_steps: int = 30,
                  guidance_scale=7.5, guidance_rescale=0.0,
                  original_size=None, crops_coords_top_left=(0, 0),
                  target_size=None, do_cfg: Optional[bool] = None,
                  denoising_end: Optional[float] = None,
                  init_noise=None, step_noise=None, split_decode: bool = False,
                  decode_chunk: int = 0) -> torch.Tensor:
    """ids, uncond_ids [B, T] -> images [B, height, width, 3] in [0, 1]; with
    `denoising_end`, the undecoded latents [B, H/8, W/8, 4] after the steps
    whose timesteps lie at or above its cutoff (the base half of the
    ensemble, handed to `refine_sdxl`).

    `guidance_scale` / `guidance_rescale` may be [B] vectors (one per
    request). `do_cfg` defaults to "some guidance > 1"; without CFG only the
    conditional half runs (the LCM / Turbo few-step path). `init_noise`
    [B, H/8, W/8, 4] replaces the initial latents drawn from `generator`,
    and `step_noise` [steps, B, H/8, W/8, 4] the draws of a stochastic
    sampler's steps, which otherwise come from `generator` after the
    initial latents.

    `decode_chunk` > 0 decodes `decode_chunk` rows at a time
    (`decode_latents`): the int8 "vae" scope's full-size serving needs it,
    its im2col being ~1.2 GB a 1024² image. `split_decode` is the JAX
    package's switch to compile the denoise loop and the decode as two
    programs; eager always runs them apart, so it changes nothing here."""
    device = models.device
    if do_cfg is None:
        do_cfg = bool(np.max(np.asarray(guidance_scale)) > 1.0)
    with torch.inference_mode():
        ids, uncond_ids = as_ids(ids, device), as_ids(uncond_ids, device)
        context, pooled = encode_prompt_sdxl(models, ids, uncond_ids)
        b = ids_batch_size(ids)
        if not do_cfg:
            context, pooled = context[b:], pooled[b:]
        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        noise = _initial_noise((b, height // 8, width // 8, 4), generator, init_noise,
                               device)
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
            with span("pipe.unet"):
                out = models.unet(x_in, t, context, added).float()
            return cfg_combine(out, gs, gr) if do_cfg else out

        if step_noise is not None:
            step_noise = torch.as_tensor(np.asarray(step_noise), device=device)
        end = None
        if denoising_end is not None:
            end = steps_at_or_above(sampler, models.schedule, denoising_end)
        latents = denoise_loop(eps_fn, sampler, noise, generator, step_noise, end=end)
        if denoising_end is not None:
            return latents
        return decode_latents(models, latents, chunk=decode_chunk)


def refine_sdxl(models: PEAModels, ids, uncond_ids, latents, *,
                sampler_name: str = "ddim", num_steps: int = 30, guidance_scale=7.5,
                denoising_start: float = 0.8, aesthetic_score: float = 6.0,
                negative_aesthetic_score: float = 2.5, original_size=None,
                crops_coords_top_left=(0, 0)) -> torch.Tensor:
    """The refiner half of the SDXL ensemble of experts: continues the
    latents of `generate_sdxl(..., denoising_end=f)` from the first step whose
    timestep lies below the cutoff of `denoising_start` (none when every
    timestep is at or above it) to the end, with CFG and the refiner's
    [B, 5] time ids (the unconditional half carries the negative score),
    and decodes. `models.unet` is typically SDXL_REFINER_UNET. As in the
    JAX package the loop gets no random source: a stochastic sampler takes
    no fresh noise here."""
    device = models.device
    with torch.inference_mode():
        ids, uncond_ids = as_ids(ids, device), as_ids(uncond_ids, device)
        context, pooled = encode_prompt_sdxl(models, ids, uncond_ids)
        b = ids_batch_size(ids)
        sampler = make_sampler(sampler_name, models.schedule, num_steps)
        latents = torch.as_tensor(latents, device=device)
        size = (latents.shape[1] * 8, latents.shape[2] * 8)
        osize = original_size or size
        time_ids = torch.cat([
            make_add_time_ids(osize, crops_coords_top_left, size, b, device,
                              aesthetic_score=score)
            for score in (negative_aesthetic_score, aesthetic_score)])
        added = {"text_embeds": pooled, "time_ids": time_ids}
        gs = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
        start = steps_at_or_above(sampler, models.schedule, denoising_start)

        def eps_fn(x, i):
            t = torch.full((2 * b,), int(sampler.timesteps[i]), dtype=torch.long,
                           device=device)
            with span("pipe.unet"):
                out = models.unet(torch.cat([x, x], dim=0), t, context, added).float()
            return cfg_combine(out, gs)

        latents = denoise_loop(eps_fn, sampler, torch.zeros_like(latents), start=start,
                               init_latents=latents)
        return decode_latents(models, latents)


def generate_sdxl_ensemble(base_models: PEAModels, refiner_models: PEAModels, ids,
                           uncond_ids, *, generator: Optional[torch.Generator] = None,
                           height: int = 1024, width: int = 1024, num_steps: int = 30,
                           guidance_scale=7.5, high_noise_frac: float = 0.8,
                           sampler_name: str = "ddim", refiner_ids=None,
                           refiner_uncond_ids=None, init_noise=None,
                           step_noise=None) -> torch.Tensor:
    """Base + refiner ensemble of experts: the base denoises down to the
    cutoff of `high_noise_frac`, the refiner (its own UNet and adapter,
    prompted with `refiner_ids` / `refiner_uncond_ids` if given) finishes
    and decodes. `generator`, `init_noise` and `step_noise` go to the base
    (`generate_sdxl`); the refiner draws nothing."""
    latents = generate_sdxl(
        base_models, ids, uncond_ids, generator=generator, sampler_name=sampler_name,
        height=height, width=width, num_steps=num_steps, guidance_scale=guidance_scale,
        denoising_end=high_noise_frac, init_noise=init_noise, step_noise=step_noise)
    return refine_sdxl(
        refiner_models, ids if refiner_ids is None else refiner_ids,
        uncond_ids if refiner_uncond_ids is None else refiner_uncond_ids, latents,
        sampler_name=sampler_name, num_steps=num_steps, guidance_scale=guidance_scale,
        denoising_start=high_noise_frac)


class StableDiffusionPEAPipeline:
    """SD1.5 + PEA adapter (seq-only projection). Calling it returns the
    images as a [B, H, W, 3] tensor in [0, 1]."""

    def __init__(self, models: PEAModels, sampler_name: str = "dpm++"):
        self.models, self.sampler_name = models, sampler_name

    def __call__(self, ids, uncond_ids, *, height=512, width=512, num_steps=30,
                 guidance_scale=7.5, seed=0, init_noise=None) -> torch.Tensor:
        gen = torch.Generator(device=self.models.device).manual_seed(seed)
        return generate_sd(
            self.models, ids, uncond_ids, generator=gen,
            sampler_name=self.sampler_name, height=height, width=width,
            num_steps=num_steps, guidance_scale=float(guidance_scale),
            init_noise=init_noise)


class StableDiffusionXLPEAPipeline:
    """SDXL + PEA adapter (pooled 1280 + seq 2048). Calling it returns the
    images as a [B, H, W, 3] tensor in [0, 1]; `to_pil` turns them into
    PIL images.

    `aot_dir` (``--aot-cache``) keeps the compiled libraries under that
    directory, keyed by the sources and the card (utils/startup.py's
    `AOTCache`), so that a restarted process builds nothing.

    `mesh`: a tensor-parallel mesh (parallel/tp.py); the models must already
    be placed on it (``shard_bundle_for_tp``), which is all it is checked
    for (the JAX signature's argument). Every rank of the mesh then makes
    the same call, and each gets the same images."""

    def __init__(self, models: PEAModels, sampler_name: str = "dpm++",
                 aot_dir: Optional[str] = None, mesh=None):
        if mesh is not None and getattr(models.unet, "tp_size", 1) != mesh.size(
                mesh.mesh_dim_names.index("model")):
            raise ValueError("mesh given but the UNet is not sharded over its 'model' dim: "
                             "place the models with parallel.tp.shard_bundle_for_tp first")
        self.models, self.sampler_name = models, sampler_name
        self._aot = None
        if aot_dir is not None:
            from ..utils.startup import AOTCache

            self._aot = AOTCache(aot_dir)

    def prefetch(self, batch: int, seq_len: int, *, height: int = 1024, width: int = 1024,
                 num_steps: int = 30) -> tuple:
        """Loads the kernel library (building it if it is not cached) and
        resolves every launcher that a request of `batch` prompts of
        `seq_len` tokens at height x width calls, from shapes alone: the
        weights may still be on their way (`device_put_streamed`). Returns
        the launchers' names; on a CPU pipeline, where no kernel runs, it
        does nothing and returns (). `batch` and `num_steps` change no
        launcher; they name the operating point as the JAX package's do."""
        del batch, num_steps
        if self.models.device.type != "cuda":
            return ()
        from ..ops import kernel_build
        from ..utils.startup import launcher_symbols, unet_attention_routes

        routes = unet_attention_routes(self.models.unet, height // 8, width // 8, seq_len)
        fused_gn = os.environ.get("PEA_FUSED_GROUPNORM") == "1"  # the layers' opt-in
        symbols = launcher_symbols(routes, fused_gn)
        for name, argtypes in symbols.items():  # the first one loads (or builds) the library
            kernel_build.function(name, argtypes)
        return tuple(symbols)

    def __call__(self, ids, uncond_ids, *, height=1024, width=1024,
                 num_steps=30, guidance_scale=7.5, guidance_rescale=0.0,
                 seed=0, init_noise=None) -> torch.Tensor:
        gen = torch.Generator(device=self.models.device).manual_seed(seed)
        return generate_sdxl(
            self.models, ids, uncond_ids, generator=gen,
            sampler_name=self.sampler_name, height=height, width=width,
            num_steps=num_steps, guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, init_noise=init_noise)
