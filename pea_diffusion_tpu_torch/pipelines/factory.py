"""Builds a PEA deployment (text tower + adapter + UNet + VAE), a ControlNet
for its UNet, or the KD training stack (the deployment plus the CLIP teacher
towers: CLIP ViT-L and bigG for SDXL, ViT-L alone for SD1.5), with random
weights made on the device (port of ``pea_diffusion_tpu/pipelines/factory.py``
and of the JAX CLI's ControlNet set-up). The configs decide
the model: the VAE's scaling factor (0.18215 for SD1.5, 0.13025 for SDXL)
comes from its config; both models share one noise schedule
(``SD15_SCHEDULE`` is ``SDXL_SCHEDULE``, as in the reference checkpoints).

Modules are created on the meta device, given storage on the target device,
and filled there from one seeded ``torch.Generator``: norm weights 1, biases
0, every other weight N(0, 0.02), as the JAX package's ``init_params_host``
fills them. The modules are built for inference: eval mode, no gradients.
Real weights load with ``load_state_dict`` (see
``checkpoints/from_jax.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..configs.adapter import AdapterConfig
from ..configs.text_encoder import BertTextConfig, CLIPTextConfig
from ..configs.unet import ControlNetConfig, UNetConfig, VAEConfig
from ..models.adapter import PEAAdapter
from ..models.bert_text import BertTextEncoder
from ..models.clip_text import CLIPTextEncoder
from ..models.controlnet import ControlNet
from ..models.layers import GroupNorm, LayerNormFP32
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..schedulers import SDXL_SCHEDULE, NoiseScheduleConfig
from .text2image import PEAModels

_NORMS = (GroupNorm, LayerNormFP32, nn.LayerNorm)


def resolve_device(device) -> torch.device:
    """The device to run on; raises if CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def make_text_encoder_fn(family: str, text_cfg: BertTextConfig
                         ) -> Tuple[nn.Module, Callable[[torch.Tensor], torch.Tensor]]:
    """(module, fn(ids) -> token states [B, T, D]) for a student family."""
    if family == "chinese_clip":
        enc = BertTextEncoder(text_cfg)
        return enc, lambda ids: enc(ids).last_hidden_state
    raise NotImplementedError(
        f"text-encoder family {family!r} is not ported yet (ROADMAP Queue A item 12)")


@torch.no_grad()
def _materialize(module: nn.Module, dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator) -> nn.Module:
    module.to(dtype).to_empty(device=device)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight" and isinstance(mod, _NORMS):
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return module.eval().requires_grad_(False)


def build_models(*, family: str, text_cfg: BertTextConfig,
                 adapter_cfg: AdapterConfig, unet_cfg: UNetConfig,
                 vae_cfg: VAEConfig,
                 schedule: NoiseScheduleConfig = SDXL_SCHEDULE,
                 dtype: torch.dtype = torch.bfloat16,
                 vae_dtype: torch.dtype = torch.float32,
                 adapter_dtype: Optional[torch.dtype] = None,
                 device="cuda", seed: int = 0) -> PEAModels:
    """The text tower and UNet hold `dtype` weights, the VAE `vae_dtype`;
    the adapter keeps fp32 weights and computes in `adapter_dtype` (by
    default `dtype`)."""
    device = resolve_device(device)
    with torch.device("meta"):
        text, text_fn = make_text_encoder_fn(family, text_cfg)
        adapter = PEAAdapter(adapter_cfg, dtype=adapter_dtype or dtype)
        unet = UNet2DCondition(unet_cfg)
        vae = AutoencoderKL(vae_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return PEAModels(
        text_encoder=_materialize(text, dtype, device, gen),
        text_encoder_fn=text_fn,
        adapter=_materialize(adapter, torch.float32, device, gen),
        unet=_materialize(unet, dtype, device, gen),
        vae=_materialize(vae, vae_dtype, device, gen),
        schedule=schedule,
        vae_scaling=vae_cfg.scaling_factor,
        device=device,
    )


def build_controlnet(unet_cfg: UNetConfig,
                     conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256),
                     dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0,
                     zero_init: bool = True) -> ControlNet:
    """A ControlNet for a UNet of config `unet_cfg` (its down and mid blocks,
    the same text width and added conditioning), with random weights from
    `seed` on `device` in `dtype`, for inference. Its zero convs start at
    zero, as diffusers' and the JAX package's do, unless `zero_init` is
    False: then they keep their N(0, 0.02) draws, so that random residuals
    reach the UNet."""
    cfg = ControlNetConfig(unet=unet_cfg,
                           conditioning_embedding_channels=conditioning_embedding_channels)
    device = resolve_device(device)
    with torch.device("meta"):
        cn = ControlNet(cfg)
    cn = _materialize(cn, dtype, device, torch.Generator(device=device).manual_seed(seed))
    if zero_init:
        with torch.no_grad():
            for conv in cn.zero_convs():
                conv.weight.zero_()
                conv.bias.zero_()
    return cn


def build_kd_models(*, teacher_cfgs: Tuple[CLIPTextConfig, ...],
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0, vae_encode_chunk: Optional[int] = 2, **stack):
    """The KD training stack (``train.kd.KDModels``): ``build_models``'s
    stack (`stack` and `dtype` as there) with the adapter computing in
    fp32, as the JAX package's training adapter does, and the only
    trainable part; plus the frozen CLIP teachers in `dtype`, from seed
    `seed` + 1: two configs for SDXL's dual teacher, one for SD1.5's
    (``teacher_clip2`` is then None). The VAE encodes in chunks of
    `vae_encode_chunk` samples."""
    from ..train.kd import KDModels

    m = build_models(dtype=dtype, adapter_dtype=torch.float32, device=device,
                     seed=seed, **stack)
    with torch.device("meta"):
        teachers = [CLIPTextEncoder(c) for c in teacher_cfgs]
    gen = torch.Generator(device=m.device).manual_seed(seed + 1)
    teachers = [_materialize(t, dtype, m.device, gen) for t in teachers] + [None, None]
    return KDModels(
        adapter=m.adapter.train(), unet=m.unet, vae=m.vae,
        text_encoder=m.text_encoder, text_encoder_fn=m.text_encoder_fn,
        teacher_clip1=teachers[0], teacher_clip2=teachers[1],
        schedule=m.schedule, vae_scaling=m.vae_scaling,
        vae_encode_chunk=vae_encode_chunk).freeze()
