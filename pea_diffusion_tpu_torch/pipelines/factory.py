"""Builds a PEA deployment (text tower + adapter + UNet + VAE) with random
weights made on the device (port of ``pea_diffusion_tpu/pipelines/factory.py``).

Modules are created on the meta device, given storage on the target device,
and filled there from one seeded ``torch.Generator``: norm weights 1, biases
0, every other weight N(0, 0.02), as the JAX package's ``init_params_host``
fills them. The modules are built for inference: eval mode, no gradients.
Real weights load with ``load_state_dict`` (see
``checkpoints/from_jax.py``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from ..configs.adapter import AdapterConfig
from ..configs.text_encoder import BertTextConfig
from ..configs.unet import UNetConfig, VAEConfig
from ..models.adapter import PEAAdapter
from ..models.bert_text import BertTextEncoder
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
                 attn_backend: str = "auto", device="cuda",
                 seed: int = 0) -> PEAModels:
    """The text tower and UNet hold `dtype` weights, the VAE `vae_dtype`;
    the adapter keeps fp32 weights and computes in `dtype`."""
    device = resolve_device(device)
    with torch.device("meta"):
        text, text_fn = make_text_encoder_fn(family, text_cfg)
        adapter = PEAAdapter(adapter_cfg, dtype=dtype)
        unet = UNet2DCondition(unet_cfg, attn_backend=attn_backend)
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
