"""Builds a PEA deployment (text tower + adapter + UNet + VAE), one that
shares its tower and VAE with another UNet (and adapter), one that shares its
UNet and VAE with another student tower and adapter, a ControlNet for
its UNet, or the KD training stack (the deployment plus the CLIP teacher
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
Real weights load through ``checkpoints/load_pretrained.py`` (diffusers and
transformers directories; ``load_weights`` below fills a module from a state
dict) or from a JAX tree (``checkpoints/from_jax.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.adapter import AdapterConfig
from ..configs.text_encoder import BertTextConfig, CLIPTextConfig, T5Config
from ..configs.unet import ControlNetConfig, UNetConfig, VAEConfig
from ..models.adapter import PEAAdapter
from ..models.bert_text import BertTextEncoder, ConcatTextEncoder
from ..models.clip_text import CLIPTextEncoder
from ..models.controlnet import ControlNet
from ..models.layers import GroupNorm, LayerNormFP32
from ..models.mt5 import T5Encoder, T5LayerNorm
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..quant.int8 import QConvInt8
from ..schedulers import SDXL_SCHEDULE, NoiseScheduleConfig
from .text2image import PEAModels

_NORMS = (GroupNorm, LayerNormFP32, nn.LayerNorm, T5LayerNorm)
# A student tower's config: one BERT or T5 config, or (mul, zh) for mul_zh.
TextConfig = Union[BertTextConfig, T5Config, Tuple[BertTextConfig, BertTextConfig]]


def resolve_device(device) -> torch.device:
    """The device to run on; raises if CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def make_text_encoder_fn(family: str, text_cfg: TextConfig,
                         module: Optional[nn.Module] = None
                         ) -> Tuple[nn.Module, Callable[..., torch.Tensor]]:
    """(module, fn(ids) -> token states [B, T, D]) for a student family; a
    new module unless `module` (a loaded tower) is given:

    - chinese_clip, mul_clip: a BERT tower's last hidden state;
    - alt_clip: the BERT tower's projected states (pre_LN + transformation);
    - mt5: the T5 encoder's last hidden state;
    - mul_zh: text_cfg = (mul_cfg, zh_cfg); ids {"mul": [B, T], "zh":
      [B, T]}, the two towers' last hidden states concatenated.
    """
    if family in ("chinese_clip", "mul_clip", "alt_clip"):
        enc = BertTextEncoder(text_cfg) if module is None else module
        if family == "alt_clip" and text_cfg.project_dim is not None:
            return enc, lambda ids: enc(ids).projected
        return enc, lambda ids: enc(ids).last_hidden_state
    if family == "mt5":
        enc = T5Encoder(text_cfg) if module is None else module
        return enc, enc
    if family == "mul_zh":
        enc = ConcatTextEncoder(*text_cfg) if module is None else module
        return enc, enc
    raise ValueError(f"unknown text-encoder family: {family}")


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
        if isinstance(mod, QConvInt8):
            mod.reset_buffers()
    return module.eval().requires_grad_(False)


@torch.no_grad()
def load_weights(module: nn.Module, state_dict, dtype: torch.dtype, device,
                 what: str = "module") -> nn.Module:
    """Fills `module` (built on the meta device) with `state_dict` on
    `device` in `dtype`, for inference. Every tensor of the module must be in
    the state dict, or it raises; keys the module does not have are ignored
    and counted in the message."""
    own = module.state_dict()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"{what}: {len(missing)} weights missing from the checkpoint, "
                       f"e.g. {missing[:5]}")
    extra = [k for k in state_dict if k not in own]
    module.to(dtype).to_empty(device=resolve_device(device))
    module.load_state_dict({k: state_dict[k] for k in own}, strict=True)
    print(f"[load] {what}: {len(own)} tensors in {dtype}"
          + (f", {len(extra)} extra keys ignored" if extra else ""))
    return module.eval().requires_grad_(False)


def build_models(*, family: str, text_cfg: TextConfig,
                 adapter_cfg: AdapterConfig, unet_cfg: UNetConfig,
                 vae_cfg: VAEConfig,
                 schedule: NoiseScheduleConfig = SDXL_SCHEDULE,
                 dtype: torch.dtype = torch.bfloat16,
                 vae_dtype: torch.dtype = torch.float32,
                 adapter_dtype: Optional[torch.dtype] = None,
                 device="cuda", seed: int = 0, conv_quant: str = "none") -> PEAModels:
    """The text tower and UNet hold `dtype` weights, the VAE `vae_dtype`;
    the adapter keeps fp32 weights and computes in `adapter_dtype` (by
    default `dtype`). `conv_quant` builds the UNet's in-scope convs int8
    (quant/int8.py), holding zero codes until quantized weights load
    (``quant.quantize_unet_params``, or ``quant.quantize_for_serving`` on a
    float stack)."""
    device = resolve_device(device)
    with torch.device("meta"):
        text, text_fn = make_text_encoder_fn(family, text_cfg)
        adapter = PEAAdapter(adapter_cfg, dtype=adapter_dtype or dtype)
        unet = UNet2DCondition(unet_cfg, conv_quant=conv_quant)
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


def build_unet(unet_cfg: UNetConfig, dtype: torch.dtype = torch.bfloat16, device="cuda",
               seed: int = 0) -> UNet2DCondition:
    """A UNet of `unet_cfg` with random weights from `seed` on `device` in
    `dtype`, for inference."""
    device = resolve_device(device)
    with torch.device("meta"):
        unet = UNet2DCondition(unet_cfg)
    return _materialize(unet, dtype, device, torch.Generator(device=device).manual_seed(seed))


def with_unet(models: PEAModels, unet_cfg: UNetConfig,
              adapter_cfg: Optional[AdapterConfig] = None,
              dtype: torch.dtype = torch.bfloat16, seed: int = 0) -> PEAModels:
    """A deployment sharing `models`' text tower and VAE, with a UNet of
    `unet_cfg` (a 9-channel inpainting UNet, SSD-1B, the SDXL refiner) in
    `dtype` from `seed` and, when `adapter_cfg` is given, its own adapter
    (the refiner's 1280-d text width) from `seed` + 1, fp32 weights
    computing as `models`' adapter does."""
    adapter = models.adapter
    if adapter_cfg is not None:
        with torch.device("meta"):
            adapter = PEAAdapter(adapter_cfg, dtype=models.adapter.dtype)
        adapter = _materialize(adapter, torch.float32, models.device,
                               torch.Generator(device=models.device).manual_seed(seed + 1))
    return dataclasses.replace(models, unet=build_unet(unet_cfg, dtype, models.device, seed),
                               adapter=adapter)


def with_text_tower(models, family: str, text_cfg: TextConfig, adapter_cfg: AdapterConfig,
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """A deployment (PEAModels, or train.kd.KDModels) sharing `models`' UNet,
    VAE and teachers, with the student tower of `family` in `dtype` and its
    adapter (fp32 weights, computing as `models`' adapter does), both from
    `seed` as ``build_models`` makes them. A KD stack's adapter is left for
    the caller to put in training mode (``KDModels.freeze``)."""
    with torch.device("meta"):
        text, text_fn = make_text_encoder_fn(family, text_cfg)
        adapter = PEAAdapter(adapter_cfg, dtype=models.adapter.dtype)
    gen = torch.Generator(device=models.device).manual_seed(seed)
    return dataclasses.replace(
        models, text_encoder=_materialize(text, dtype, models.device, gen),
        text_encoder_fn=text_fn, adapter=_materialize(adapter, torch.float32, models.device, gen))


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
