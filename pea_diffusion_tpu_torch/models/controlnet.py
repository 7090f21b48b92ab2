"""ControlNet (port of ``pea_diffusion_tpu/models/controlnet.py``): the
UNet's down and mid blocks with a 1x1 zero-initialised output conv on every
skip and on the mid output, and a conditioning-image embedder added to
conv_in's output. Parameter names are diffusers' ControlNetModel's
(``controlnet_cond_embedding.*``, ``controlnet_down_blocks.*``,
``controlnet_mid_block``). Takes and returns NHWC, like the UNet; runs NCHW
inside.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.unet import ControlNetConfig
from .layers import TimestepEmbedding
from .unet import _nchw, _nhwc, down_and_mid_blocks, embed_time, run_down_blocks, run_mid_block


class ConditioningEmbedder(nn.Module):
    """The [0, 1] control image (e.g. canny edges) to conv_in's feature
    space: a 3x3 conv, then per stage a 3x3 conv and a stride-2 3x3 conv,
    each followed by SiLU, and a zero-initialised 3x3 output conv."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels[0], 3, padding=1)
        blocks = []
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            blocks += [nn.Conv2d(c_in, c_in, 3, padding=1),
                       nn.Conv2d(c_in, c_out, 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, config: ControlNetConfig, attn_backend: str = "auto"):
        super().__init__()
        self.config = config
        cfg = config.unet
        c0 = cfg.block_out_channels[0]
        time_dim = c0 * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, time_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, time_dim)
        self.controlnet_cond_embedding = ConditioningEmbedder(
            config.conditioning_channels, config.conditioning_embedding_channels, c0)
        self.down_blocks, self.mid_block, skip_channels = down_and_mid_blocks(
            cfg, attn_backend)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(ch, ch, 1) for ch in skip_channels])
        mid_ch = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid_ch, mid_ch, 1)

    def zero_convs(self):
        """The convs diffusers and the JAX package initialise to zero: the
        embedder's output conv and every residual's output conv."""
        return [self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                self.controlnet_mid_block]

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, controlnet_cond: torch.Tensor,
                conditioning_scale=1.0,
                added_cond: Optional[Dict[str, torch.Tensor]] = None):
        """sample [B, H, W, 4] NHWC noisy latents, timesteps [B] or scalar,
        encoder_hidden_states [B, T, E], controlnet_cond [B, 8H, 8W, 3] in
        [0, 1], conditioning_scale a number or a tensor -> (down residuals,
        one NHWC tensor per UNet skip; the mid residual), each multiplied by
        the scale in the model's type."""
        dtype = self.conv_in.weight.dtype
        temb = embed_time(self, self.config.unet, timesteps, sample.shape[0], added_cond,
                          dtype)
        context = encoder_hidden_states.to(dtype)
        h = self.conv_in(_nchw(sample.to(dtype)))
        h = h + self.controlnet_cond_embedding(_nchw(controlnet_cond.to(dtype)))
        h, res_stack = run_down_blocks(self.down_blocks, h, temb, context)
        h = run_mid_block(self.mid_block, h, temb, context)
        scale = torch.as_tensor(conditioning_scale, device=h.device).to(dtype)
        down = tuple(_nhwc(conv(r)) * scale
                     for conv, r in zip(self.controlnet_down_blocks, res_stack))
        return down, _nhwc(self.controlnet_mid_block(h)) * scale
