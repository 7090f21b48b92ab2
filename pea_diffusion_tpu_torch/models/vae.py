"""AutoencoderKL, the SD/SDXL VAE (port of ``pea_diffusion_tpu/models/vae.py``),
with diffusers parameter names. Takes and returns NHWC; runs NCHW inside.
The mid-block attention is one head over all pixels and always takes the
plain attention path (`backend="xla"`), as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.unet import VAEConfig
from .layers import Downsample2D, GroupNorm, MultiHeadAttention, ResnetBlock2D, Upsample2D
from .unet import UNetBlock, _nchw, _nhwc


class VAEAttention(MultiHeadAttention):
    """GN (eps 1e-6) -> single-head attention over HW tokens -> residual."""

    def __init__(self, channels: int, norm_num_groups: int):
        super().__init__(channels, 1, channels, qkv_bias=True, backend="xla")
        self.group_norm = GroupNorm(channels, norm_num_groups, 1e-6)

    def forward(self, h):
        b, c, hh, ww = h.shape
        x = _nhwc(self.group_norm(h)).reshape(b, hh * ww, c)
        x = super().forward(x)
        return h + _nchw(x.reshape(b, hh, ww, c))


def _mid_block(channels: int, groups: int) -> UNetBlock:
    return UNetBlock([ResnetBlock2D(channels, channels, None, groups),
                      ResnetBlock2D(channels, channels, None, groups)],
                     [VAEAttention(channels, groups)])


def _run_mid(mid: UNetBlock, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, groups = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = chans[0]
        for i, out_ch in enumerate(chans):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, None, groups))
                ch = out_ch
            down = Downsample2D(ch, ch) if i < len(chans) - 1 else None
            self.down_blocks.append(UNetBlock(resnets, downsample=down))
        self.mid_block = _mid_block(ch, groups)
        self.conv_norm_out = GroupNorm(ch, groups, 1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, groups = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], groups)
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, None, groups))
                ch = out_ch
            up = Upsample2D(ch, ch) if i < len(rev) - 1 else None
            self.up_blocks.append(UNetBlock(resnets, upsample=up))
        self.conv_norm_out = GroupNorm(ch, groups, 1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lat = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, 3] in [-1, 1] -> (mean, logvar), each [B, H/8, W/8, 4]."""
        dtype = self.quant_conv.weight.dtype
        moments = _nhwc(self.quant_conv(self.encoder(_nchw(x.to(dtype)))))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, 4] (unscaled latents) -> image [B, 8h, 8w, 3]."""
        dtype = self.post_quant_conv.weight.dtype
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(z.to(dtype)))))
