"""Conditional UNet (port of ``pea_diffusion_tpu/models/unet.py``), with
diffusers UNet2DConditionModel parameter names. Takes and returns NHWC;
runs NCHW inside.

`capture_features=True` also returns the per-block hidden states
{d0..dN, m, u0..uN} (NHWC) for the KD feature loss, and
`down_block_additional_residuals` / `mid_block_additional_residual` add
ControlNet residuals (NHWC) to every down skip and the mid output.

`remat_segments=True` (the KD step's "blocks" remat policy) runs each unit
the JAX package names "unet_seg" (each down unit: a resnet and its
attention; the mid block; each up unit: the skip concat, a resnet and its
attention; each transformer block inside a Transformer2D) as its own
non-reentrant ``torch.utils.checkpoint`` region, the transformer blocks
nested inside their unit's; otherwise the same ops run plainly.

Under tensor parallelism (``parallel/tp.py::shard_bundle_for_tp``) the
resnets, attention modules and feed-forwards hold a rank's shard and the
"model" group; the UNet records the group and the degree in ``tp_group`` and
``tp_size``. The blocks take the same replicated activations either way, so
the forward below does not change.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.unet import UNetConfig
from ..quant.int8 import make_conv, parse_scopes
from .layers import (Downsample2D, GroupNorm, ResnetBlock2D, TimestepEmbedding,
                     Transformer2D, Upsample2D, timestep_embedding)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class UNetBlock(nn.Module):
    """A down, mid or up block: `resnets`, optional `attentions` (one per
    resnet) and an optional `downsamplers`/`upsamplers` entry."""

    def __init__(self, resnets: List[nn.Module],
                 attentions: Optional[List[nn.Module]] = None,
                 downsample: Optional[nn.Module] = None,
                 upsample: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def attention(self, j: int):
        return self.attentions[j] if hasattr(self, "attentions") else None


def _block_depths(depths: Sequence[int], where: str) -> bool:
    if any(depths) and not all(depths):
        raise ValueError(f"{where}: transformer depths {tuple(depths)} mix "
                         "plain and attention layers in one block")
    return all(depths)


def _transformer(cfg: UNetConfig, channels: int, block_idx: int, depth: int,
                 attn_backend: str) -> Transformer2D:
    heads = cfg.num_attention_heads[block_idx]
    return Transformer2D(channels, heads, channels // heads, depth, cfg.cross_attention_dim,
                         cfg.norm_num_groups, cfg.use_linear_projection, attn_backend)


def down_and_mid_blocks(cfg: UNetConfig, attn_backend: str = "auto", conv_quant: str = "none"):
    """The down blocks and the mid block of a UNet (a ControlNet builds the
    same), and the channels of every skip the down path leaves."""
    c0 = cfg.block_out_channels[0]
    time_dim = c0 * 4
    groups = cfg.norm_num_groups
    skip_channels = [c0]
    down_blocks = nn.ModuleList()
    ch = c0
    for i, out_ch in enumerate(cfg.block_out_channels):
        depths = cfg.down_block_layers(i)
        resnets, attns = [], []
        for j in range(cfg.layers_per_block):
            resnets.append(ResnetBlock2D(ch, out_ch, time_dim, groups, conv_quant=conv_quant))
            ch = out_ch
            skip_channels.append(ch)
        if _block_depths(depths, f"down block {i}"):
            attns = [_transformer(cfg, out_ch, i, d, attn_backend) for d in depths]
        down = None
        if i < cfg.num_blocks - 1:
            down = Downsample2D(out_ch, out_ch, conv_quant)
            skip_channels.append(ch)
        down_blocks.append(UNetBlock(resnets, attns, downsample=down))

    mid_ch = cfg.block_out_channels[-1]
    mid_block = UNetBlock(
        [ResnetBlock2D(mid_ch, mid_ch, time_dim, groups, conv_quant=conv_quant),
         ResnetBlock2D(mid_ch, mid_ch, time_dim, groups, conv_quant=conv_quant)],
        [_transformer(cfg, mid_ch, cfg.num_blocks - 1, cfg.mid_transformer_layers,
                      attn_backend)]
        if cfg.mid_transformer_layers > 0 else None)
    return down_blocks, mid_block, skip_channels


def embed_time(model: nn.Module, cfg: UNetConfig, timesteps: torch.Tensor, batch: int,
               added_cond: Optional[Dict[str, torch.Tensor]], dtype: torch.dtype
               ) -> torch.Tensor:
    """The time embedding [B, 4*C0] of a UNet or ControlNet `model` of UNet
    config `cfg` (its `time_embedding` and, for SDXL, `add_embedding` of the
    pooled text and the micro-conditioning time ids)."""
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(batch)
    c0 = cfg.block_out_channels[0]
    temb = timestep_embedding(timesteps, c0, cfg.flip_sin_to_cos,
                              cfg.freq_shift).to(dtype)
    temb = model.time_embedding(temb)
    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("SDXL UNet needs added_cond text_embeds/time_ids")
        time_ids = added_cond["time_ids"]
        b = time_ids.shape[0]
        t_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim,
            cfg.flip_sin_to_cos, cfg.freq_shift).reshape(b, -1)
        add = torch.cat([added_cond["text_embeds"].float(), t_emb], dim=-1)
        temb = temb + model.add_embedding(add.to(dtype))
    return temb


Segment = Optional[Callable[..., torch.Tensor]]


def checkpoint_segment(fn, *args):
    """`fn(*args)` as one recompute segment (non-reentrant checkpoint)."""
    return checkpoint(fn, *args, use_reentrant=False)


def _run(segment: Segment, fn, *args):
    return fn(*args) if segment is None else segment(fn, *args)


def _down_unit(resnet, attn, h, temb, context, segment: Segment = None):
    h = resnet(h, temb)
    return h if attn is None else attn(h, context, segment)


def _up_unit(resnet, attn, h, skip, temb, context, segment: Segment = None):
    h = resnet(torch.cat([h, skip.to(h.dtype)], dim=1), temb)
    return h if attn is None else attn(h, context, segment)


def _mid(mid: UNetBlock, h, temb, context, segment: Segment = None):
    h = mid.resnets[0](h, temb)
    if mid.attention(0) is not None:
        h = mid.attention(0)(h, context, segment)
    return mid.resnets[1](h, temb)


def run_down_blocks(blocks: nn.ModuleList, h: torch.Tensor, temb: torch.Tensor,
                    context: torch.Tensor,
                    features: Optional[Dict[str, torch.Tensor]] = None,
                    segment: Segment = None):
    """The down path from conv_in's output `h`: the last hidden state and the
    stack of skips (conv_in's output, every resnet or attention output, every
    downsample). `features` collects each block's output (NHWC) as d0..dN;
    `segment` runs each unit as a recompute segment."""
    res_stack = [h]
    for i, block in enumerate(blocks):
        for j, resnet in enumerate(block.resnets):
            unit = functools.partial(_down_unit, resnet, block.attention(j), segment=segment)
            h = _run(segment, unit, h, temb, context)
            res_stack.append(h)
        if hasattr(block, "downsamplers"):
            h = block.downsamplers[0](h)
            res_stack.append(h)
        if features is not None:
            features[f"d{i}"] = _nhwc(h)
    return h, res_stack


def run_mid_block(mid: UNetBlock, h: torch.Tensor, temb: torch.Tensor,
                  context: torch.Tensor, segment: Segment = None) -> torch.Tensor:
    return _run(segment, functools.partial(_mid, mid, segment=segment), h, temb, context)


class UNet2DCondition(nn.Module):
    """`conv_quant` ("none", "int8" or "int8:<scopes>", quant/int8.py) puts
    the in-scope convs on the int8 path: the resnets' (and shortcuts'),
    the samplers' and, under "stem", conv_in; conv_out always stays float."""

    def __init__(self, config: UNetConfig, attn_backend: str = "auto",
                 conv_quant: str = "none"):
        super().__init__()
        cfg = self.config = config
        self.attn_backend, self.conv_quant = attn_backend, conv_quant
        self.tp_group, self.tp_size = None, 1  # set by parallel/tp.py
        c0 = cfg.block_out_channels[0]
        time_dim = c0 * 4
        groups = cfg.norm_num_groups
        self.conv_in = make_conv(cfg.in_channels, c0, 3,
                                 quantized="stem" in parse_scopes(conv_quant))
        self.time_embedding = TimestepEmbedding(c0, time_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, time_dim)

        self.down_blocks, self.mid_block, skip_channels = down_and_mid_blocks(
            cfg, attn_backend, conv_quant)
        ch = cfg.block_out_channels[-1]

        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(reversed(cfg.block_out_channels)):
            depths = cfg.up_block_layers(i)
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_channels.pop(), out_ch,
                                             time_dim, groups, conv_quant=conv_quant))
                ch = out_ch
            if _block_depths(depths, f"up block {i}"):
                attns = [_transformer(cfg, out_ch, cfg.num_blocks - 1 - i, d, attn_backend)
                         for d in depths]
            up = Upsample2D(out_ch, out_ch, conv_quant) if i < cfg.num_blocks - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(ch, groups, 1e-5)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                capture_features: bool = False, remat_segments: bool = False):
        """sample [B, H, W, C_in] NHWC, timesteps [B] or scalar,
        encoder_hidden_states [B, T, cross_attention_dim], added_cond (SDXL)
        {"text_embeds": [B, P], "time_ids": [B, 6]} -> [B, H, W, C_out]."""
        dtype = self.time_embedding.linear_1.weight.dtype
        temb = embed_time(self, self.config, timesteps, sample.shape[0], added_cond, dtype)
        context = encoder_hidden_states.to(dtype)
        features: Optional[Dict[str, torch.Tensor]] = {} if capture_features else None
        segment = checkpoint_segment if remat_segments else None

        h, res_stack = run_down_blocks(self.down_blocks, self.conv_in(_nchw(sample.to(dtype))),
                                       temb, context, features, segment)
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(res_stack):
                raise ValueError(
                    f"{len(down_block_additional_residuals)} down residuals "
                    f"for {len(res_stack)} skips")
            res_stack = [r + _nchw(c).to(r.dtype) for r, c in
                         zip(res_stack, down_block_additional_residuals)]

        h = run_mid_block(self.mid_block, h, temb, context, segment)
        if mid_block_additional_residual is not None:
            h = h + _nchw(mid_block_additional_residual).to(h.dtype)
        if capture_features:
            features["m"] = _nhwc(h)

        for i, block in enumerate(self.up_blocks):
            for j, resnet in enumerate(block.resnets):
                unit = functools.partial(_up_unit, resnet, block.attention(j), segment=segment)
                h = _run(segment, unit, h, res_stack.pop(), temb, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
            if capture_features:
                features[f"u{i}"] = _nhwc(h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        out = _nhwc(h)
        if capture_features:
            return out, features
        return out
