"""Plain fp32 PyTorch reference of the SDXL ControlNet path: diffusers'
``ControlNetModel`` (the conditioning embedder, a copy of the UNet's down and
mid blocks fed by conv_in's output plus the embedded control map, a 1x1
"zero" conv on every skip and on the mid output, the residuals times the
conditioning scale) and the UNet's forward with those residuals added to
every skip and to the mid block's output, as ``UNet2DConditionModel`` adds
``down_block_additional_residuals`` and ``mid_block_additional_residual``.

Independent of the program under test: it imports only torch,
``reference/models.py`` (whose blocks it builds from) and the weights'
rule (``benchmark/weights.py``). Parameter names are
diffusers' (``controlnet_cond_embedding.*``, ``controlnet_down_blocks.*``,
``controlnet_mid_block``), the names the port's ControlNet carries, so one
state dict fills both. Tensors are NHWC at the public functions.

Departures from diffusers: stride-2 convolutions pad 1 on each side (as
``reference/models.py``, and as diffusers' ControlNet with its
``downsample_padding`` 1); the conditioning scale may be one a row ([B]),
where diffusers takes one number; guess mode and global pooling are not
written (the benchmark's cell runs neither).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import weights
from . import models as ref

# the ControlNet's generator stream, apart from those of weights.SALT's components
SALT = 32


class ConditioningEmbedding(nn.Module):
    """The control map in [0, 1] to conv_in's width: a 3x3 conv, then per
    stage a 3x3 conv and a stride-2 3x3 conv, SiLU after each, and a 3x3
    output conv (zero-initialised in diffusers)."""

    def __init__(self, cin: int, channels: Sequence[int], cout: int):
        super().__init__()
        self.conv_in = ref.conv(cin, channels[0], 3)
        blocks = []
        for a, b in zip(channels[:-1], channels[1:]):
            blocks += [ref.conv(a, a, 3), ref.conv(a, b, 3, stride=2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = ref.conv(channels[-1], cout, 3)

    def forward(self, x):
        h = F.silu(self.conv_in(x))
        for c in self.blocks:
            h = F.silu(c(h))
        return self.conv_out(h)


def _temb(model: nn.Module, s: ref.UNetSpec, timesteps, added, dt):
    """The time embedding of a UNet or ControlNet `model` (reference/
    models.py's UNet.forward's, SDXL's added conditioning included)."""
    temb = model.time_embedding(
        ref.timestep_embedding(timesteps, s.blocks[0], s.flip, s.shift).to(dt))
    if s.added == "text_time":
        ids = added["time_ids"]
        t_emb = ref.timestep_embedding(ids.reshape(-1), s.added_time_dim, s.flip,
                                       s.shift).reshape(ids.shape[0], -1)
        temb = temb + model.add_embedding(
            torch.cat([added["text_embeds"].to(dt), t_emb.to(dt)], -1))
    return temb


def _down(blocks, h, temb, context) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    stack = [h]
    for block in blocks:
        for j, res in enumerate(block.resnets):
            h = res(h, temb)
            if block.attn(j) is not None:
                h = block.attn(j)(h, context)
            stack.append(h)
        if hasattr(block, "downsamplers"):
            h = block.downsamplers[0](h)
            stack.append(h)
    return h, stack


def _mid(mid, h, temb, context):
    h = mid.resnets[0](h, temb)
    if mid.attn(0) is not None:
        h = mid.attn(0)(h, context)
    return mid.resnets[1](h, temb)


class ControlNet(nn.Module):
    """A diffusers ControlNetModel config.json -> the module: sample
    [B, h, w, 4], timesteps [B], context [B, T, D], the control map
    [B, 8h, 8w, 3] in [0, 1], the scale (a number or [B]) and SDXL's added
    conditioning -> (the down residuals, one [B, h', w', C] a UNet skip;
    the mid residual)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        cfg = dict(cfg, out_channels=cfg.get("in_channels", 4))  # no output head
        s = self.spec = ref.UNetSpec(cfg)
        c0, g = s.blocks[0], s.groups
        temb = 4 * c0
        self.conv_in = ref.conv(s.in_channels, c0, 3)
        self.time_embedding = ref.TimestepEmbedding(c0, temb)
        if s.added == "text_time":
            self.add_embedding = ref.TimestepEmbedding(s.added_in, temb)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            cfg.get("conditioning_channels", 3),
            cfg.get("conditioning_embedding_out_channels", (16, 32, 96, 256)), c0)

        def tr(ch, level, depth):
            return ref.Transformer2D(ch, s.heads[level], depth, s.context_dim, g, s.linear)

        skips, ch = [c0], c0
        self.down_blocks = nn.ModuleList()
        for i, out in enumerate(s.blocks):
            res, att = [], []
            for _ in range(s.lpb):
                res.append(ref.Resnet(ch, out, temb, g))
                ch = out
                skips.append(ch)
                if s.depth[i]:
                    att.append(tr(out, i, s.depth[i]))
            down = None
            if i < len(s.blocks) - 1:
                down = ref.Sampler(out, up=False)
                skips.append(ch)
            self.down_blocks.append(ref.Block(res, att, down=down))
        self.mid_block = ref.Block(
            [ref.Resnet(ch, ch, temb, g), ref.Resnet(ch, ch, temb, g)],
            [tr(ch, len(s.blocks) - 1, s.mid_depth)] if s.mid_depth else ())
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skips])
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def forward(self, sample, timesteps, context, cond, scale, added=None):
        dt = self.conv_in.weight.dtype
        temb = _temb(self, self.spec, timesteps, added, dt)
        context = context.to(dt)
        h = self.conv_in(sample.to(dt).permute(0, 3, 1, 2))
        h = h + self.controlnet_cond_embedding(cond.to(dt).permute(0, 3, 1, 2))
        h, stack = _down(self.down_blocks, h, temb, context)
        h = _mid(self.mid_block, h, temb, context)
        scale = torch.as_tensor(scale, dtype=dt, device=h.device)
        if scale.ndim:  # one a row
            scale = scale.reshape(-1, 1, 1, 1)
        down = [(c(r) * scale).permute(0, 2, 3, 1)
                for c, r in zip(self.controlnet_down_blocks, stack)]
        return down, (self.controlnet_mid_block(h) * scale).permute(0, 2, 3, 1)


def unet_with_residuals(unet: ref.UNet, sample, timesteps, context, added,
                        down: Sequence[torch.Tensor], mid: torch.Tensor):
    """reference/models.py's UNet forward with the ControlNet's residuals
    (NHWC) added to every skip the down path leaves and to the mid block's
    output -> [B, H, W, C]."""
    s = unet.spec
    dt = unet.conv_in.weight.dtype
    temb = _temb(unet, s, timesteps, added, dt)
    context = context.to(dt)
    h, stack = _down(unet.down_blocks, unet.conv_in(sample.to(dt).permute(0, 3, 1, 2)),
                     temb, context)
    if len(down) != len(stack):
        raise ValueError(f"{len(down)} down residuals for {len(stack)} skips")
    stack = [r + d.to(dt).permute(0, 3, 1, 2) for r, d in zip(stack, down)]
    h = _mid(unet.mid_block, h, temb, context) + mid.to(dt).permute(0, 3, 1, 2)
    for block in unet.up_blocks:
        for j, res in enumerate(block.resnets):
            h = res(torch.cat([h, stack.pop()], dim=1), temb)
            if block.attn(j) is not None:
                h = block.attn(j)(h, context)
        if hasattr(block, "upsamplers"):
            h = block.upsamplers[0](h)
    return unet.conv_out(unet.conv_norm_out(h)).permute(0, 2, 3, 1)


def build(cfg: Dict, device="meta") -> ControlNet:
    with torch.device(device):
        return ControlNet(cfg)


def controlnet_state(seed: int, cfg: Dict, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    """The ControlNet's weights from the run's seed, by the rule of
    benchmark/weights.py (every weight N(0, 0.02) from one generator and one
    ``randn`` call, norm weights 1, biases 0), in the layout of `build`: the
    zero convs' weights are drawn too, so that the residuals are not zeros."""
    layout = ref.parameter_layout(build(cfg))
    n = sum(math.prod(shape) for _, shape, fill in layout if fill == "normal")
    gen = torch.Generator(device=device).manual_seed((int(seed) * 64 + SALT) % (2 ** 63))
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype).mul_(0.02)
    out, off = {}, 0
    for name, shape, fill in layout:
        if fill == "normal":
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).clone()
            off += k
        else:
            out[name] = torch.full(shape, 1.0 if fill == "one" else 0.0, dtype=dtype,
                                   device=device)
    return out


def reference_controlnet(config: Dict, seed: int, device,
                         dtype: torch.dtype = torch.float32) -> ControlNet:
    """The reference ControlNet holding the run's weights (made in the
    configuration's served type, then cast to `dtype`), for inference."""
    comp = config["components"]["controlnet"]
    state = controlnet_state(seed, comp["config"], weights.DTYPES[comp["weights_dtype"]],
                             device)
    module = build(comp["config"])
    module.load_state_dict({k: v.to(dtype) for k, v in state.items()}, assign=True)
    return module.eval().requires_grad_(False)
