"""The ControlNet's share of the yardstick's arithmetic (roofline.py holds
the UNet's): the attention cores of one ControlNet forward from the
configuration's shapes, and the model FLOPs of a served ControlNet image,
counted over the plain reference on the meta device."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import roofline
from .reference import controlnet
from .reference import models as ref


def controlnet_attention(cn_cfg: Dict, latent_h: int, latent_w: int,
                         context: int) -> List[roofline.Call]:
    """Every attention core of one ControlNet forward for one sample, in
    order: the down path's and the mid block's (a UNet's without its up
    path)."""
    s = ref.UNetSpec(dict(cn_cfg, out_channels=cn_cfg.get("in_channels", 4)))
    n = len(s.blocks)
    calls: List[roofline.Call] = []

    def blocks(level: int, depth: int):
        hw = (latent_h >> level) * (latent_w >> level)
        d = s.blocks[level] // s.heads[level]
        for _ in range(depth):
            calls.append((hw, hw, s.heads[level], d, False))
            calls.append((hw, context, s.heads[level], d, False))

    for i in range(n):
        for _ in range(s.lpb if s.depth[i] else 0):
            blocks(i, s.depth[i])
    if s.mid_depth:
        blocks(n - 1, s.mid_depth)
    return calls


def serve_flops_per_image(config: Dict, traffic: Dict) -> float:
    """Model FLOPs of one served ControlNet image: roofline.py's (the
    prompts, `steps` UNet forwards of the CFG pair, one decode) and
    `steps` ControlNet forwards of the pair, the embedder over the map
    included."""
    comp = config["components"]
    size, steps, t = traffic["size"], traffic["steps"], traffic["max_length"]
    lat = size // 8
    cn = controlnet.build(comp["controlnet"]["config"])
    meta = torch.device("meta")
    s = cn.spec
    pooled = s.added_in - 6 * s.added_time_dim

    def pair():
        cn(torch.zeros((2, lat, lat, 4), device=meta),
           torch.zeros((2,), dtype=torch.long, device=meta),
           torch.zeros((2, t, s.context_dim), device=meta),
           torch.zeros((2, size, size, 3), device=meta), 1.0,
           {"text_embeds": torch.zeros((2, pooled), device=meta),
            "time_ids": torch.zeros((2, 6), device=meta)})

    with torch.no_grad():
        return roofline.serve_flops_per_image(config, traffic) + steps * roofline._count(pair)
