"""PEA adapter (port of ``pea_diffusion_tpu/models/adapter.py``): a small MLP
that projects token states of a non-English text encoder into the
conditioning space of a frozen SD/SDXL UNet. Covers every variant through
:class:`AdapterConfig`.

Parameters are fp32 (they carry the only gradients in KD training); the
computation runs in `dtype` (bfloat16 in the full pipeline), as the JAX
module computes in its `dtype`. Parameter names are the reference's
(`layernorm`, `projector.{0,2,4,...}`, `fc`).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.adapter import AdapterConfig


def _linear(x, layer: nn.Linear, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


class PEAAdapter(nn.Module):
    def __init__(self, config: AdapterConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.layernorm = nn.LayerNorm(config.in_dim, eps=config.layernorm_eps)
        layers, prev = [], config.in_dim
        for i, dim in enumerate(config.projector_dims):
            if i > 0:
                layers.append(nn.GELU())
            layers.append(nn.Linear(prev, dim, bias=config.projector_bias))
            prev = dim
        self.projector = nn.Sequential(*layers)
        self.fc = None if config.head_dim is None else nn.Linear(prev, config.head_dim)

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: [B, T, in_dim] token states. Returns ``(pooled [B, P], seq
        [B, T, head_dim])`` when the config has a head (SDXL), else ``seq``."""
        cfg = self.config
        residual = x
        ln = self.layernorm
        h = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                         ln.bias.float(), ln.eps).to(self.dtype)
        for layer in self.projector:
            h = _linear(h, layer, self.dtype) if isinstance(layer, nn.Linear) \
                else F.gelu(h)
        if self.fc is None:
            if cfg.use_residual:
                h = h + residual
            return h
        seq = _linear(F.gelu(h), self.fc, self.dtype)
        if cfg.use_residual:
            h = h + residual
        return h.mean(dim=1), seq
