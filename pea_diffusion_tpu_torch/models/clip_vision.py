"""CLIP vision towers (ViT) for evaluation (port of
``pea_diffusion_tpu/models/clip_vision.py``): CLIP-score and CLIP-FID with
Chinese-CLIP's ViT-H/14 or OpenAI CLIP's ViT-L/14 image encoder.

A pre-LN ViT with a class token, learned position embeddings and a
projected pooled output. It takes NHWC pixel values (CLIP mean/std
normalized), as the JAX module does. Parameter names follow transformers'
CLIPVisionModelWithProjection without the ``vision_model.`` prefix
(``pre_layrnorm`` with transformers' spelling), so the JAX package's
``convert_clip_vision`` maps the state dict back. The attention is over 257
tokens at ViT-H/14 and runs as plain PyTorch math (fp32 scores), as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.attention import xla_attention
from .clip_text import CLIPMLP
from .layers import LayerNormFP32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280  # ViT-H/14
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    hidden_act: str = "quick_gelu"  # Chinese-CLIP's ViT-H uses quick_gelu
    projection_dim: Optional[int] = 1024
    layer_norm_eps: float = 1e-5


CHINESE_CLIP_VIT_H = CLIPVisionConfig()
CLIP_VIT_L_VISION = CLIPVisionConfig(
    hidden_size=1024, num_layers=24, intermediate_size=4096,
    projection_dim=768)
CLIP_VISION_TINY = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, projection_dim=48)


class CLIPVisionOutput(NamedTuple):
    last_hidden_state: torch.Tensor   # [B, 1+P, H] (before the post-LN)
    pooled: torch.Tensor              # [B, H] (post-LN class token)
    projected: Optional[torch.Tensor]  # [B, projection_dim]


class ViTAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x):
        b, t, hidden = x.shape
        d = hidden // self.num_heads

        def split(y):  # [B, T, H*D] -> head-major [B*H, T, D]
            return y.reshape(b, t, self.num_heads, d).transpose(1, 2).reshape(-1, t, d)

        o = xla_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                          split(self.v_proj(x)), d ** -0.5)
        return self.out_proj(o.reshape(b, self.num_heads, t, d).transpose(1, 2)
                             .reshape(b, t, hidden))


class ViTLayer(nn.Module):
    """LN -> self-attention, LN -> MLP, pre-norm residuals."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = ViTAttention(cfg)
        self.layer_norm2 = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        h, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(h))
        self.patch_embedding = nn.Conv2d(3, h, kernel_size=p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, h)


class CLIPVisionEncoderLayers(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([ViTLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPVisionEncoder(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = self.config = config
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPVisionEncoderLayers(cfg)
        self.post_layernorm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.visual_projection = (None if cfg.projection_dim is None else
                                  nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False))

    def forward(self, pixel_values: torch.Tensor) -> CLIPVisionOutput:
        """pixel_values: [B, H, W, 3] normalized with the CLIP mean/std."""
        emb = self.embeddings
        dt = emb.patch_embedding.weight.dtype
        patches = emb.patch_embedding(pixel_values.to(dt).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)  # [B, P, H], patches row-major
        cls = emb.class_embedding.to(dt)[None, None].expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding.weight[:x.shape[1]][None].to(dt)
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        pooled = self.post_layernorm(x[:, 0])
        projected = None if self.visual_projection is None else self.visual_projection(pooled)
        return CLIPVisionOutput(x, pooled, projected)


# CLIP preprocessing constants (OpenAI / Chinese-CLIP)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(images, image_size: int = 224):
    """uint8 or float [B, H, W, 3] -> normalized [B, S, S, 3] numpy (PIL
    bicubic resize), as the JAX package computes it: float32 pixels over the
    float64 constants give float64, which the callers cast to float32."""
    import numpy as np
    from PIL import Image

    out = []
    for img in np.asarray(images):
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        pil = Image.fromarray(img).resize((image_size, image_size),
                                          resample=Image.BICUBIC)
        out.append(np.asarray(pil, np.float32) / 255.0)
    arr = np.stack(out)
    return (arr - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
