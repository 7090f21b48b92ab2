"""CLIP-family causal text encoders (port of
``pea_diffusion_tpu/models/clip_text.py``): the SDXL teacher pair, CLIP
ViT-L/14 and OpenCLIP ViT-bigG (with its text projection).

Returns the last hidden state (after the final LayerNorm), the penultimate
one (the input of the last layer, without the final LayerNorm: SDXL's
``hidden_states[-2]``), the pooled state of the first eos token and its
projection. Parameter names follow transformers' CLIPTextModel (without the
``text_model.`` prefix) and CLIPTextModelWithProjection's
``text_projection``, so the JAX package's ``convert_clip_text`` maps the
state dict back. The attention is over 77 tokens and runs as plain PyTorch
math, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.text_encoder import CLIPTextConfig
from .layers import LayerNormFP32


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor          # [B, T, H] (after final LN)
    penultimate_hidden_state: torch.Tensor   # [B, T, H] (no final LN)
    pooled: torch.Tensor                     # [B, H] eos-token state
    projected: Optional[torch.Tensor]        # [B, P] pooled @ text_projection


def quick_gelu(x):
    """CLIP's sigmoid approximation of GELU, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x, causal):
        b, t, hidden = x.shape
        d = hidden // self.num_heads

        def split(y):
            return y.reshape(b, t, self.num_heads, d).transpose(1, 2)

        q = split(self.q_proj(x)) * (d ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        s = torch.where(causal, s, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, hidden))


class CLIPMLP(nn.Module):
    """fc1 -> quick_gelu or exact GELU (`cfg.hidden_act`) -> fc2; the text
    and the vision towers share it."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = LayerNormFP32(config.hidden_size, config.layer_norm_eps)
        self.text_projection = (None if config.projection_dim is None else
                                nn.Linear(config.hidden_size, config.projection_dim,
                                          bias=False))

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        cfg = self.config
        b, t = input_ids.shape
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:t][None]
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=input_ids.device))[None, None]
        penultimate = x
        for i, layer in enumerate(self.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        last = self.final_layer_norm(x)
        eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos]
        projected = None if self.text_projection is None else self.text_projection(pooled)
        return CLIPTextOutput(last, penultimate, pooled, projected)
