"""mT5 encoder stack, the `mt5` student text tower (port of
``pea_diffusion_tpu/models/mt5.py``): the encoder's last hidden state.

T5 specifics, as in the JAX module: RMS layer norm (fp32, no mean
subtraction, no bias, the scale applied before the cast back), a relative
position bias made by block 0's attention and shared by every block, no
1/sqrt(d) scaling of the scores, a gated-GELU feed-forward (tanh GELU).
Parameter names follow transformers' T5EncoderModel (``shared``,
``encoder.block.{i}.layer.{0,1}``, ``encoder.final_layer_norm``), so a
checkpoint loads by name. The attention is over a few dozen tokens and runs
as plain PyTorch math, as the JAX module's einsums run outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.text_encoder import T5Config


class T5LayerNorm(nn.Module):
    """RMS norm in fp32; the (upcast) scale multiplies before the cast back
    to the input's type, as in the JAX package (transformers casts first)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        dt = x.dtype
        x = x.float()
        var = (x * x).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps) * self.weight.float()).to(dt)


def relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """Bidirectional T5 bucket function (encoder), in numpy on the host."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int32) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_bias(self, t: int, device: torch.device) -> torch.Tensor:
        """[1, H, T, T] fp32 bias from the bucket table, cached per (T, device)."""
        key = (t, device)
        if key not in self._buckets:
            cfg = self.cfg
            table = relative_position_bucket(
                np.arange(t)[None, :] - np.arange(t)[:, None],
                cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)
            self._buckets[key] = torch.as_tensor(table, dtype=torch.long, device=device)
        emb = self.relative_attention_bias(self._buckets[key]).float()  # [T, T, H]
        return emb.permute(2, 0, 1)[None]

    def forward(self, x, attn_bias, pos_bias: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, t, _ = x.shape

        def split(y):
            return y.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        if hasattr(self, "relative_attention_bias"):
            pos_bias = self.position_bias(t, x.device)
        p = torch.softmax(s + pos_bias + attn_bias, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return self.o(o.transpose(1, 2).reshape(b, t, -1)), pos_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, attn_bias, pos_bias):
        att, ff = self.layer
        a, pos_bias = att.SelfAttention(att.layer_norm(x), attn_bias, pos_bias)
        x = x + a
        return x + ff.DenseReluDense(ff.layer_norm(x)), pos_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=(i == 0))
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """ids [B, T] -> the encoder's last hidden state [B, T, d_model]."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).long()
        x = self.shared(input_ids)
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                                torch.finfo(torch.float32).min)
        pos_bias = None
        for block in self.encoder.block:
            x, pos_bias = block(x, attn_bias, pos_bias)
        return self.encoder.final_layer_norm(x)
