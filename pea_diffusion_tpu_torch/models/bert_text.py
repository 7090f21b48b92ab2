"""BERT-family bidirectional text encoder (port of
``pea_diffusion_tpu/models/bert_text.py``): the Chinese-CLIP RoBERTa-wwm-large
tower of the main path. Post-LN encoder with absolute positions; parameter
names follow transformers' BertModel. Its attention is over a few dozen
tokens and runs as plain PyTorch math.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.text_encoder import BertTextConfig
from .layers import LayerNormFP32


class BertTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # [B, T, H]
    pooled: torch.Tensor             # [B, H] (CLS state, no pooler dense)
    # AltCLIP head output: transformation(pre_LN(hidden)) [B, T, project_dim]
    projected: Optional[torch.Tensor] = None


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, attn_bias):
        b, t, hidden = x.shape
        d = hidden // self.num_heads

        def split(y):
            return y.reshape(b, t, self.num_heads, d).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
        p = torch.softmax(s + attn_bias, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return o.transpose(1, 2).reshape(b, t, hidden)


class BertDense(nn.Module):
    """A dense layer, optionally followed by a residual LayerNorm."""

    def __init__(self, d_in: int, d_out: int, eps: Optional[float] = None):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if eps is not None:
            self.LayerNorm = LayerNormFP32(d_out, eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDense(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertDense(cfg.hidden_size, cfg.intermediate_size)
        self.output = BertDense(cfg.intermediate_size, cfg.hidden_size,
                                cfg.layer_norm_eps)

    def forward(self, x, attn_bias):
        att = self.attention
        a = att.output.dense(att.self(x, attn_bias))
        x = att.output.LayerNorm(x + a)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_layers)])


class BertTextEncoder(nn.Module):
    def __init__(self, config: BertTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        if config.project_dim is not None:
            self.pre_LN = LayerNormFP32(config.hidden_size, config.layer_norm_eps)
            self.transformation = nn.Linear(config.hidden_size, config.project_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> BertTextOutput:
        cfg = self.config
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).long()
        if cfg.roberta_position_ids:
            # positions count only non-pad tokens, offset past the pad id
            pos_ids = (torch.cumsum(attention_mask, dim=-1) * attention_mask
                       + cfg.pad_token_id)
        else:
            pos_ids = torch.arange(t, device=input_ids.device).expand(b, t)
        emb = self.embeddings
        x = (emb.word_embeddings(input_ids) + emb.position_embeddings(pos_ids)
             + emb.token_type_embeddings(torch.zeros_like(input_ids)))
        x = emb.LayerNorm(x)
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                                torch.finfo(torch.float32).min)
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        projected = None
        if cfg.project_dim is not None:
            projected = self.transformation(self.pre_LN(x))
        return BertTextOutput(last_hidden_state=x, pooled=x[:, 0],
                              projected=projected)
