"""Text-encoder configurations (the port's own copy of the JAX package's
``configs/text_encoder.py``, field for field) for every tower the port runs:

- CLIP-family causal transformers: the SD / SDXL teachers (CLIP ViT-L,
  OpenCLIP ViT-bigG) -> :class:`CLIPTextConfig`;
- BERT-family bidirectional students: Chinese-CLIP (RoBERTa-wwm-large),
  XLM-R large (open_clip's multilingual tower), AltCLIP -> :class:`BertTextConfig`;
- the mT5 encoder stack -> :class:`T5Config`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # bigG uses "gelu"
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # bigG text_projection -> 1280
    layer_norm_eps: float = 1e-5


# SD1.5 / SDXL text_encoder (openai CLIP ViT-L/14 text tower)
CLIP_VIT_L = CLIPTextConfig()
# SDXL text_encoder_2 (laion OpenCLIP ViT-bigG/14 text tower)
CLIP_BIG_G = CLIPTextConfig(
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    intermediate_size=5120,
    hidden_act="gelu",
    projection_dim=1280,
)
CLIP_TINY = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, projection_dim=64,
)


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 21128  # Chinese-CLIP RoBERTa-wwm vocab
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    pad_token_id: int = 0
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    # position ids start at pad+1 and skip padding positions (XLM-R style)
    roberta_position_ids: bool = False
    # AltCLIP head: pre_LN + linear "transformation" projecting every token
    # state to this dim (HF AltCLIPTextModel's last_hidden_state)
    project_dim: Optional[int] = None


# Chinese-CLIP ViT-H/14 text tower (RoBERTa-wwm-ext-large-chinese)
CHINESE_CLIP_LARGE = BertTextConfig()
# XLM-R large (open_clip xlm-roberta-large-ViT-H-14 text tower)
XLM_ROBERTA_LARGE = BertTextConfig(
    vocab_size=250002,
    max_position_embeddings=514,
    type_vocab_size=1,
    pad_token_id=1,
    layer_norm_eps=1e-5,
    roberta_position_ids=True,
)
# AltCLIP-XLMR-L text model (XLM-R large + pre_LN + 1024->768 transformation)
ALT_CLIP_XLMR_L = BertTextConfig(
    vocab_size=250002,
    max_position_embeddings=514,
    type_vocab_size=1,
    pad_token_id=1,
    layer_norm_eps=1e-5,
    roberta_position_ids=True,
    project_dim=768,
)
BERT_TINY = BertTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 250112  # mT5
    d_model: int = 2048  # mt5-xl
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    pad_token_id: int = 0


MT5_XL = T5Config()
T5_TINY = T5Config(
    vocab_size=1000, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4
)
