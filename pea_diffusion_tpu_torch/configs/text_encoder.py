"""Text-encoder configurations (the port's own copy of the JAX package's
``configs/text_encoder.py`` for the towers this port runs): the BERT-family
student (Chinese-CLIP RoBERTa) and the CLIP-family SDXL teachers."""
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
    # state to this dim
    project_dim: Optional[int] = None


# Chinese-CLIP ViT-H/14 text tower (RoBERTa-wwm-ext-large-chinese)
CHINESE_CLIP_LARGE = BertTextConfig()
BERT_TINY = BertTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128,
)
