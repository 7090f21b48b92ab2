"""BERT-family text-encoder configuration (the port's own copy of the JAX
package's ``configs/text_encoder.py`` for the towers this port runs)."""
from __future__ import annotations

import dataclasses
from typing import Optional


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
