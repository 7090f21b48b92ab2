from .adapter import ADAPTER_PRESETS, AdapterConfig
from .text_encoder import BERT_TINY, CHINESE_CLIP_LARGE, BertTextConfig
from .unet import (SDXL_UNET, SDXL_UNET_TINY, SDXL_VAE, VAE_TINY, UNetConfig,
                   VAEConfig)

__all__ = [
    "ADAPTER_PRESETS", "AdapterConfig",
    "BERT_TINY", "CHINESE_CLIP_LARGE", "BertTextConfig",
    "SDXL_UNET", "SDXL_UNET_TINY", "SDXL_VAE", "VAE_TINY", "UNetConfig",
    "VAEConfig",
]
