from .adapter import ADAPTER_PRESETS, AdapterConfig
from .text_encoder import (BERT_TINY, CHINESE_CLIP_LARGE, CLIP_BIG_G, CLIP_TINY,
                           CLIP_VIT_L, BertTextConfig, CLIPTextConfig)
from .train import TrainConfig
from .unet import (SD15_UNET, SD15_UNET_TINY, SD15_VAE, SDXL_UNET, SDXL_UNET_TINY,
                   SDXL_VAE, VAE_TINY, ControlNetConfig, UNetConfig, VAEConfig)

__all__ = [
    "ADAPTER_PRESETS", "AdapterConfig",
    "BERT_TINY", "CHINESE_CLIP_LARGE", "BertTextConfig",
    "CLIP_BIG_G", "CLIP_TINY", "CLIP_VIT_L", "CLIPTextConfig",
    "TrainConfig",
    "SD15_UNET", "SD15_UNET_TINY", "SD15_VAE",
    "SDXL_UNET", "SDXL_UNET_TINY", "SDXL_VAE", "VAE_TINY", "ControlNetConfig",
    "UNetConfig", "VAEConfig",
]
