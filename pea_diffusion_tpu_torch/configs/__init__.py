from .adapter import ADAPTER_PRESETS, AdapterConfig
from .text_encoder import (ALT_CLIP_XLMR_L, BERT_TINY, CHINESE_CLIP_LARGE, CLIP_BIG_G,
                           CLIP_TINY, CLIP_VIT_L, MT5_XL, T5_TINY, XLM_ROBERTA_LARGE,
                           BertTextConfig, CLIPTextConfig, T5Config)
from .train import DataConfig, TrainConfig
from .unet import (SD15_UNET, SD15_UNET_TINY, SD15_VAE, SD21_UNET, SDXL_INPAINT_UNET,
                   SDXL_REFINER_UNET, SDXL_UNET, SDXL_UNET_TINY, SDXL_VAE, SSD_1B_UNET,
                   VAE_TINY, ControlNetConfig, UNetConfig, VAEConfig)

__all__ = [
    "ADAPTER_PRESETS", "AdapterConfig",
    "ALT_CLIP_XLMR_L", "BERT_TINY", "CHINESE_CLIP_LARGE", "XLM_ROBERTA_LARGE",
    "BertTextConfig", "MT5_XL", "T5_TINY", "T5Config",
    "CLIP_BIG_G", "CLIP_TINY", "CLIP_VIT_L", "CLIPTextConfig",
    "DataConfig", "TrainConfig",
    "SD15_UNET", "SD15_UNET_TINY", "SD15_VAE",
    "SDXL_UNET", "SDXL_UNET_TINY", "SDXL_VAE", "VAE_TINY", "ControlNetConfig",
    "SD21_UNET", "SDXL_INPAINT_UNET", "SDXL_REFINER_UNET", "SSD_1B_UNET",
    "UNetConfig", "VAEConfig",
]
