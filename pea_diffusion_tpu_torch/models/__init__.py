from .adapter import PEAAdapter
from .bert_text import BertTextEncoder
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = ["PEAAdapter", "BertTextEncoder", "UNet2DCondition", "AutoencoderKL"]
