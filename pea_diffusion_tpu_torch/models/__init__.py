from .adapter import PEAAdapter
from .bert_text import BertTextEncoder
from .clip_text import CLIPTextEncoder
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = ["PEAAdapter", "BertTextEncoder", "CLIPTextEncoder", "UNet2DCondition",
           "AutoencoderKL"]
