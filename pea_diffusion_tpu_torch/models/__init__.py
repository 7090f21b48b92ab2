from .adapter import PEAAdapter
from .bert_text import BertTextEncoder
from .clip_text import CLIPTextEncoder
from .controlnet import ControlNet
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = ["PEAAdapter", "BertTextEncoder", "CLIPTextEncoder", "ControlNet",
           "UNet2DCondition", "AutoencoderKL"]
