from .adapter import PEAAdapter
from .bert_text import BertTextEncoder, ConcatTextEncoder
from .clip_text import CLIPTextEncoder
from .controlnet import ControlNet
from .mt5 import T5Encoder
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = ["PEAAdapter", "BertTextEncoder", "CLIPTextEncoder", "ConcatTextEncoder",
           "ControlNet", "T5Encoder", "UNet2DCondition", "AutoencoderKL"]
