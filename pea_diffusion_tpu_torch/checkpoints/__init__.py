from .from_jax import (adapter_state_dict, bert_text_state_dict, clip_text_state_dict,
                       clip_vision_state_dict, mul_zh_state_dict, t5_encoder_state_dict, unet_state_dict,
                       vae_state_dict)
from .lora import merge_lora_into_state_dict
from .orbax_io import export_adapter, import_adapter
from .safetensors_io import load_safetensors, load_safetensors_torch, save_safetensors

__all__ = ["adapter_state_dict", "bert_text_state_dict", "clip_text_state_dict",
           "clip_vision_state_dict",
           "mul_zh_state_dict", "t5_encoder_state_dict",
           "unet_state_dict", "vae_state_dict", "merge_lora_into_state_dict",
           "export_adapter", "import_adapter", "load_safetensors", "load_safetensors_torch",
           "save_safetensors"]
