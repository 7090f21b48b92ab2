from .from_jax import (adapter_state_dict, bert_text_state_dict, clip_text_state_dict,
                       unet_state_dict, vae_state_dict)

__all__ = ["adapter_state_dict", "bert_text_state_dict", "clip_text_state_dict",
           "unet_state_dict", "vae_state_dict"]
