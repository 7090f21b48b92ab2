from .factory import build_models
from .sampling import make_sampler, rescale_noise_cfg
from .text2image import (PEAModels, StableDiffusionXLPEAPipeline, cfg_combine,
                         decode_latents, denoise_loop, encode_prompt_sdxl,
                         generate_sdxl, make_add_time_ids, to_pil)

__all__ = [
    "build_models", "make_sampler", "rescale_noise_cfg", "PEAModels",
    "StableDiffusionXLPEAPipeline", "cfg_combine", "decode_latents",
    "denoise_loop", "encode_prompt_sdxl", "generate_sdxl",
    "make_add_time_ids", "to_pil",
]
