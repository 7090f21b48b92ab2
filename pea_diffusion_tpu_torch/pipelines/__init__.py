from .controlnet import (canny_edges, generate_sdxl_controlnet, keep_schedule,
                         prepare_control_image)
from .factory import build_controlnet, build_models
from .sampling import make_sampler, rescale_noise_cfg
from .text2image import (PEAModels, StableDiffusionPEAPipeline,
                         StableDiffusionXLPEAPipeline, cfg_combine, decode_latents,
                         denoise_loop, encode_prompt_sd, encode_prompt_sdxl,
                         generate_sd, generate_sdxl, make_add_time_ids, to_pil)

__all__ = [
    "canny_edges", "generate_sdxl_controlnet", "keep_schedule", "prepare_control_image",
    "build_controlnet", "build_models", "make_sampler", "rescale_noise_cfg", "PEAModels",
    "StableDiffusionPEAPipeline", "StableDiffusionXLPEAPipeline", "cfg_combine",
    "decode_latents", "denoise_loop", "encode_prompt_sd", "encode_prompt_sdxl",
    "generate_sd", "generate_sdxl", "make_add_time_ids", "to_pil",
]
