from .controlnet import (StableDiffusionXLControlNetPEAPipeline, canny_edges,
                         generate_sdxl_controlnet, keep_schedule, prepare_control_image)
from .factory import build_controlnet, build_models, build_unet, with_text_tower, with_unet
from .inpaint import (denoising_start_index, generate_sdxl_inpaint, mask_to_latents,
                      preprocess_image, preprocess_mask, strength_start)
from .sampling import make_sampler, rescale_noise_cfg
from .text2image import (PEAModels, StableDiffusionPEAPipeline,
                         StableDiffusionXLPEAPipeline, as_ids, cfg_combine, decode_latents,
                         denoise_loop, encode_prompt_sd, encode_prompt_sdxl,
                         encode_vae_image, generate_sd, generate_sdxl,
                         generate_sdxl_ensemble, ids_batch_size, make_add_time_ids, refine_sdxl,
                         steps_at_or_above, timestep_cutoff, to_pil)

__all__ = [
    "StableDiffusionXLControlNetPEAPipeline", "canny_edges", "generate_sdxl_controlnet",
    "keep_schedule", "prepare_control_image",
    "build_controlnet", "build_models", "build_unet", "with_text_tower", "with_unet",
    "denoising_start_index", "generate_sdxl_inpaint",
    "mask_to_latents", "preprocess_image", "preprocess_mask", "strength_start",
    "make_sampler", "rescale_noise_cfg", "PEAModels",
    "StableDiffusionPEAPipeline", "StableDiffusionXLPEAPipeline", "as_ids", "cfg_combine",
    "decode_latents", "denoise_loop", "encode_prompt_sd", "encode_prompt_sdxl",
    "encode_vae_image", "generate_sd", "generate_sdxl", "generate_sdxl_ensemble",
    "ids_batch_size",
    "make_add_time_ids", "refine_sdxl", "steps_at_or_above", "timestep_cutoff", "to_pil",
]
