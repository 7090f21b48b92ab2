"""Int8 post-training quantization (port of ``pea_diffusion_tpu/quant``)."""
from .int8 import (  # noqa: F401
    QConvInt8,
    VAE_DECODER_CONV_QUANT,
    calibrate_conv_ranges,
    calibrate_sdxl,
    calibrate_vae_decoder,
    load_ranges,
    merge_ranges,
    parse_scopes,
    per_conv_sqnr,
    quantize_for_serving,
    quantize_unet_params,
    quantize_vae_decoder_params,
    save_ranges,
    quantize_weight,
)
