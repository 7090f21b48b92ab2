"""Text-to-image CLI of the PyTorch port.

--demo runs a tiny random-weight SDXL-architecture stack; --demo-full runs
the full-size SDXL stack (Chinese-CLIP RoBERTa-large, the sdxl_chinese_clip
adapter, the SDXL UNet and VAE in bf16) with random weights made on the
device: real shapes and kernels, meaningless pixels. Loading real
checkpoints is not ported yet (ROADMAP Queue A item 9).

Usage:
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo-full --sampler ddim --steps 4 -o out.png
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def make_tokenizer(vocab_size: int, length: int):
    """Demo tokenizer: one id per character, the same in every process
    (the code point folded into the vocab), padded with id 4."""

    def tokenize(texts):
        out = np.full((len(texts), length), 4, np.int64)
        for i, t in enumerate(texts):
            ids = [(ord(c) % (vocab_size - 5)) + 5 for c in t[:length]]
            out[i, :len(ids)] = ids
        return out

    return tokenize


def build_demo(device="cuda"):
    """Tiny random-weight SDXL-architecture stack in fp32."""
    from ..configs.adapter import AdapterConfig
    from ..configs.text_encoder import BERT_TINY
    from ..configs.unet import SDXL_UNET_TINY, VAE_TINY
    from ..pipelines.factory import build_models

    ucfg = SDXL_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    adapter_cfg = AdapterConfig(BERT_TINY.hidden_size, (96, pooled),
                                head_dim=ucfg.cross_attention_dim)
    models = build_models(family="chinese_clip", text_cfg=BERT_TINY,
                          adapter_cfg=adapter_cfg, unet_cfg=ucfg,
                          vae_cfg=VAE_TINY, dtype=torch.float32, device=device)
    return models, make_tokenizer(BERT_TINY.vocab_size, 16), 256


def build_demo_full(device="cuda", seed: int = 0):
    """Full-size SDXL PEA stack with random weights (the JAX package's
    `build_demo_full` and bench stack): bf16 text tower, UNet and VAE, fp32
    adapter weights, 52-token prompts."""
    from ..configs.adapter import ADAPTER_PRESETS
    from ..configs.text_encoder import CHINESE_CLIP_LARGE
    from ..configs.unet import SDXL_UNET, SDXL_VAE
    from ..pipelines.factory import build_models

    models = build_models(
        family="chinese_clip", text_cfg=CHINESE_CLIP_LARGE,
        adapter_cfg=ADAPTER_PRESETS["sdxl_chinese_clip"],
        unet_cfg=SDXL_UNET, vae_cfg=SDXL_VAE, dtype=torch.bfloat16,
        vae_dtype=torch.bfloat16, device=device, seed=seed)
    return models, make_tokenizer(CHINESE_CLIP_LARGE.vocab_size, 52), 1024


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--demo", action="store_true",
                      help="tiny random-weight stack")
    mode.add_argument("--demo-full", action="store_true",
                      help="full-size SDXL stack with random weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt", default="一只戴着帽子的可爱猫咪")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--guidance-rescale", type=float, default=0.0)
    ap.add_argument("--sampler", default="dpm++", choices=["dpm++", "ddim"])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default="out.png")
    args = ap.parse_args(argv)

    from ..pipelines.text2image import StableDiffusionXLPEAPipeline, to_pil

    if args.demo:
        models, tokenize, max_size = build_demo(args.device)
        steps = min(args.steps, 8)
    else:
        models, tokenize, max_size = build_demo_full(args.device)
        steps = args.steps
    size = min(args.size, max_size)
    pipe = StableDiffusionXLPEAPipeline(models, args.sampler)
    imgs = pipe(tokenize([args.prompt]), tokenize([args.negative_prompt]),
                height=size, width=size, num_steps=steps,
                guidance_scale=args.guidance,
                guidance_rescale=args.guidance_rescale, seed=args.seed)
    to_pil(imgs)[0].save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
