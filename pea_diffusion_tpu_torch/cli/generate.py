"""Text-to-image CLI of the PyTorch port.

--model picks SDXL (default) or SD1.5. --demo runs a tiny random-weight
stack of that architecture; --demo-full runs the full-size stack
(Chinese-CLIP RoBERTa-large, the sdxl_chinese_clip or sd15_chinese_clip
adapter, the model's UNet and VAE in bf16: the stacks of ``bench.py``) with
random weights made on the device: real shapes and kernels, meaningless
pixels. --control-image turns on ControlNet mode (SDXL): a tiny random
ControlNet under --demo, the full SDXL ControlNet under --demo-full.
Loading real checkpoints (--controlnet DIR among them) is not ported yet
(ROADMAP Queue A item 9).

Usage:
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo-full --sampler ddim --steps 4 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --model sd15 --demo-full --sampler ddim --steps 20 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu --control-image edges.png \
      --control-canny --control-scale 0.8 --control-end 0.6 -o out.png
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


MODELS = ("sdxl", "sd15")


def tiny_adapter_config(model: str):
    """The tiny stacks' adapter: SDXL's gives a pooled embedding and a
    sequence head, SD1.5's the sequence only (the JAX package's tests'
    shapes)."""
    from ..configs.adapter import AdapterConfig
    from ..configs.text_encoder import BERT_TINY
    from ..configs.unet import SD15_UNET_TINY, SDXL_UNET_TINY

    if model == "sd15":
        return AdapterConfig(BERT_TINY.hidden_size, (96, 96, SD15_UNET_TINY.cross_attention_dim))
    ucfg = SDXL_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    return AdapterConfig(BERT_TINY.hidden_size, (96, pooled), head_dim=ucfg.cross_attention_dim)


def build_demo(device="cuda", model: str = "sdxl"):
    """Tiny random-weight SDXL- or SD1.5-architecture stack in fp32."""
    from ..configs.text_encoder import BERT_TINY
    from ..configs.unet import SD15_UNET_TINY, SDXL_UNET_TINY, VAE_TINY
    from ..pipelines.factory import build_models

    models = build_models(family="chinese_clip", text_cfg=BERT_TINY,
                          adapter_cfg=tiny_adapter_config(model),
                          unet_cfg=SD15_UNET_TINY if model == "sd15" else SDXL_UNET_TINY,
                          vae_cfg=VAE_TINY, dtype=torch.float32, device=device)
    return models, make_tokenizer(BERT_TINY.vocab_size, 16), 256


def build_demo_full(device="cuda", seed: int = 0, model: str = "sdxl"):
    """Full-size PEA stack with random weights (the JAX package's
    `build_demo_full` and ``bench.py --model sdxl|sd15`` stacks): bf16 text
    tower, UNet and VAE, fp32 adapter weights, 52-token prompts. Returns
    (models, tokenize, the model's native image size: 1024 or 512)."""
    from ..configs.adapter import ADAPTER_PRESETS
    from ..configs.text_encoder import CHINESE_CLIP_LARGE
    from ..configs.unet import SD15_UNET, SD15_VAE, SDXL_UNET, SDXL_VAE
    from ..pipelines.factory import build_models

    sd15 = model == "sd15"
    models = build_models(
        family="chinese_clip", text_cfg=CHINESE_CLIP_LARGE,
        adapter_cfg=ADAPTER_PRESETS["sd15_chinese_clip" if sd15 else "sdxl_chinese_clip"],
        unet_cfg=SD15_UNET if sd15 else SDXL_UNET, vae_cfg=SD15_VAE if sd15 else SDXL_VAE,
        dtype=torch.bfloat16, vae_dtype=torch.bfloat16, device=device, seed=seed)
    return models, make_tokenizer(CHINESE_CLIP_LARGE.vocab_size, 52), 512 if sd15 else 1024


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def make_controlnet_run(args, models, size: int, steps: int):
    """ControlNet mode: the control image (Canny edges of it with
    --control-canny) at the output size, a ControlNet matching the UNet
    (tiny, fp32, seed 2 under --demo, as the JAX CLI builds it; the full
    SDXL one in bf16 under --demo-full), and a function that generates one
    image per prompt."""
    from ..pipelines.controlnet import (canny_edges, generate_sdxl_controlnet,
                                        prepare_control_image)
    from ..pipelines.factory import build_controlnet

    arr = _load_image(args.control_image)
    if args.control_canny:
        arr = canny_edges(arr)
    control = prepare_control_image(arr, size, size, 1)
    if args.demo:
        cn = build_controlnet(models.unet.config, (8, 8, 16, 16), dtype=torch.float32,
                              device=args.device, seed=2)
    else:
        cn = build_controlnet(models.unet.config, device=args.device)

    def run(ids, uncond, seed):
        gen = torch.Generator(device=models.device).manual_seed(seed)
        return generate_sdxl_controlnet(
            models, cn, ids, uncond, control, generator=gen, sampler_name=args.sampler,
            height=size, width=size, num_steps=steps, guidance_scale=args.guidance,
            guidance_rescale=args.guidance_rescale,
            controlnet_conditioning_scale=args.control_scale, guess_mode=args.control_guess,
            control_guidance_start=args.control_start, control_guidance_end=args.control_end)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--demo", action="store_true",
                      help="tiny random-weight stack")
    mode.add_argument("--demo-full", action="store_true",
                      help="full-size stack with random weights")
    ap.add_argument("--model", default="sdxl", choices=MODELS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt", default="一只戴着帽子的可爱猫咪")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    help="SDXL only")
    ap.add_argument("--sampler", default="dpm++", choices=["dpm++", "ddim"])
    ap.add_argument("--size", type=int, default=None,
                    help="image side (default: the model's, 1024 or 512)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default="out.png")
    cn = ap.add_argument_group("ControlNet mode (SDXL)")
    cn.add_argument("--controlnet", metavar="DIR",
                    help="a diffusers ControlNetModel checkpoint (not ported yet)")
    cn.add_argument("--control-image", metavar="PATH",
                    help="conditioning image (turns ControlNet mode on)")
    cn.add_argument("--control-canny", action="store_true",
                    help="use the Canny edges of --control-image")
    cn.add_argument("--control-scale", type=float, default=1.0)
    cn.add_argument("--control-guess", action="store_true",
                    help="guess mode: control from the conditional half only")
    cn.add_argument("--control-start", type=float, default=0.0)
    cn.add_argument("--control-end", type=float, default=1.0)
    args = ap.parse_args(argv)
    if args.controlnet:
        raise NotImplementedError("loading a ControlNet checkpoint waits for the "
                                  "safetensors reader (ROADMAP Queue A item 9)")
    if args.control_image and args.model != "sdxl":
        ap.error("ControlNet mode runs the SDXL stack (--model sdxl)")

    from ..pipelines.text2image import (StableDiffusionPEAPipeline,
                                        StableDiffusionXLPEAPipeline, to_pil)

    if args.demo:
        models, tokenize, max_size = build_demo(args.device, args.model)
        steps = min(args.steps, 8)
    else:
        models, tokenize, max_size = build_demo_full(args.device, model=args.model)
        steps = args.steps
    size = min(args.size or max_size, max_size)
    extra = {}
    if args.control_image:
        run = make_controlnet_run(args, models, size, steps)
        imgs = run(tokenize([args.prompt]), tokenize([args.negative_prompt]), args.seed)
        to_pil(imgs)[0].save(args.output)
        print(f"wrote {args.output}")
        return
    if args.model == "sd15":
        pipe = StableDiffusionPEAPipeline(models, args.sampler)
    else:
        pipe = StableDiffusionXLPEAPipeline(models, args.sampler)
        extra["guidance_rescale"] = args.guidance_rescale
    imgs = pipe(tokenize([args.prompt]), tokenize([args.negative_prompt]),
                height=size, width=size, num_steps=steps,
                guidance_scale=args.guidance, seed=args.seed, **extra)
    to_pil(imgs)[0].save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
