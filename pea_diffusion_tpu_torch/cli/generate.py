"""Text-to-image CLI of the PyTorch port.

Real mode loads a deployment from disk: --model-dir (a diffusers SDXL or
SD1.5 directory: unet/, vae/, scheduler/), --text-encoder-dir (the student
tower of --family: a transformers Chinese-CLIP / BERT directory for
chinese_clip, open_clip's xlm-roberta-large checkpoint for mul_clip, an
AltCLIP text directory for alt_clip, a transformers mT5 directory for mt5;
for mul_zh the XLM-R checkpoint, with the Chinese-CLIP directory as
--text-encoder-dir-2), --adapter (a reference `proj` checkpoint, its shape
given by --adapter-preset, e.g. sdxl_mt5 or sdxl_concat), optional --lora
files fused into the UNet, and the tokenizer of --tokenizer-dir (default:
the text-encoder dir; mul_zh also --tokenizer-dir-2, default
--text-encoder-dir-2, and tokenizes the prompt with both) through
transformers' AutoTokenizer. The UNet's config decides SDXL or SD1.5. --sampler euler_a
--steps 4 --guidance 0 with a trailing-spacing scheduler is the SDXL-Turbo
operating point; --lora LCM_LORA --sampler lcm --steps 4 --guidance 0 is
LCM-LoRA's.

--demo runs a tiny random-weight stack of --model's architecture (SDXL by
default, or SD1.5; --adapter loads a `cli.train --demo` adapter into it);
--demo-full runs the full-size stack (Chinese-CLIP RoBERTa-large, the
sdxl_chinese_clip or sd15_chinese_clip adapter, the model's UNet and VAE in
bf16: the stacks of ``bench.py``) with random weights made on the device:
real shapes and kernels, meaningless pixels. --control-image turns on
ControlNet mode (SDXL): the --controlnet DIR checkpoint in real mode, a tiny
random ControlNet under --demo, the full SDXL ControlNet under --demo-full.
--inpaint-image with --mask (white = repaint) turns on inpaint mode (SDXL;
ControlNet mode wins when both are given): a 9-channel UNet (a --model-dir
whose unet/config.json says in_channels 9) takes the mask and the masked
image's latents as input, a 4-channel one blends the unmasked region back
after each step; --strength sets how far into the schedule it starts.

--quant int8 (= int8:resnet) or int8:<scopes> (resnet, shortcut, sampler,
stem, vae) serves the SDXL UNet's (and under vae the VAE decoder's)
in-scope convs in int8 (quant/int8.py), calibrated on the prompt; with
--calib-ranges PATH the ranges are read from PATH if it exists and written
there otherwise. --aot-cache DIR keeps the compiled kernel library under DIR
(utils/startup.py), so a restarted process builds nothing; by default the
library is built into the checkout's build/ (or ~/.cache/
pea_diffusion_tpu_torch/), --no-compile-cache builds it into a temporary
directory every time. --aot-cache, --quant and --calib-ranges are
text-to-image only. --repl then reads more prompts, one a line, and writes
each image beside -o (out-1.png, out-2.png, ...) until an empty line or the
end of the input.

--tp N runs the UNet Megatron-sharded over N ranks (parallel/tp.py; text to
image): launch it under ``torchrun --nproc-per-node N -m
pea_diffusion_tpu_torch.cli.generate ... --tp N``. Every rank parses the
same arguments and runs the same request; rank 0 alone writes the images,
prints, and reads the --repl prompts, which it sends to the others.

Usage:
  python -m pea_diffusion_tpu_torch.cli.generate --model-dir sdxl --text-encoder-dir cn-clip \
      --adapter proj_1000/pytorch_model.bin --lora lcm-lora.safetensors --sampler lcm \
      --steps 4 --guidance 0 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --model-dir sdxl --family mul_zh \
      --text-encoder-dir xlmr-vit-h --tokenizer-dir xlm-roberta-large \
      --text-encoder-dir-2 cn-clip --adapter proj_1000/pytorch_model.bin \
      --adapter-preset sdxl_concat -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo-full --sampler ddim --steps 4 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --model sd15 --demo-full --sampler ddim --steps 20 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu --control-image edges.png \
      --control-canny --control-scale 0.8 --control-end 0.6 -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo --device cpu --inpaint-image photo.png \
      --mask mask.png --strength 0.6 --sampler ddim -o out.png
  python -m pea_diffusion_tpu_torch.cli.generate --demo-full --quant int8:resnet,vae \
      --calib-ranges ranges.json --aot-cache aot --sampler ddim --steps 4 -o out.png --repl
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist


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


def build_real(args):
    """The deployment of --model-dir, --text-encoder-dir and --adapter (see
    the module's docstring) on --device, and its tokenizer. Returns (models,
    tokenize, --size)."""
    from ..checkpoints.load_pretrained import (load_schedule, load_student_tower, load_unet,
                                               load_vae)
    from ..checkpoints.orbax_io import import_adapter
    from ..configs.adapter import ADAPTER_PRESETS
    from ..models.adapter import PEAAdapter
    from ..pipelines.factory import load_weights, make_text_encoder_fn, resolve_device
    from ..pipelines.text2image import PEAModels

    dev, bf16 = resolve_device(args.device), torch.bfloat16
    unet_cfg, unet = load_unet(args.model_dir, lora_paths=args.lora or (),
                               lora_scales=args.lora_scale or (), dtype=bf16, device=dev)
    vae_cfg, vae = load_vae(args.model_dir, device=dev)
    text_cfg, text = load_student_tower(args.family, args.text_encoder_dir,
                                        args.text_encoder_dir_2, dtype=bf16, device=dev)
    _, text_fn = make_text_encoder_fn(args.family, text_cfg, text)
    with torch.device("meta"):
        adapter = PEAAdapter(ADAPTER_PRESETS[args.adapter_preset], dtype=bf16)
    adapter = load_weights(adapter, import_adapter(args.adapter), torch.float32, dev,
                           "adapter")
    models = PEAModels(text_encoder=text, text_encoder_fn=text_fn, adapter=adapter,
                       unet=unet, vae=vae, schedule=load_schedule(args.model_dir),
                       vae_scaling=vae_cfg.scaling_factor, device=dev)

    from transformers import AutoTokenizer

    def tokenizer(directory):
        tok = AutoTokenizer.from_pretrained(directory)
        return lambda texts: tok(texts, padding="max_length", max_length=args.max_length,
                                 truncation=True, return_tensors="np")["input_ids"]

    tokenize = tokenizer(args.tokenizer_dir or args.text_encoder_dir)
    if args.family == "mul_zh":  # two tokenizations of the prompt -> dict ids
        tok_mul = tokenize
        tok_zh = tokenizer(args.tokenizer_dir_2 or args.text_encoder_dir_2)
        tokenize = lambda texts: {"mul": tok_mul(texts), "zh": tok_zh(texts)}  # noqa: E731
    return models, tokenize, args.size


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def make_controlnet_run(args, models, size: int, steps: int):
    """ControlNet mode: the control image (Canny edges of it with
    --control-canny) at the output size, a ControlNet matching the UNet
    (the --controlnet checkpoint in bf16 in real mode; tiny, fp32, seed 2
    under --demo, as the JAX CLI builds it; the full SDXL one in bf16 under
    --demo-full), and a function that generates one image per prompt."""
    from ..pipelines.controlnet import (canny_edges, generate_sdxl_controlnet,
                                        prepare_control_image)
    from ..pipelines.factory import build_controlnet

    arr = _load_image(args.control_image)
    if args.control_canny:
        arr = canny_edges(arr)
    control = prepare_control_image(arr, size, size, 1)
    if args.controlnet and not args.demo:
        from ..checkpoints.load_pretrained import load_controlnet

        _, cn = load_controlnet(args.controlnet, dtype=torch.bfloat16, device=models.device)
    elif args.demo:
        if args.controlnet:  # a checkpoint's dims cannot match the tiny stack
            print("[generate] --demo: ignoring --controlnet checkpoint, using the tiny "
                  "random-weight ControlNet")
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


def make_inpaint_run(args, models, size: int, steps: int):
    """Inpaint mode: --inpaint-image at the output size in [-1, 1], --mask
    (as grey levels; white = repaint) binarized at that size, and a function
    that generates one image per prompt. The UNet's in_channels picks the
    9-channel input or the 4-channel blend."""
    from PIL import Image

    from ..pipelines.inpaint import generate_sdxl_inpaint, preprocess_image, preprocess_mask

    image = preprocess_image(_load_image(args.inpaint_image), size, size)
    mask = preprocess_mask(np.asarray(Image.open(args.mask).convert("L")), size, size)

    def run(ids, uncond, seed):
        gen = torch.Generator(device=models.device).manual_seed(seed)
        return generate_sdxl_inpaint(
            models, ids, uncond, image, mask, generator=gen, sampler_name=args.sampler,
            height=size, width=size, num_steps=steps, guidance_scale=args.guidance,
            guidance_rescale=args.guidance_rescale, strength=args.strength)

    return run


def check_serving_flags(ap, args, cli: str = "generate"):
    """The argparse errors of the flags both CLIs share: --tp N in a process
    without N ranks (with how to launch it), an unknown --quant scope,
    --aot-cache with --no-compile-cache."""
    from ..quant.int8 import parse_scopes

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.tp < 1:
        ap.error(f"--tp {args.tp}: the tensor-parallel degree is at least 1")
    if args.tp > 1 and world != args.tp:
        ap.error(f"--tp {args.tp} runs on {args.tp} ranks but this process has "
                 f"WORLD_SIZE={world}: launch it with torchrun --nproc-per-node {args.tp} "
                 f"-m pea_diffusion_tpu_torch.cli.{cli} ... --tp {args.tp}")
    try:
        parse_scopes(args.quant)
    except ValueError as e:
        ap.error(f"--quant {args.quant}: {e}")
    if args.aot_cache and args.no_compile_cache:
        ap.error("--aot-cache keeps the compiled library, --no-compile-cache builds it "
                 "anew: give one")


def start_tp(args):
    """--tp N above 1: joins the ranks' process group (torchrun's
    environment) and returns the (1, N) tensor-parallel mesh; else None."""
    if args.tp == 1:
        return None
    from ..parallel import initialize
    from ..parallel.tp import make_tp_mesh

    initialize(device=args.device)
    return make_tp_mesh((1, args.tp))


def shard_for_tp(models, mesh):
    """`models` with the UNet cut to this rank's shard over `mesh` (None:
    as they are)."""
    if mesh is None:
        return models
    from ..parallel.tp import shard_bundle_for_tp

    return shard_bundle_for_tp(models, mesh)


def start_compile_cache(args):
    """Where this process builds and finds the kernel library, before
    anything loads it: under --aot-cache DIR, in a temporary directory with
    --no-compile-cache, else the default compile cache."""
    from ..utils.startup import AOTCache, enable_compile_cache, temporary_compile_cache

    if args.aot_cache:
        AOTCache(args.aot_cache)
    elif args.no_compile_cache:
        temporary_compile_cache()
    else:
        enable_compile_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--demo", action="store_true",
                      help="tiny random-weight stack")
    mode.add_argument("--demo-full", action="store_true",
                      help="full-size stack with random weights")
    ap.add_argument("--model", default="sdxl", choices=MODELS,
                    help="the demo stacks' architecture")
    ap.add_argument("--device", default="cuda")
    real = ap.add_argument_group("real mode (neither --demo nor --demo-full)")
    real.add_argument("--model-dir", help="diffusers model directory (unet/, vae/, scheduler/)")
    real.add_argument("--text-encoder-dir", help="the student text tower (see --family)")
    real.add_argument("--text-encoder-dir-2",
                      help="mul_zh: the Chinese-CLIP tower (the second encoder)")
    real.add_argument("--tokenizer-dir", help="default: --text-encoder-dir")
    real.add_argument("--tokenizer-dir-2", help="mul_zh; default: --text-encoder-dir-2")
    real.add_argument("--adapter", help="proj_N/pytorch_model.bin or .safetensors")
    real.add_argument("--adapter-preset", default="sdxl_chinese_clip")
    real.add_argument("--family", default="chinese_clip",
                      choices=["chinese_clip", "mul_clip", "mt5", "alt_clip", "mul_zh"],
                      help="the student tower's family: chinese_clip (Chinese-CLIP "
                           "RoBERTa), mul_clip (open_clip XLM-R), mt5, alt_clip, mul_zh "
                           "(XLM-R and Chinese-CLIP concatenated)")
    real.add_argument("--lora", nargs="*", help="LoRA safetensors fused into the UNet")
    real.add_argument("--lora-scale", nargs="*", type=float)
    real.add_argument("--max-length", type=int, default=52)
    ap.add_argument("--prompt", default="一只戴着帽子的可爱猫咪")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--guidance-rescale", type=float, default=0.0,
                    help="SDXL only")
    ap.add_argument("--sampler", default="dpm++",
                    choices=["dpm++", "ddim", "euler", "euler_a", "lcm"],
                    help="euler_a with --steps 4 --guidance 0 is the SDXL-Turbo "
                         "operating point")
    ap.add_argument("--size", type=int, default=None,
                    help="image side (default: the model's, 1024 or 512; --demo caps it at 256)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default="out.png")
    cn = ap.add_argument_group("ControlNet mode (SDXL)")
    cn.add_argument("--controlnet", metavar="DIR",
                    help="a diffusers ControlNetModel checkpoint (real mode)")
    cn.add_argument("--control-image", metavar="PATH",
                    help="conditioning image (turns ControlNet mode on)")
    cn.add_argument("--control-canny", action="store_true",
                    help="use the Canny edges of --control-image")
    cn.add_argument("--control-scale", type=float, default=1.0)
    cn.add_argument("--control-guess", action="store_true",
                    help="guess mode: control from the conditional half only")
    cn.add_argument("--control-start", type=float, default=0.0)
    cn.add_argument("--control-end", type=float, default=1.0)
    inp = ap.add_argument_group("inpaint mode (SDXL)")
    inp.add_argument("--inpaint-image", metavar="PATH",
                     help="the image to repaint (turns inpaint mode on; needs --mask)")
    inp.add_argument("--mask", metavar="PATH", help="repaint-region mask (white = repaint)")
    inp.add_argument("--strength", type=float, default=0.85)
    srv = ap.add_argument_group("serving")
    srv.add_argument("--repl", action="store_true",
                     help="then read prompts from the input, one a line, an image each "
                          "(out-1.png, out-2.png, ...), until an empty line or its end")
    srv.add_argument("--aot-cache", metavar="DIR",
                     help="keep the compiled kernel library under DIR (keyed by the "
                          "sources, torch, CUDA and the card), so a restart builds nothing")
    srv.add_argument("--no-compile-cache", action="store_true",
                     help="build the kernel library into a temporary directory, removed "
                          "at exit (every start compiles)")
    srv.add_argument("--quant", default="none",
                     help="'int8' (= int8:resnet) or 'int8:<scopes>' from {resnet, shortcut, "
                          "sampler, stem, vae}: int8 PTQ of the SDXL UNet's in-scope convs "
                          "(vae: the VAE decoder's), calibrated on the prompt")
    srv.add_argument("--calib-ranges", metavar="PATH",
                     help="JSON of calibration ranges for --quant: read if it exists, "
                          "written otherwise")
    srv.add_argument("--tp", type=int, default=1,
                     help="tensor-parallel degree: the UNet Megatron-sharded over N ranks "
                          "(launch under torchrun --nproc-per-node N; text to image)")
    args = ap.parse_args(argv)
    real_mode = not (args.demo or args.demo_full)
    if real_mode:
        for req in ("model_dir", "text_encoder_dir", "adapter"):
            if getattr(args, req) is None:
                ap.error(f"--{req.replace('_', '-')} is required without --demo/--demo-full")
        if args.family == "mul_zh" and args.text_encoder_dir_2 is None:
            ap.error("--family mul_zh needs --text-encoder-dir-2 (the Chinese-CLIP tower)")
    if args.controlnet and not args.control_image:
        ap.error("--controlnet needs --control-image")
    if real_mode and args.control_image and not args.controlnet:
        ap.error("ControlNet mode needs --controlnet DIR without --demo/--demo-full")
    if args.control_image and not real_mode and args.model != "sdxl":
        ap.error("ControlNet mode runs the SDXL stack (--model sdxl)")
    inpaint = not args.control_image and bool(args.inpaint_image or args.mask)
    if inpaint and not (args.inpaint_image and args.mask):
        ap.error("inpaint mode needs both --inpaint-image and --mask")
    if inpaint and not real_mode and args.model != "sdxl":
        ap.error("inpaint mode runs the SDXL stack (--model sdxl)")
    if real_mode and args.family == "mul_zh" and (args.control_image or inpaint):
        ap.error("ControlNet and inpaint modes take one tokenization: not --family mul_zh")
    check_serving_flags(ap, args)
    if (args.control_image or inpaint) and (args.aot_cache or args.quant != "none"
                                            or args.calib_ranges or args.tp > 1):
        ap.error("--tp/--aot-cache/--quant/--calib-ranges are text-to-image only")
    mesh = start_tp(args)
    main_rank = mesh is None or dist.get_rank() == 0
    start_compile_cache(args)

    from ..pipelines.text2image import (StableDiffusionPEAPipeline,
                                        StableDiffusionXLPEAPipeline, to_pil)

    if real_mode:
        models, tokenize, size = build_real(args)
        size = size or 1024
        steps, sd15 = args.steps, models.unet.config.addition_embed_type is None
    elif args.demo:  # the tiny stack is cut to its own size, as the JAX CLI's
        models, tokenize, max_size = build_demo(args.device, args.model)
        if args.adapter:  # a `cli.train --demo` adapter: trained against these towers
            from ..checkpoints.orbax_io import import_adapter

            import_adapter(args.adapter, models.adapter)
        size, steps = min(args.size or max_size, max_size), min(args.steps, 8)
        sd15 = args.model == "sd15"
    else:
        models, tokenize, size = build_demo_full(args.device, model=args.model)
        size, steps, sd15 = args.size or size, args.steps, args.model == "sd15"
    if (args.control_image or inpaint) and sd15:
        ap.error(f"{'ControlNet' if args.control_image else 'inpaint'} mode runs an SDXL UNet")
    if args.quant != "none" and sd15:
        ap.error("--quant calibrates the SDXL stack (--model sdxl)")
    if args.control_image or inpaint:
        mode_run = (make_controlnet_run if args.control_image else make_inpaint_run)(
            args, models, size, steps)

        def images(prompt):
            return mode_run(tokenize([prompt]), tokenize([args.negative_prompt]), args.seed)
    else:
        if args.quant != "none":
            from ..quant import quantize_for_serving

            models = quantize_for_serving(models, tokenize([args.prompt]),
                                          tokenize([args.negative_prompt]), size,
                                          ranges_path=args.calib_ranges, conv_quant=args.quant)
        models = shard_for_tp(models, mesh)
        extra = {}
        if sd15:
            pipe = StableDiffusionPEAPipeline(models, args.sampler)
        else:
            pipe = StableDiffusionXLPEAPipeline(models, args.sampler, aot_dir=args.aot_cache,
                                                mesh=mesh)
            extra["guidance_rescale"] = args.guidance_rescale

        def images(prompt):
            return pipe(tokenize([prompt]), tokenize([args.negative_prompt]), height=size,
                        width=size, num_steps=steps, guidance_scale=args.guidance,
                        seed=args.seed, **extra)

    def run(prompt, path):
        img = to_pil(images(prompt))[0]
        if main_rank:
            img.save(path)
            print(f"wrote {path}")

    def read_prompt():
        prompt = ""
        if main_rank:
            try:
                prompt = input("prompt> ").strip()
            except EOFError:
                pass
        if mesh is not None:  # rank 0's line to every rank
            box = [prompt]
            dist.broadcast_object_list(box, src=0)
            prompt = box[0]
        return prompt

    run(args.prompt, args.output)
    stem, ext = os.path.splitext(args.output)
    n = 0
    while args.repl:
        prompt = read_prompt()
        if not prompt:
            break
        n += 1
        run(prompt, f"{stem}-{n}{ext}")


if __name__ == "__main__":
    main()
