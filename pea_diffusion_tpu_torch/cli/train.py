"""KD training CLI of the PyTorch port.

--model picks SDXL (default) or SD1.5. --demo trains a tiny random-weight
stack of that architecture on synthetic data (the JAX package's
``cli/train.py --demo`` and ``tests/test_kd_sd15.py`` shapes); --demo-full
trains the full-width PEA stack with random weights made on the device:
real shapes and kernels, meaningless data.
- SDXL: the Chinese-CLIP RoBERTa-large student tower, the sdxl_chinese_clip
  adapter, CLIP ViT-L + OpenCLIP bigG teachers, the SDXL UNet and the fp32
  SDXL VAE encoder, at micro-batch 10 and 640x640 by default
  (``bench_train.py``).
- SD1.5: the same student tower, the sd15_chinese_clip adapter, the CLIP
  ViT-L teacher alone, the SD1.5 UNet and the fp32 SD1.5 VAE encoder, at
  micro-batch 40 and 512x512 by default (the reference's train_sd_zh.py
  operating point).
--resume-adapter starts from a reference-format adapter checkpoint
(``proj_N/pytorch_model.bin`` or its safetensors sibling).

Real mode (neither demo flag; SDXL, as in the JAX package) trains the
adapter of --adapter-preset on webdataset shards (--urls, brace ranges,
`::`-joined groups) through the data pipeline (data/pipeline.py, the
aspect buckets, --num-workers decode threads) and the card's prefetcher,
from a diffusers SDXL directory (--model-dir: unet/, vae/, text_encoder/,
text_encoder_2/ and the CLIP tokenizers in tokenizer/, tokenizer_2/), the
student tower of --family (--text-encoder-dir, for mul_zh also
--text-encoder-dir-2; tokenizers from --tokenizer-dir(-2), by default the
tower directories, through transformers), optional --lora files fused into
the UNet and the CLIP teachers. --profile START STOP traces steps
[START, STOP) under <output>/trace.

Several GPUs: under ``torchrun --nproc-per-node N`` (or with --coordinator
HOST:PORT --num-processes N --process-id I on each process) the ranks join
one process group first, then train over the (data, fsdp) mesh of
TrainConfig.mesh_shape (every rank a data rank): --batch-size rows a data
rank, the adapter gradient averaged over the data ranks (parallel/mesh.py;
an fsdp size above 1, set through TrainConfig in code, shards the frozen
UNet). The demo streams make the global batch on every
rank and each keeps its rows; in the real mode each rank reads its own
shards.

Usage:
  python -m pea_diffusion_tpu_torch.cli.train --demo --device cpu --steps 2 --output run
  python -m pea_diffusion_tpu_torch.cli.train --demo-full --steps 3 --output run
  python -m pea_diffusion_tpu_torch.cli.train --model sd15 --demo-full --steps 3 --output run
  python -m pea_diffusion_tpu_torch.cli.train --model-dir sdxl --text-encoder-dir cn-clip \
      --urls "/data/laion_zh/{00000..00999}.tar::/data/wukong/{00000..00499}.tar" \
      --batch-size 10 --output runs/sdxl_zh
  torchrun --nproc-per-node 8 -m pea_diffusion_tpu_torch.cli.train --demo-full --steps 3 \
      --output run
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


# --model's choices, with the (micro-batch, image side) of --demo-full: bench_train.py's SDXL operating
# point; the reference's SD1.5 one (train_sd_zh.py, 40 per GPU at 512²)
DEMO_FULL_DEFAULTS = {"sdxl": (10, 640), "sd15": (40, 512)}
REAL_BATCH = 10  # the real mode's rows per step, the JAX CLI's default


def build_demo(device="cuda", batch_size: int = 2, seed: int = 0, model: str = "sdxl"):
    """Tiny fp32 KD stack and a synthetic batch stream
    ``make_batches(start_step)``: SDXL-architecture with the dual CLIP
    teacher (the JAX package's ``cli/train.py::build_demo`` shapes), or
    SD1.5-architecture with one CLIP teacher as wide as the UNet's
    cross-attention (``tests/test_kd_sd15.py``'s full path)."""
    from ..configs.text_encoder import BERT_TINY, CLIPTextConfig
    from ..configs.unet import SD15_UNET_TINY, SDXL_UNET_TINY, VAE_TINY
    from ..pipelines.factory import build_kd_models
    from .generate import tiny_adapter_config

    T, TT, IMG = 12, 16, 64
    sd15 = model == "sd15"
    ucfg = SD15_UNET_TINY if sd15 else SDXL_UNET_TINY
    if sd15:
        teachers = (CLIPTextConfig(vocab_size=500, hidden_size=ucfg.cross_attention_dim,
                                   num_layers=2, num_heads=2, intermediate_size=64,
                                   max_position_embeddings=TT, eos_token_id=499),)
    else:
        pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
        teachers = (CLIPTextConfig(vocab_size=500, hidden_size=24, num_layers=2,
                                   num_heads=2, intermediate_size=48,
                                   max_position_embeddings=TT, eos_token_id=499),
                    CLIPTextConfig(vocab_size=500, hidden_size=40, num_layers=2,
                                   num_heads=2, intermediate_size=64,
                                   projection_dim=pooled, max_position_embeddings=TT,
                                   eos_token_id=499, hidden_act="gelu"))
    models = build_kd_models(
        family="chinese_clip", text_cfg=BERT_TINY, adapter_cfg=tiny_adapter_config(model),
        unet_cfg=ucfg, vae_cfg=VAE_TINY, teacher_cfgs=teachers,
        dtype=torch.float32, device=device, seed=seed)

    def make_batches(start_step: int = 0):
        rng = np.random.RandomState(start_step)
        B = batch_size
        while True:
            batch = {
                "pixel_values": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
                "input_ids": rng.randint(4, 500, (B, T)),
                "input_ids_uncond": np.full((B, T), 4),
                "teacher_ids_1": rng.randint(4, 499, (B, TT)),
                "teacher_uncond_ids_1": np.full((B, TT), 4),
                "zh_or_not": rng.randint(0, 2, (B,)).astype(np.float32),
            }
            if not sd15:
                batch.update({
                    "teacher_ids_2": rng.randint(4, 499, (B, TT)),
                    "teacher_uncond_ids_2": np.full((B, TT), 4),
                    "time_ids": np.tile(np.array([[IMG, IMG, 0, 0, IMG, IMG]],
                                                 np.float32), (B, 1))})
            yield batch

    return models, make_batches


def build_demo_full(device="cuda", batch_size: int = 10, size: int = 640,
                    seed: int = 0, model: str = "sdxl"):
    """The full-width KD stack with random weights from `seed` (SDXL: the
    JAX package's ``bench_train.py`` stack; SD1.5: the same with the SD1.5
    UNet and VAE, the sd15_chinese_clip adapter and the CLIP ViT-L teacher
    alone): bf16 frozen towers and UNet, fp32 VAE (encode in chunks of 2),
    fp32 adapter, full remat of the student UNet; and a stream of synthetic
    batches made on the device (`size`² images, 52 student and 77 teacher
    tokens)."""
    from ..configs.adapter import ADAPTER_PRESETS
    from ..configs.text_encoder import CHINESE_CLIP_LARGE, CLIP_BIG_G, CLIP_VIT_L
    from ..configs.unet import SD15_UNET, SD15_VAE, SDXL_UNET, SDXL_VAE
    from ..pipelines.factory import build_kd_models

    sd15 = model == "sd15"
    models = build_kd_models(
        family="chinese_clip", text_cfg=CHINESE_CLIP_LARGE,
        adapter_cfg=ADAPTER_PRESETS["sd15_chinese_clip" if sd15 else "sdxl_chinese_clip"],
        unet_cfg=SD15_UNET if sd15 else SDXL_UNET, vae_cfg=SD15_VAE if sd15 else SDXL_VAE,
        teacher_cfgs=(CLIP_VIT_L,) if sd15 else (CLIP_VIT_L, CLIP_BIG_G),
        dtype=torch.bfloat16, vae_dtype=torch.float32, device=device, seed=seed)
    return models, lambda start_step=0: demo_full_batches(
        models.device, batch_size, size, seed + 1 + start_step, model)


def demo_full_batches(device, batch_size: int, size: int, seed: int, model: str = "sdxl"):
    """Synthetic full-width batches made on the device from `seed`: `size`²
    images in [-1, 1], 52 student and 77 teacher tokens (one teacher tower's
    for SD1.5, two and the SDXL time ids for SDXL), random zh_or_not."""
    from ..configs.text_encoder import CHINESE_CLIP_LARGE, CLIP_BIG_G, CLIP_VIT_L

    gen = torch.Generator(device=device).manual_seed(seed)
    B, T, TT = batch_size, 52, 77

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device)

    while True:
        batch = {
            "pixel_values": torch.rand((B, size, size, 3), generator=gen,
                                       device=device) * 2 - 1,
            "input_ids": ints(4, CHINESE_CLIP_LARGE.vocab_size, (B, T)),
            "input_ids_uncond": torch.full((B, T), 4, device=device),
            "teacher_ids_1": ints(4, CLIP_VIT_L.vocab_size - 1, (B, TT)),
            "teacher_uncond_ids_1": torch.full((B, TT), 4, device=device),
        }
        if model != "sd15":
            batch["teacher_ids_2"] = ints(4, CLIP_BIG_G.vocab_size - 1, (B, TT))
            batch["teacher_uncond_ids_2"] = torch.full((B, TT), 4, device=device)
            batch["time_ids"] = torch.tensor([[size, size, 0, 0, size, size]],
                                             dtype=torch.float32, device=device).repeat(B, 1)
        batch["zh_or_not"] = ints(0, 2, (B,)).float()
        yield batch


def build_real(args):
    """The KD stack of the real mode (see the module's docstring) on
    --device, and ``make_batches(start_step)``: the card-prefetched batch
    stream of the shards, re-seeded by the resumed step."""
    from transformers import AutoTokenizer, CLIPTokenizer

    from ..checkpoints.load_pretrained import (load_clip_text, load_student_tower, load_unet,
                                               load_vae)
    from ..configs.adapter import ADAPTER_PRESETS
    from ..configs.train import DataConfig
    from ..data.pipeline import make_train_iterator, prefetch_to_device
    from ..models.adapter import PEAAdapter
    from ..pipelines.factory import make_text_encoder_fn, resolve_device
    from ..schedulers import SDXL_SCHEDULE
    from ..train.kd import KDModels

    dev, bf16 = resolve_device(args.device), torch.bfloat16
    loras, scales = args.lora or (), args.lora_scale or ()
    _, unet = load_unet(args.model_dir, lora_paths=loras, lora_scales=scales, dtype=bf16,
                        device=dev)
    vae_cfg, vae = load_vae(args.model_dir, device=dev)
    text_cfg, text = load_student_tower(args.family, args.text_encoder_dir,
                                        args.text_encoder_dir_2, dtype=bf16, device=dev)
    _, text_fn = make_text_encoder_fn(args.family, text_cfg, text)
    teachers = [load_clip_text(f"{args.model_dir}/{name}", with_projection=proj,
                               lora_paths=loras, lora_scales=scales, component=name,
                               dtype=bf16, device=dev)[1]
                for name, proj in (("text_encoder", False), ("text_encoder_2", True))]
    torch.manual_seed(0)  # the module's own initialisation, as the JAX CLI's init
    with torch.device(dev):
        adapter = PEAAdapter(ADAPTER_PRESETS[args.adapter_preset])
    models = KDModels(adapter=adapter.train(), unet=unet, vae=vae, text_encoder=text,
                      text_encoder_fn=text_fn, teacher_clip1=teachers[0],
                      teacher_clip2=teachers[1], schedule=SDXL_SCHEDULE,
                      vae_scaling=vae_cfg.scaling_factor).freeze()

    def tokenizer(tok, length):
        return lambda texts: tok(texts, padding="max_length", max_length=length,
                                 truncation=True, return_tensors="np")["input_ids"]

    tokenize = tokenizer(AutoTokenizer.from_pretrained(
        args.tokenizer_dir or args.text_encoder_dir), args.max_length)
    teacher_tokenize = [tokenizer(CLIPTokenizer.from_pretrained(f"{args.model_dir}/{d}"), 77)
                        for d in ("tokenizer", "tokenizer_2")]
    tokenize_zh = None
    if args.family == "mul_zh":  # the Chinese tokenizer's ids beside XLM-R's
        tokenize_zh = tokenizer(AutoTokenizer.from_pretrained(
            args.tokenizer_dir_2 or args.text_encoder_dir_2), args.max_length)
    data_cfg = DataConfig(urls=tuple(args.urls), batch_size=args.batch_size,
                          num_workers=args.num_workers)

    def make_batches(start_step: int = 0):
        # made after the trainer's resume: start_step re-seeds the stream so
        # that a resumed run does not replay the consumed prefix
        # a data rank reads its own shards (the ranks of one fsdp group, the same)
        index, count = getattr(args, "data_shard", (None, None))
        return prefetch_to_device(make_train_iterator(
            data_cfg, tokenize, teacher_tokenize, tokenize_zh, start_step=start_step,
            process_index=index, process_count=count), dev)

    return models, make_batches


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--demo", action="store_true", help="tiny random-weight stack")
    mode.add_argument("--demo-full", action="store_true",
                      help="full-width KD stack with random weights")
    ap.add_argument("--model", default="sdxl", choices=list(DEMO_FULL_DEFAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="rows per step (default: 2 for --demo; for --demo-full 10 "
                         "for sdxl, 40 for sd15; 10 in the real mode)")
    ap.add_argument("--size", type=int, default=None,
                    help="--demo-full image size (default: 640 for sdxl, 512 for sd15)")
    ap.add_argument("--output", default="./checkpoints")
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--every-n-steps", type=int, default=5000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--no-kd", action="store_true")
    ap.add_argument("--no-hybrid", action="store_true")
    ap.add_argument("--resume-adapter", metavar="PATH",
                    help="start from this reference-format adapter checkpoint")
    ap.add_argument("--profile", nargs=2, type=int, metavar=("START", "STOP"),
                    help="trace steps [START, STOP) under <output>/trace")
    real = ap.add_argument_group("real mode (neither --demo nor --demo-full; SDXL)")
    real.add_argument("--model-dir", help="diffusers SDXL directory (unet/, vae/, "
                                          "text_encoder(_2)/, tokenizer(_2)/)")
    real.add_argument("--text-encoder-dir", help="the student tower (see --family)")
    real.add_argument("--text-encoder-dir-2",
                      help="mul_zh: the Chinese-CLIP tower (the second encoder)")
    real.add_argument("--tokenizer-dir", help="default: --text-encoder-dir")
    real.add_argument("--tokenizer-dir-2", help="mul_zh; default: --text-encoder-dir-2")
    real.add_argument("--family", default="chinese_clip",
                      choices=["chinese_clip", "mul_clip", "mt5", "alt_clip", "mul_zh"])
    real.add_argument("--adapter-preset", default="sdxl_chinese_clip")
    real.add_argument("--lora", nargs="*",
                      help="LoRA safetensors fused into the UNet and the CLIP teachers")
    real.add_argument("--lora-scale", nargs="*", type=float)
    real.add_argument("--urls", nargs="+", default=[], help="webdataset shard urls")
    real.add_argument("--num-workers", type=int, default=2)
    real.add_argument("--max-length", type=int, default=52)
    dist_args = ap.add_argument_group("several processes")
    dist_args.add_argument("--coordinator", metavar="HOST:PORT",
                           help="rank 0's address (without it: torchrun's environment)")
    dist_args.add_argument("--num-processes", type=int)
    dist_args.add_argument("--process-id", type=int)
    args = ap.parse_args(argv)
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        ap.error("--coordinator needs --num-processes and --process-id")
    from ..configs.train import TrainConfig

    mesh = None
    if args.coordinator or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel import initialize, make_mesh

        initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
        mesh = make_mesh(TrainConfig.mesh_shape)

    real_mode = not (args.demo or args.demo_full)
    if real_mode:
        if args.model != "sdxl":
            ap.error("the real mode trains SDXL (--model sdxl); --model sd15 runs "
                     "with --demo or --demo-full")
        for req in ("model_dir", "text_encoder_dir"):
            if getattr(args, req) is None:
                ap.error(f"--{req.replace('_', '-')} required without --demo")
        if args.family == "mul_zh" and args.text_encoder_dir_2 is None:
            ap.error("--family mul_zh needs --text-encoder-dir-2 (the Chinese-CLIP tower)")
        if not args.urls:
            ap.error("--urls required without --demo")

    from ..parallel.distributed import is_main
    from ..parallel.mesh import batch_shards
    from ..train.trainer import KDTrainer

    # the demo streams make the global batch (every data rank's rows)
    args.data_shard = (0, 1) if mesh is None else batch_shards(mesh)
    n_data = args.data_shard[1]
    if real_mode:  # build_real reads args.batch_size: resolve it first
        batch = args.batch_size = args.batch_size or REAL_BATCH
        models, make_batches = build_real(args)
    elif args.demo:
        batch = args.batch_size or 2
        models, make_batches = build_demo(args.device, batch * n_data, model=args.model)
    else:
        default_batch, default_size = DEMO_FULL_DEFAULTS[args.model]
        batch = args.batch_size or default_batch
        models, make_batches = build_demo_full(args.device, batch * n_data,
                                               args.size or default_size, model=args.model)
    if args.resume_adapter:
        from ..checkpoints.orbax_io import import_adapter

        import_adapter(args.resume_adapter, models.adapter)
    cfg = TrainConfig(
        learning_rate=args.lr, output_dir=args.output,
        every_n_steps=args.every_n_steps, log_every_n_steps=args.log_every,
        kd=not args.no_kd, hybrid_training=not args.no_hybrid,
        batch_size_per_device=batch)
    if args.demo:
        cfg = dataclasses.replace(cfg, every_n_steps=max(args.steps or 5, 1),
                                  log_every_n_steps=1)
    elif args.demo_full:  # no warmup, so that the first update already moves the
        # adapter: warmup_steps=0 alone falls back to warmup_ratio * total_steps
        cfg = dataclasses.replace(cfg, warmup_steps=0, warmup_ratio=0.0)
    # over a mesh, the real mode's batches are the rank's own (its shards)
    over_mesh = {} if mesh is None else {"mesh": mesh, "local_batches": real_mode}
    trainer = KDTrainer(models, cfg,
                        profile_window=tuple(args.profile) if args.profile else None,
                        **over_mesh)
    resumed = trainer.resume()
    state = trainer.fit(make_batches(resumed), max_steps=args.steps)
    if is_main():
        print(f"done at step {state.step}")


if __name__ == "__main__":
    main()
