"""Serving start-up benchmark: time to the first image by phase, in a fresh
process (the port's counterpart of the repo's root ``bench_startup.py``).

    python -m pea_diffusion_tpu_torch.tools.bench_startup --model-dir DEPLOYMENT \\
        --aot-cache CACHE [--serial]

DEPLOYMENT is an SDXL PEA deployment on disk: a diffusers model directory
(unet/, vae/, scheduler/), the Chinese-CLIP student tower in text/ and the
adapter in proj_0/pytorch_model.bin (--adapter-preset, by default
sdxl_chinese_clip), as chip_smoke.py's few-step phase writes it. Phases,
each timed on the host clock:

- import: torch and the port's modules;
- cuda_init: the card's context;
- load: every weight from DEPLOYMENT into host memory, bf16 (the adapter
  fp32); read from the page cache if the files were read before;
- with overlap (the default): `device_put_streamed` of the weights while
  the main thread runs the pipeline's `prefetch` (the kernel library from
  CACHE, built if it is not there: "cold", else "warm"), as one phase
  "place_and_prefetch" (its prefetch part beside it, not summed);
  with --serial: "place" (the same copies, joined at once), then "prefetch";
- first_image, second_image: a request of one prompt at --size, DDIM
  --steps, CFG 7.5 (the first pays the library's and cuDNN's first calls).

Run it twice with the same CACHE for a cold and a warm start. It prints one
JSON line: time to the first image (the phases up to it) and each phase.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--aot-cache", required=True, metavar="DIR")
    ap.add_argument("--serial", action="store_true",
                    help="place the weights, then prefetch (default: both at once)")
    ap.add_argument("--adapter-preset", default="sdxl_chinese_clip")
    ap.add_argument("--max-length", type=int, default=52)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    phases = {}

    def phase(name, t0):
        phases[name] = time.time() - t0
        print(f"[startup +{time.time() - T_START:.1f}s] {name}: {phases[name]:.3f}s",
              file=sys.stderr, flush=True)

    import torch

    from ..checkpoints.load_pretrained import (load_schedule, load_student_tower, load_unet,
                                               load_vae)
    from ..checkpoints.orbax_io import import_adapter
    from ..cli.generate import make_tokenizer
    from ..configs.adapter import ADAPTER_PRESETS
    from ..models.adapter import PEAAdapter
    from ..ops import kernel_build
    from ..pipelines.factory import load_weights, make_text_encoder_fn, resolve_device
    from ..pipelines.text2image import PEAModels, StableDiffusionXLPEAPipeline
    from ..utils.startup import device_put_streamed
    phase("import", T_START)

    t0 = time.time()
    dev = resolve_device(args.device)
    torch.empty(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase("cuda_init", t0)

    t0 = time.time()
    d, bf16, host = args.model_dir, torch.bfloat16, "cpu"
    unet_cfg, unet = load_unet(d, dtype=bf16, device=host)
    vae_cfg, vae = load_vae(d, dtype=bf16, device=host)
    text_cfg, text = load_student_tower("chinese_clip", os.path.join(d, "text"), dtype=bf16,
                                        device=host)
    with torch.device("meta"):
        adapter = PEAAdapter(ADAPTER_PRESETS[args.adapter_preset], dtype=bf16)
    adapter = load_weights(adapter, import_adapter(os.path.join(d, "proj_0",
                                                                "pytorch_model.bin")),
                           torch.float32, host, "adapter")
    schedule = load_schedule(d)
    modules = (text, adapter, unet, vae)
    phase("load", t0)

    models = PEAModels(text_encoder=text,
                       text_encoder_fn=make_text_encoder_fn("chinese_clip", text_cfg, text)[1],
                       adapter=adapter, unet=unet, vae=vae, schedule=schedule,
                       vae_scaling=vae_cfg.scaling_factor, device=dev)
    pipe = StableDiffusionXLPEAPipeline(models, "ddim", aot_dir=args.aot_cache)
    cold = not pipe._aot.warm()
    point = dict(height=args.size, width=args.size, num_steps=args.steps)
    t0 = time.time()
    if args.serial:
        for m in modules:
            device_put_streamed(m, dev)()
        phase("place", t0)
        t0 = time.time()
        launchers = pipe.prefetch(1, args.max_length, **point)
        phase("prefetch", t0)
    else:
        joins = [device_put_streamed(m, dev) for m in modules]
        t1 = time.time()
        launchers = pipe.prefetch(1, args.max_length, **point)
        phases["_prefetch_part"] = time.time() - t1
        for join in joins:
            join()
        phase("place_and_prefetch", t0)

    tokenize = make_tokenizer(text_cfg.vocab_size, args.max_length)
    ids, uncond = tokenize(["一只戴着帽子的可爱猫咪"]), tokenize([""])
    images = []
    for name, seed in (("first_image", 0), ("second_image", 1)):
        t0 = time.time()
        images.append(pipe(ids, uncond, seed=seed, guidance_scale=7.5, **point))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phase(name, t0)
    img = images[0].float()
    ok = bool(img.isfinite().all()) and img.min().item() >= 0 and img.max().item() <= 1
    ttfi = sum(v for k, v in phases.items() if not k.startswith("_") and k != "second_image")
    print(json.dumps({
        "metric": "SDXL serving time to the first image",
        "value": ttfi, "unit": "s",
        "detail": {"kernel_library": "cold" if cold else "warm",
                   "overlap": not args.serial, "phases_s": phases, "size": args.size,
                   "steps": args.steps, "launchers": list(launchers),
                   "library": str(kernel_build.library_path()), "image_ok": ok,
                   "image_shape": list(img.shape),
                   "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
