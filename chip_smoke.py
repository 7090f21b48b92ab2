#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pea_diffusion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from pea_diffusion_tpu_torch/csrc with nvcc
   (sm_90a), one source into one library;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (bf16 inputs; the plain version in fp32 from the same bf16
   inputs; max |kernel - plain| below 8e-3 of max |plain|, twice the most
   that rounding the output to bf16 can move it), with CUDA-event times of
   the kernel, the plain version and F.scaled_dot_product_attention (a
   yardstick only: the port never calls it), each launch after an L2
   flush, beside the least time the card needs for the same bytes and
   operations;
4. references: the tiny fp32 stack on the card against the same weights
   on the CPU (the path the CPU tests hold against the JAX package), and
   the full-width UNet's attention modules at the main path's shapes
   through the kernels against plain attention;
5. the main path: the full-width SDXL PEA stack (Chinese-CLIP
   RoBERTa-large, the sdxl_chinese_clip adapter, the SDXL UNet and VAE in
   bf16, random weights from a seed) through
   StableDiffusionXLPEAPipeline, with the launch counts set to 0: two
   requests of batch 1 at 1024x1024, DDIM 4 steps, CFG 7.5; every
   attention kernel must have launched 70 x 4 x 2 = 560 times and the
   images must be finite [1, 1024, 1024, 3] in [0, 1];
6. where a request's time goes: CUDA-event times of its stages and a
   torch.profiler trace of one request (device busy time, top kernels; the
   full table is written to build/chip_smoke_profile.txt).

The last lines are the card, a {"kernels": [...]} line and
{"ok": true, "device": {...}}. TF32 is off for matmuls and convolutions.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3 (SXM data sheet)
KERNEL_RTOL = 8e-3          # max|out - ref| / max|ref|: 2x bf16's 2^-8 rounding
MODULE_RTOL = 2e-2          # the same, through the bf16 projections around it
TINY_ATOL = 1e-3            # fp32 tiny stack, card vs CPU (TF32 off)
STEPS, REQUESTS, SIZE, GUIDANCE = 4, 2, 1024, 7.5
ATTN_PER_UNET = 70          # SDXL transformer blocks: 10 at S=4096, 60 at S=1024


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters, flush):
    """Mean CUDA-event time of `fn`, each launch after overwriting a buffer
    larger than L2 so that inputs come from device memory."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def errors(out, ref):
    """Max abs error of `out` against `ref`, and that over max |ref|."""
    err = (out.float() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phases(torch, F):
    from pea_diffusion_tpu_torch.ops import flash_attention, onepass_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    b1 = dict(name="B1 onepass_attention", route="cuda",
              source="pea_diffusion_tpu_torch/csrc/attention_fwd.cu",
              replaces="pea_diffusion_tpu/ops/onepass_attention.py:50")
    b3 = dict(name="B3 flash_attention", route="cuda",
              source="pea_diffusion_tpu_torch/csrc/attention_fwd.cu",
              replaces="pea_diffusion_tpu/ops/flash_attention.py:31")
    cases = [  # (kernel, batch, sq, skv, heads, head_dim, launches per UNet forward, what)
        (b1, 2, 4096, 4096, 10, 64, 10, "main path: self-attention, level 1"),
        (b1, 2, 1024, 1024, 20, 64, 60, "main path: self-attention, level 2"),
        (b1, 2, 1024, 1000, 10, 64, 0, "masked ragged KV"),
        (b1, 2, 1024, 1024, 10, 128, 0, "head_dim 128"),
        (b3, 20, 4096, 52, 1, 64, 10, "main path: cross-attention, level 1"),
        (b3, 40, 1024, 52, 1, 64, 60, "main path: cross-attention, level 2"),
    ]
    entries = []
    for kern, b, sq, skv, h, d, per_forward, what in cases:
        feat = h * d
        if kern is b1:
            q, k, v = randn(b, sq, feat), randn(b, skv, feat), randn(b, skv, feat)
            run = lambda: onepass_attention.onepass_forward(q, k, v, h, d)  # noqa: E731
            plain = lambda: onepass_attention.onepass_forward_ref(  # noqa: E731
                q.float(), k.float(), v.float(), h, d)
            views = [t.view(b, -1, h, d).transpose(1, 2) for t in (q, k, v)]
        else:
            q, k, v = randn(b, sq, d), randn(b, skv, d), randn(b, skv, d)
            run = lambda: flash_attention.flash_forward(q, k, v)  # noqa: E731
            plain = lambda: flash_attention.flash_forward_ref(  # noqa: E731
                q.float(), k.float(), v.float())
            views = [t.unsqueeze(0) for t in (q, k, v)]
        out = run()
        ref = plain()
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        if not rel < KERNEL_RTOL:
            raise AssertionError(f"{kern['name']} {what}: max abs error {err}, "
                                 f"{rel} of max |plain| >= {KERNEL_RTOL}")
        if kern is b3:
            out_l, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
            _, ref_lse = flash_attention.flash_forward_ref(
                q.float(), k.float(), v.float(), with_lse=True)
            lse_err = (lse - ref_lse).abs().max().item()
            if not lse_err < 1e-3 or not torch.equal(out_l, out):
                raise AssertionError(f"B3 lse error {lse_err}")
        del ref
        ms = time_ms(torch, run, 20, flush)
        plain_ms = time_ms(torch, plain, 3, flush)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(*views), 20, flush)
        flops = 4 * b * h * sq * skv * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        entries.append(dict(kern, shape=f"batch={b} sq={sq} skv={skv} heads={h} "
                            f"head_dim={d} bf16", what=what,
                            per_unet_forward=per_forward,
                            max_abs_err=err, max_rel_err=rel,
                            rel_tolerance=KERNEL_RTOL, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms))
        log(f"[kernel] {kern['name']} {what} ({entries[-1]['shape']}): "
            f"err {err:.3g} (rel {rel:.3g}) ms {ms:.4f} plain {plain_ms:.4f} "
            f"sdpa {library_ms:.4f} bound {bound_ms:.4f} ({bound_by})")
    del flush
    return entries


def reference_tiny_stack(torch, build_demo):
    """The tiny fp32 stack on the card against the same weights on the CPU
    (the CPU path is the one the tests hold against the JAX package)."""
    import numpy as np

    from pea_diffusion_tpu_torch.pipelines.text2image import generate_sdxl

    cpu, tokenize, _ = build_demo("cpu")
    gpu, _, _ = build_demo("cuda")
    for name in ("text_encoder", "adapter", "unet", "vae"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    noise = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ids, uncond = tokenize(["一只猫"]), tokenize([""])
    imgs = [generate_sdxl(m, ids, uncond, sampler_name="ddim", height=64,
                          width=64, num_steps=2, guidance_scale=GUIDANCE,
                          init_noise=noise).cpu() for m in (cpu, gpu)]
    err = (imgs[0] - imgs[1]).abs().max().item()
    log(f"[reference] tiny stack, card vs CPU (fp32): max abs {err:.3g}")
    if not err < TINY_ATOL:
        raise AssertionError(f"tiny stack on the card differs from the CPU: {err}")


def reference_attention_modules(torch, models):
    """The full-width UNet's attention modules at the main path's shapes,
    through the kernels and through plain attention (relative max error)."""
    from pea_diffusion_tpu_torch.models.layers import attention_route

    gen = torch.Generator(device="cuda").manual_seed(3)
    ctx = torch.randn(2, 52, 2048, generator=gen, device="cuda").bfloat16()
    for level, block in ((1, models.unet.down_blocks[1]), (2, models.unet.down_blocks[2])):
        blk = block.attentions[0].transformer_blocks[0]
        dim = blk.attn1.to_q.in_features
        s = (64 // level) ** 2
        x = torch.randn(2, s, dim, generator=gen, device="cuda").bfloat16()
        for attn, c in ((blk.attn1, None), (blk.attn2, ctx)):
            route = attention_route(s, s if c is None else 52, attn.num_heads,
                                    attn.head_dim, "auto", "cuda")
            with torch.inference_mode():
                got = attn(x, c).float()
                attn.backend = "xla"
                want = attn(x, c).float()
                attn.backend = "auto"
            _, rel = errors(got, want)
            log(f"[reference] level {level} {route} attention module: "
                f"relative max error {rel:.3g}")
            if not rel < MODULE_RTOL:
                raise AssertionError(f"attention module, level {level} {route}: {rel}")


def main_path(torch, pipe, tokenize, prompts):
    torch.cuda.reset_peak_memory_stats()
    req_s = []
    for i, prompt in enumerate(prompts[:REQUESTS]):
        torch.cuda.synchronize()
        t = time.time()
        imgs = pipe(tokenize([prompt]), tokenize([""]), height=SIZE, width=SIZE,
                    num_steps=STEPS, guidance_scale=GUIDANCE, seed=i)
        torch.cuda.synchronize()
        req_s.append(time.time() - t)
        if tuple(imgs.shape) != (1, SIZE, SIZE, 3):
            raise AssertionError(f"image shape {tuple(imgs.shape)}")
        f = imgs.float()
        if not torch.isfinite(f).all() or f.min() < 0 or f.max() > 1:
            raise AssertionError("image not finite in [0, 1]")
        log(f"[main] request {i}: {req_s[-1]:.4f}s, image mean {f.mean().item():.4f}"
            f" std {f.std().item():.4f}")
    return req_s


def stage_times(torch, models, tokenize, prompt, kernels):
    """CUDA-event times of one request's stages, each the mean of 3 warm runs."""
    from pea_diffusion_tpu_torch.pipelines.text2image import (
        decode_latents, encode_prompt_sdxl, make_add_time_ids)

    dev = models.device
    ids = torch.as_tensor(tokenize([prompt]), device=dev)
    uncond = torch.as_tensor(tokenize([""]), device=dev)
    x = torch.randn((2, SIZE // 8, SIZE // 8, 4), device=dev)
    t = torch.full((2,), 500, device=dev)

    def timed(fn, n=3):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    with torch.inference_mode():
        context, pooled = encode_prompt_sdxl(models, ids, uncond)
        added = {"text_embeds": pooled, "time_ids": make_add_time_ids(
            (SIZE, SIZE), (0, 0), (SIZE, SIZE), 2, dev)}
        enc = timed(lambda: encode_prompt_sdxl(models, ids, uncond))
        unet = timed(lambda: models.unet(x, t, context, added))
        dec = timed(lambda: decode_latents(models, x[:1]))
    attn_ms = sum(e["ms"] * e["per_unet_forward"] for e in kernels)
    log(f"[stages] prompt encoding {enc:.3f} ms; UNet forward of the CFG pair "
        f"{unet:.3f} ms, of which attention kernels ~{attn_ms:.3f} ms (kernel "
        f"ms x launches per forward); VAE decode {dec:.3f} ms")


def profile_request(torch, pipe, tokenize, prompt, repo, request_s):
    """torch.profiler over one request: device busy time against wall time,
    and the kernels that take the most device time. The full table goes to
    build/chip_smoke_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.time()
        pipe(tokenize([prompt]), tokenize([""]), height=SIZE, width=SIZE,
             num_steps=STEPS, guidance_scale=GUIDANCE, seed=7)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(per_kernel.values())
    if busy == 0:
        log("[profile] the profiler saw no device time")
        return
    attn = sum(v for k, v in per_kernel.items() if "attention_fwd_kernel" in k)
    log(f"[profile] one request: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
        f"wall under the profiler; of the unprofiled request ({request_s * 1e3:.1f} ms) "
        f"the device is idle {max(0.0, 1 - busy / (request_s * 1e3)):.3f}; "
        f"B1+B3 kernels {attn:.1f} ms")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {ms:9.2f} ms  {name[:110]}")
    out = repo / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=80))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "pea_diffusion_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no pea_diffusion_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from pea_diffusion_tpu_torch.cli.generate import build_demo, build_demo_full
    from pea_diffusion_tpu_torch.ops import flash_attention, kernel_build, onepass_attention
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    card = card_line()
    log(f"[card] {card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 off for matmul and cudnn")

    for line in kernel_build.build().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    log(f"[build] done in {time.time() - t0:.1f}s")

    kernels = kernel_phases(torch, F)

    reference_tiny_stack(torch, build_demo)

    t1 = time.time()
    models, tokenize, _ = build_demo_full("cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (models.text_encoder, models.adapter,
                                       models.unet, models.vae)
                   for p in m.parameters())
    log(f"[init] full-width stack on the card in {time.time() - t1:.1f}s, "
        f"{n_params / 1e9:.3f}B parameters")
    reference_attention_modules(torch, models)

    pipe = StableDiffusionXLPEAPipeline(models, sampler_name="ddim")
    prompts = ["一只戴着帽子的可爱猫咪", "雪山下的湖泊，清晨的阳光"]
    onepass_attention.onepass_forward.launches = 0
    flash_attention.flash_forward.launches = 0
    req_s = main_path(torch, pipe, tokenize, prompts)
    launches = {"B1 onepass_attention": onepass_attention.onepass_forward.launches,
                "B3 flash_attention": flash_attention.flash_forward.launches}
    want = ATTN_PER_UNET * STEPS * REQUESTS
    log(f"[main] launches {launches} (want {want} each); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the main path, want {want}")
    for e in kernels:
        e["launches"] = launches[e["name"]]

    stage_times(torch, models, tokenize, prompts[0], kernels)
    profile_request(torch, pipe, tokenize, prompts[0], repo, min(req_s))
    log(f"[done] {time.time() - t0:.1f}s")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
