#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pea_diffusion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from pea_diffusion_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all at once, linked into one library;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes: SDXL's head dim 64, SD1.5's 40, 80 and 160 (bf16 inputs;
   the plain version in fp32 from the same bf16 inputs, in chunks of
   (batch, head) rows where its fp32 score matrices would not fit at once).
   The forward rows include the refiner's (B1 at 12 and 24 heads, its
   cross-attention) and SD2.1's at 768² (B3 self-attention at S = 9216 in
   5 heads, B1 at S = 2304, cross-attention over 77 tokens).
   Forward (B1, B3 with and without lse): max |kernel - plain| below 8e-3
   of max |plain|, twice the most that rounding the output to bf16 can move
   it. Backward (B4: dK, dV; B5: dQ): below 2e-2 of max |plain| per
   gradient (P and dS are rounded to bf16 before their products).
   GroupNorm (B6, B6-b): every GroupNorm shape of the SDXL ControlNet path
   (read from the UNet, ControlNet and VAE modules), plus an fp32 and two
   ragged cases, each input contiguous and channels-last, in both variants
   (three_pass; persistent, one cooperative launch), each below 8e-3 of max
   |plain| (the output is rounded to bf16 once), two launches with the same
   bits, the shipped kernel with the bits of the variant the library's rule
   picks, and each variant's time also with its launches queued behind a
   device sleep (the wrapper's host time outside the window).
   CUDA-event times of the kernel, the plain version and a PyTorch
   yardstick (the port never calls it: F.scaled_dot_product_attention for
   the forward, the backward of one such call for B4 + B5 together,
   F.group_norm for the GroupNorm alone), each launch after an L2 flush,
   beside the least time the card needs for the same bytes and operations.
   B1's D = 64 rows run the wgmma + TMA body (attention_fwd_sm90_body.cuh),
   its D = 128 row the mma.sync body. Each B3 row also runs every B3
   variant built at its head dim (flash_forward_variant: the mma.sync body,
   the wgmma body with 1 or 2 warpgroups and K/V tiles of 64 or 128 rows):
   each below 8e-3 of max |plain| with its lse, the shipped one (the
   library's rule) with the shipped B3's bits, every self-attention row at
   Sq = Skv >= 1024 on the wgmma body, and each variant's time beside the
   shipped time. Then the sweep path (S1): the port's
   sweep tool (pea_diffusion_tpu_torch/tools/sweep_onepass.py) runs B1's
   twelve tile variants (eight of the mma.sync body, four of the wgmma
   body) at its b16 and b2 shapes from launch counts of 0; each variant
   must stay below 8e-3 of max |plain| and the shipped variant must give
   shipped B1's bits. Each B4/B5 row likewise runs every variant of B4 and
   of B5 built at its head dim (flash_backward_variant: the mma.sync body,
   the wgmma + TMA body of attention_bwd_sm90_body.cuh with 1 or 2
   warpgroups and streamed tiles of 32, 64 or 128 rows): each below 2e-2
   of max |plain| per gradient, two launches with the same bits, the
   shipped one with the shipped kernel's bits, every self-attention row at
   Sq = Skv >= 1024 on the wgmma body, and each variant's time;
4. references: the tiny fp32 SDXL and SD1.5 stacks on the card against the
   same weights on the CPU (the paths the CPU tests hold against the JAX
   package), and, with each full-width stack, its UNet's attention modules
   at the serving shapes (SDXL 1024²: 640 and 1280 channels in heads of 64;
   SD1.5 512²: 320 and 640 channels in 8 heads of 40 and 80; SD1.5 1024²:
   1280 channels in 8 heads of 160) through the kernels against plain
   attention, outputs and input gradients;
5. the serving paths, with the launch counts set to 0 just before each and
   read just after: the full-width SDXL PEA stack (Chinese-CLIP
   RoBERTa-large, the sdxl_chinese_clip adapter, the SDXL UNet and VAE in
   bf16, random weights from a seed) through StableDiffusionXLPEAPipeline,
   two requests of batch 1 at 1024x1024, DDIM 4 steps, CFG 7.5 (70 B1 and
   70 B3 per UNet forward); then the full-width SD1.5 stack (the same
   tower, sd15_chinese_clip, the SD1.5 UNet and VAE in bf16) through
   StableDiffusionPEAPipeline, two requests at 512², DDIM 20 steps
   (BASELINE config 1), CFG 7.5 (20 B3 per UNet forward, at D = 40 and 80;
   level 2 and the mid block, D = 160 at S <= 256, run plain), and two at
   1024², DDIM 10 (30 B3 per UNet forward: level 0 at S = 16384, D = 40;
   level 1 at 4096, D = 80; level 2 at 1024, D = 160; the mid block plain
   at S = 256). Each kernel
   must have launched as often as the attention dispatch of the UNet's
   modules says, and the images must be finite [1, size, size, 3] in
   [0, 1]; then the stage times and a torch.profiler trace of one request
   (tables in build/chip_smoke_profile.txt,
   build/chip_smoke_sd15_profile.txt and
   build/chip_smoke_sd15_1024_profile.txt). The SDXL stack then runs with the
   fused GroupNorm opt-in (PEA_FUSED_GROUPNORM=1) off and on: one UNet
   forward of the CFG pair against an fp32 forward, warm requests in turns
   for latency, and a profile each way (build/chip_smoke_gn_{off,on}_profile.txt);
   then few-step serving from a model directory (`fewstep_phase`): the SDXL
   stack written in the diffusers / transformers layouts under
   build/fewstep_deployment/ (unet/ and vae/ in bf16 safetensors, a
   trailing-spacing scheduler config, the Chinese-CLIP tower's BERT config
   and weights, proj_0/pytorch_model.bin, and a rank-64 peft LoRA over every
   to_q/to_k/to_v/to_out.0 of the UNet, B nonzero), loaded back through the
   port's loaders (seconds and file sizes logged). Without the LoRA the
   loaded stack must give the written stack's bits (one UNet forward at
   1024², the text tower and adapter on one prompt, every VAE tensor); with
   it, exactly the file's pairs must have moved, each fused weight within
   one bf16 step of bf16(W + B.A) computed here in fp32. Then two paths, two
   requests each from launch counts of 0 (B1 and B3 as the walk gives them
   at batch 1, no CFG): "lcm-lora serving" (the fused UNet, LCM 4 steps,
   1024², guidance 0) and "turbo serving" (the plain loaded UNet, Euler-a
   4 steps on the directory's trailing schedule, 512², guidance 0); the
   same seed must give the same bits and another seed other bits; a profile
   of one request each (build/chip_smoke_{lcm,turbo}_profile.txt). Before
   the directory is deleted, the start-up path (`startup_phase`):
   tools/bench_startup.py in two fresh processes over it, sharing one new
   --aot-cache directory under build/: a cold kernel-library build while
   the weights stream to the card (device_put_streamed beside the
   pipeline's prefetch), then warm with the weights streamed (a third run,
   warm with the weights placed first, is left out to fit the time limit);
   each must build or find the library as
   its name says, resolve the one-pass and flash launchers, and give a
   finite [1, 1024, 1024, 3] image; each logs its phases (import, CUDA
   context, weight load from the page cache, placement and prefetch, first
   and second image). Then int8 serving (`int8_phase`) on the SDXL stack:
   quantize_for_serving at scope int8 (the resnet 3x3s) calibrated on a
   prompt, its ranges written to a file, two 1024² DDIM-4 requests at CFG
   7.5 from launch counts of 0 ("sdxl int8 serving": B1 and B3 as the walk
   gives them, same seed same bits, a profile with the device's idle share,
   build/chip_smoke_int8_profile.txt), the ranges file loaded again giving
   the same bits, the UNet's eps int8 against bf16 (relative L2) and the
   worst five convs' SQNR (printed); the widest scope
   int8:resnet,shortcut,sampler,vae through generate_sdxl with
   split_decode and decode_chunk 2 ("sdxl int8 widest serving", the same
   checks, and a 3-latent decode at once against in chunks, printed); and
   at each conv shape of the path (SDXL's resnet maps 2x320x128²,
   2x640x64², 2x1280x32² at stride 1 and 2, the VAE decoder's 512x128²,
   256x512², 128x1024²) the int8 product against its float64 plain version
   (int32 sums equal) and the int8 conv, the product alone and the bf16
   cuDNN conv it replaces timed with CUDA events (not gated). Then the
   inpainting, ensemble and
   preset paths (`presets_phase`) on the SDXL stack's tower, adapter and
   VAE, each extra UNet built in bf16 from a seed and freed before the
   next, each path two requests of batch 1 at 1024² (DDIM, CFG 7.5) from
   launch counts of 0, as the walk gives them (B1 and B3 only), finite
   images in [0, 1] and the same bits again for the same seed:
   "inpaint 9-channel serving" (SDXL_INPAINT_UNET, 10 steps at strength
   0.85: 9 forwards a request; profile build/chip_smoke_inpaint_profile.txt)
   and "inpaint blend serving" (the serving UNet, strength 0.6: 7
   forwards), a centred square repainted, where the blend's final latents
   outside the mask must equal the image's encoded latents bit for bit and
   a request at strength 0.85 must differ; "sdxl ensemble serving" (the
   base to the cutoff of 0.8: 8 of 10 steps; SDXL_REFINER_UNET with its
   own 1280-d adapter the other 2, aesthetic scores 6.0 / 2.5; its
   attention modules at levels 1 and 2 first held against plain attention
   as in phase 4; profile build/chip_smoke_ensemble_profile.txt);
   "ssd-1b serving" (SSD_1B_UNET through StableDiffusionXLPEAPipeline,
   DDIM 4); stage times of each, the two VAE encodes included; and SD2.1
   (no PEA pipeline in the JAX package): its level-0/1 attention modules at
   768² against plain attention, then one UNet forward of the CFG pair at
   768² over 77 random text states ("sd21 unet forward": level 0's 5 heads
   take B3, level 1 B1); then the towers phase (`towers_phase`): each other
   student family on the SDXL serving stack's UNet and VAE, in turn "mt5
   serving" (MT5_XL, sdxl_mt5), "mul_clip serving" (XLM_ROBERTA_LARGE,
   sdxl_mul_clip), "alt_clip serving" (ALT_CLIP_XLMR_L, sdxl_alt_clip) and
   "mul_zh serving" (XLM-R large and Chinese-CLIP large concatenated,
   sdxl_concat): the family's tiny fp32 tower (T5_TINY, or BERT_TINY at
   the XLM-R or AltCLIP settings) on the card against the CPU (phase 4's
   tolerance); the full-width tower in bf16 and its adapter (fp32 weights)
   from a seed; two 1024² requests of batch 1 (DDIM 4, CFG 7.5) through
   StableDiffusionXLPEAPipeline over 52 ids drawn inside the vocab with a
   padded tail (mul_zh: dict ids of equal length), from launch counts of 0
   (B1 and B3 as the walk gives them), finite images in [0, 1], the same
   bits again for the same seed; the prompt-encoding stage time, the
   tower's parameter count and peak memory, the largest relative gap
   between the bf16 tower's states and an fp32 copy's on the card (printed,
   not gated) and, for mt5 and mul_zh, a profile (build/chip_smoke_{mt5,
   mul_zh}_profile.txt; mul_clip's and alt_clip's, which gave the busy time
   and idle share of the others' XLM-R tower, are cut to fit the time
   limit); each tower freed before the next; then batched
   serving (`batched_serve_phase`, "sdxl batched serving"): the port's HTTP
   server (cli/serve.py, make_server) on 127.0.0.1 over its BatchingEngine
   (up to 8 requests a call, a 150 ms window, DPM++ 30 steps, 1024²) on the
   SDXL serving stack, loaded by the port's client (tools/bench_serve.py:
   one serial warm-up request, a burst of 8, then 16 timed requests from 8
   clients at mixed guidance) from launch counts of 0: every response a
   1024x1024 RGB PNG, fewer engine calls than requests, and B1 and B3 at
   (engine calls) x 30 x 70 each, split by CFG batch (2, 4, 8 or 16: a
   group pads to a power of two) as the walk gives them; requests/s,
   p50/p95 latency, the engine's counters and peak memory; the call with the
   most co-batched requests again through StableDiffusionXLPEAPipeline with
   its ids, noise and guidance, each of its requests' PNGs bit-equal to
   that run's to_pil image, and those inputs at 4 steps under the profiler
   (device busy and idle share; build/chip_smoke_batched_profile.txt);
   one of its requests alone, its
   difference from the co-batched image and from the call's other
   requests printed (not gated), and again through the pipeline at 4
   steps and, with GroupNorm pinned to its grouped form, at 4 (a pinned
   30-step pass is left out to fit the time limit); then
   evaluation (`evaluate_phase`) on the served PNGs: the Chinese-CLIP dual
   tower (ViT-H/14 and RoBERTa-large with their projections, fp32, from a
   seed) written as a Chinese-CLIP directory under build/ and loaded back
   through cli/evaluate.py's load_dual_tower, CLIP-score of the 16 timed
   images against the ids their prompts were served from, CLIP-FID against
   the warm-up and solo images, FID(A, A) in [0, 1e-6), two images' vision
   features and the 16 prompts' text features on the card against the CPU
   (below 1e-4 of max |cpu|) and the two images' cosines with their prompts
   (below 1e-4 apart), load seconds and the tower's ms per 32-image chunk (the directory deleted at
   the end);
6. the SDXL ControlNet path with the opt-in on: the SDXL stack and a
   full-width SDXL ControlNet (random weights, its zero convs filled from
   the seed), the control image the Canny edges of a seeded image, two
   requests of batch 1 at 1024², DDIM 4 steps, CFG 7.5, from launch counts
   of 0 (B1, B3, B6, B6-b as the modules' dispatch gives them: 104 + 104
   attention calls and 67 GroupNorms per UNet + ControlNet forward, 30 per
   VAE decode), a request at conditioning scale 0 that must differ, and a
   guess-mode request's stage times and profile
   (build/chip_smoke_controlnet_profile.txt), in which the GroupNorm kernels
   must be one launch a call where the persistent variant ships (three where
   three_pass does; so too in the opt-in-on SDXL profile of phase 5);
7. the training paths: each full-width KD stack (the serving stack with an
   fp32 adapter and VAE, plus the CLIP teachers: ViT-L and bigG for SDXL,
   ViT-L alone for SD1.5) from cli/train.py's build_demo_full: first one KD
   step's adapter gradient at batch 1, 512², through the kernels against
   plain attention (identical draws, relative L2 error below 5e-2; for
   SDXL also with the GroupNorm opt-in on against off; for SD1.5 also at
   1024² with only the D = 160 calls switched); then KDTrainer.fit for 3
   steps (SDXL at micro-batch 10, 640²; SD1.5 at 40, 512², the reference's
   operating point, and at 8, 1024²) with the launch counts set to 0:
   finite losses, an adapter that moved, every frozen tensor bit-identical
   (checksums), and the launches the dispatch gives (per step: B3 with lse
   twice per student kernel call, forward and recompute; B4 and B5 once
   each; B1 and B3 without lse once per teacher call, whose cross-attention
   reads the teachers' 77 tokens); step time, samples/s, peak memory and a
   torch.profiler trace of one step (tables in
   build/chip_smoke_train_profile.txt,
   build/chip_smoke_sd15_train_profile.txt and
   build/chip_smoke_sd15_1024_train_profile.txt). After the SDXL paths,
   "mul_zh kd step": one kd_loss + backward of the SDXL KD stack with the
   mul_zh tower and the sdxl_concat adapter swapped in (micro-batch 10,
   640², the teachers as there, input_ids and input_ids_zh), from launch
   counts of 0: a finite loss, finite nonzero adapter gradients, and B1,
   B3, B4 and B5 as the walk gives them for one step. Then training from
   webdataset shards (`shards_phase`) on the same stack: 4 shards written
   under build/chip_smoke_shards/ from seed 0 (10 JPEGs in each of the
   buckets 640x640, 768x512, 448x896 and 832x448, Chinese-native and
   parallel captions in each, and 8 samples the quality filters drop), the
   loader's host samples/s at 1 and 4 decode threads, then one pass of
   make_train_iterator (micro-batch 10, 4 decode threads, the native C++
   reader) through the card's prefetcher: KDTrainer.warmup of each bucket
   ("sdxl shards warmup") and KDTrainer.fit of one step a bucket ("sdxl
   shards training", the last step traced by its profiler window), each
   from launch counts of 0 and as the walk at the bucket's (h, w) latents
   gives them (level-1 self-attention at S = 1600, 1536, 1568, 1456); every
   batch single-bucket with its shape and time ids and both zh_or_not
   values, the filtered samples absent, the native reader the only one,
   finite losses, a moved adapter, bit-identical frozen tensors, the trace
   file; warmup and step seconds per bucket, samples/s, peak memory beside
   the 640²-only path's, and the traced step's device busy time and idle
   share. Then on the 640² batch with the same draws, kd_loss + adapter
   gradient twice each (the second timed) of the remat policies "full",
   "blocks" (B3 with lse three times a student call) and "dots" (peak
   memory, time, the gradient's max difference from "full" below 1e-2 of
   its max) and of bfloat16 feature taps (printed, not gated).

The last lines are the card, a {"kernels": [...]} line and
{"ok": true, "device": {...}}. Each row of the kernels line is one kernel at
one shape (B3 rows with or without lse); its launches on a path are those of
the path's attention calls at that shape (the dispatch's calls times
PER_CALL of the caller's role) or, for B6/B6-b, of the path's GroupNorm
calls at that shape (groupnorm_calls), and the rows of a kernel must add up to the
launches its wrapper counted on the path; check rows (long sequence,
ragged, D=128, the GroupNorm's fp32 and ragged cases) that no path runs
show 0; an S1 row's launches are those of its variant at its shape on the
sweep path. TF32 is off for matmuls and convolutions. Every path but the
ControlNet's runs with the GroupNorm opt-in off and must launch no B6/B6-b.
"""
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (SXM data sheet)
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3 (SXM data sheet)
H100_EXP2_PER_S = 132 * 16 * 1.98e9  # MUFU: 16 a cycle an SM, 132 SMs, 1.98 GHz boost
KERNEL_RTOL = 8e-3          # max|out - ref| / max|ref|: 2x bf16's 2^-8 rounding
LSE_ATOL = 1e-3             # B3's fp32 lse against the plain one (fp32 sums)
BWD_RTOL = 2e-2             # the same per gradient: P and dS rounded to bf16 too
MODULE_RTOL = 2e-2          # the same, through the bf16 projections around it
KD_GRAD_RTOL = 5e-2         # adapter gradient, kernels vs plain attention (rel. L2)
TINY_ATOL = 1e-3            # fp32 tiny stack, card vs CPU (TF32 off)
REQUESTS, GUIDANCE, TRAIN_STEPS = 2, 7.5, 3
TEXT_TOKENS = 52            # the student tower's prompt length
TEACHER_TOKENS = 77         # the CLIP teachers'
SD15_HEADS = 8
PLAIN_SCORES = 2**29        # fp32 score elements per chunk of a plain version
SRC = "pea_diffusion_tpu_torch/csrc/"

# The serving paths: model, image side, DDIM steps, the down levels whose
# attention modules are held against plain attention, the profile table.
# SDXL's 4 steps are cut from 30 to fit the time limit; SD1.5's 512² DDIM-20
# is BASELINE config 1; SD1.5 at 1024² (the one path that runs the flash
# kernels at D = 160) is cut from 20 steps to 10.
SERVING = {
    "sdxl serving": dict(model="sdxl", size=1024, steps=4, levels=(1, 2),
                         table="chip_smoke_profile.txt"),
    "sd15 serving": dict(model="sd15", size=512, steps=20, levels=(0, 1),
                         table="chip_smoke_sd15_profile.txt"),
    "sd15 1024 serving": dict(model="sd15", size=1024, steps=10, levels=(2,),
                              table="chip_smoke_sd15_1024_profile.txt"),
}
# The training paths: model, micro-batch, image side, profile table, and
# the head dim whose attention calls alone one KD step's adapter gradient
# switches between the kernels and plain attention at the path's size (the
# model's other reference step switches all of them at 512²). SD1.5's
# 40 at 512² is the reference's train_sd_zh.py micro-batch; at 1024² it
# trains 8 a step (8.4 M pixels against 40 x 512²'s 10.5 M; BH 64 in 8
# heads).
TRAINING = {
    "sdxl training": dict(model="sdxl", batch=10, size=640,
                          table="chip_smoke_train_profile.txt"),
    "sd15 training": dict(model="sd15", batch=40, size=512,
                          table="chip_smoke_sd15_train_profile.txt"),
    "sd15 1024 training": dict(model="sd15", batch=8, size=1024, check_head_dim=160,
                               table="chip_smoke_sd15_1024_train_profile.txt"),
}
SD15_TRAIN_BH = TRAINING["sd15 training"]["batch"] * SD15_HEADS
SD15_1024_TRAIN_BH = TRAINING["sd15 1024 training"]["batch"] * SD15_HEADS
SD15_1024_SERVING_BH = 2 * SD15_HEADS  # the CFG pair
CONTROLNET_PATH = "sdxl controlnet serving"
# Few-step serving from a model directory: image side, sampler, steps (the
# reference operating points: LCM-LoRA and SDXL-Turbo at 4 steps, no CFG),
# whether the UNet has the LoRA fused, the profile table.
FEWSTEP = {
    "lcm-lora serving": dict(size=1024, sampler="lcm", steps=4, lora=True,
                             table="chip_smoke_lcm_profile.txt"),
    "turbo serving": dict(size=512, sampler="euler_a", steps=4, lora=False,
                          table="chip_smoke_turbo_profile.txt"),
}
LCM_PATH, TURBO_PATH = FEWSTEP
LORA_RANK = 64
# The inpainting, ensemble and preset paths (`presets_phase`, after the
# few-step phase): the SDXL serving stack's tower, adapter and VAE, each
# extra UNet in bf16 from a seed and freed before the next; 1024², DDIM
# (10 steps, cut from 30; SSD-1B 4, as SDXL serving), CFG 7.5. Inpainting
# repaints a centred square of half the side; the 4-channel blend must
# keep the rest of the image's latents bit for bit and differ at
# `other_strength`. The ensemble's base denoises down to the cutoff of
# HIGH_NOISE_FRAC, the refiner (its own 1280-d adapter: the
# sdxl_chinese_clip projector with the refiner's text width) the rest.
INPAINT_9CH, INPAINT_BLEND = "inpaint 9-channel serving", "inpaint blend serving"
ENSEMBLE_PATH, SSD_1B_PATH = "sdxl ensemble serving", "ssd-1b serving"
SD21_PATH = "sd21 unet forward"
PRESET_SIZE, PRESET_STEPS, SSD_1B_STEPS = 1024, 10, 4
INPAINT = {
    INPAINT_9CH: dict(unet="SDXL_INPAINT_UNET", strength=0.85,
                      table="chip_smoke_inpaint_profile.txt"),
    INPAINT_BLEND: dict(unet=None, strength=0.6, other_strength=0.85),
}
HIGH_NOISE_FRAC = 0.8
ENSEMBLE_TABLE = "chip_smoke_ensemble_profile.txt"
REFINER_ADAPTER = dict(in_dim=1024, projector_dims=(1024, 1024, 1280), head_dim=1280)
# SD2.1 (no PEA adapter or pipeline in the JAX package): its attention
# modules and one UNet forward of the CFG pair at 768² over OpenCLIP-H's 77
# tokens; level 0's 5 heads fail the one-pass gate and take B3.
SD21_SIZE, SD21_TOKENS = 768, 77
# The other student towers (`towers_phase`, after the presets phase): each
# family's tower at full width in bf16 with its adapter preset (fp32
# weights), from a seed, on the SDXL serving stack's UNet and VAE; two
# 1024² requests of batch 1, DDIM 4, CFG 7.5 (as SDXL serving), over 52
# ids drawn inside the tower's vocab with a padded tail (mul_zh: one row of
# each vocab, the same length). The tiny form of each tower (fp32) is held
# on the card against the CPU first. A path with a `table` is profiled;
# mul_clip's and alt_clip's are not, to fit the time limit (their XLM-R
# towers gave the busy time and idle share of mt5's and mul_zh's).
TOWERS = {
    "mt5 serving": dict(family="mt5", text=("MT5_XL",), tiny=("T5_TINY",),
                        adapter="sdxl_mt5", table="chip_smoke_mt5_profile.txt"),
    "mul_clip serving": dict(family="mul_clip", text=("XLM_ROBERTA_LARGE",),
                             tiny=("XLMR_TINY",), adapter="sdxl_mul_clip"),
    "alt_clip serving": dict(family="alt_clip", text=("ALT_CLIP_XLMR_L",),
                             tiny=("ALT_CLIP_TINY",), adapter="sdxl_alt_clip"),
    "mul_zh serving": dict(family="mul_zh", text=("XLM_ROBERTA_LARGE", "CHINESE_CLIP_LARGE"),
                           tiny=("XLMR_TINY", "BERT_TINY"), adapter="sdxl_concat",
                           table="chip_smoke_mul_zh_profile.txt"),
}
TOWER_STEPS = 4
TOWER_PROMPT_LENGTHS = (24, 37)  # tokens before the padded tail, request 0 and 1
# The tiny towers' extra settings (BERT_TINY's sizes): XLM-R's pad id 1, one
# token type, RoBERTa positions; AltCLIP's also a 24-d head.
TINY_TOWER_SETTINGS = {
    "XLMR_TINY": dict(type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
                      max_position_embeddings=514, roberta_position_ids=True),
    "ALT_CLIP_TINY": dict(type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
                          max_position_embeddings=514, roberta_position_ids=True,
                          project_dim=24),
}
# One kd_loss + backward of the SDXL training path's KD stack (micro-batch
# 10, 640², the teachers as there) with the mul_zh tower and sdxl_concat
# adapter swapped in and dict ids (`mul_zh_kd_step`, in the training phase).
MUL_ZH_KD_PATH = "mul_zh kd step"
# Batched serving (`batched_serve_phase`, after the towers phase, on the
# SDXL serving stack): the port's HTTP server (cli/serve.py) on 127.0.0.1,
# its BatchingEngine co-batching up to 8 requests in a 150 ms window, DPM++
# at 1024², driven by the port's load client (tools/bench_serve.py): 8
# clients, 16 timed requests of 30 steps (the serve CLI's and the reference
# client's default) with mixed guidance, after one serial warm-up request
# and one burst of 8 (16 timed, not 24, to fit the time limit). A group of n requests pads to a power of two, so the
# UNet runs the CFG pair at batch 2, 4, 8 or 16. The profiled call runs the
# largest co-batched group's inputs at 4 steps (SDXL serving's profile is of
# DDIM 4): the profiler's tables of a 30-step call took 149.6 s on the chip
# machine's host.
BATCHED_PATH = "sdxl batched serving"
BATCHED = dict(clients=8, requests=16, steps=30, warmup=1, max_batch=8, window_ms=150,
               sampler="dpm++", table="chip_smoke_batched_profile.txt", profile_steps=4)
BATCHED_PADDED = (2, 4, 8)  # padded groups with their own kernel rows (1: SDXL serving's)
# Int8 serving (`int8_phase`, after the few-step phase, on the SDXL serving
# stack): quant/int8.py's quantize_for_serving at scope "int8" (the resnet
# 3x3s), calibrated on PROMPTS[0] and written to a ranges file, then
# REQUESTS 1024² DDIM-4 requests at CFG 7.5 ("sdxl int8 serving"); the
# same ranges file loaded again must give the same bits; then the widest
# scope with the VAE decoder ("sdxl int8 widest serving", generate_sdxl
# with split_decode and decode_chunk 2). The int8 product is held against
# its float64 plain version (exact int32 sums) and timed against the bf16
# cuDNN conv it replaces at each conv shape of the path: (batch, channels,
# side, stride), SDXL's resnet maps in the CFG pair and the VAE decoder's
# at batch 1.
INT8_PATH, INT8_WIDE_PATH = "sdxl int8 serving", "sdxl int8 widest serving"
INT8_WIDE = "int8:resnet,shortcut,sampler,vae"
INT8_DECODE_CHUNK = 2
INT8_CONV_SHAPES = ((2, 320, 128, 1), (2, 640, 64, 1), (2, 1280, 32, 1),
                    (2, 320, 128, 2), (2, 640, 64, 2), (2, 1280, 32, 2),
                    (1, 512, 128, 1), (1, 256, 512, 1), (1, 128, 1024, 1))
INT8_TABLE = "chip_smoke_int8_profile.txt"
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak (SXM data sheet)
# Start-up (`startup_phase`, inside the few-step phase while its deployment
# is on disk): tools/bench_startup.py in fresh processes over that
# directory, one kernel-library cache for both: a cold build with the
# weights streamed meanwhile, then warm with the weights streamed (warm
# with the weights placed first, `--serial`, is left out to fit the time
# limit).
STARTUP_RUNS = (("cold, overlapped", "cold", ()), ("warm, overlapped", "warm", ()))
STARTUP_TIMEOUT = 240      # seconds a start-up process may take
# Evaluation (`evaluate_phase`, after batched serving, on its PNGs): the
# Chinese-CLIP dual tower at full width (ViT-H/14 and RoBERTa-large with
# their 1024-d projections) in fp32 from a seed, written as a Chinese-CLIP
# directory and loaded back through the evaluate CLI's loader; two images'
# vision features and every prompt's text features on the card against the
# same weights on the CPU within EVAL_RTOL of max |cpu| (TF32 off: fp32 sums
# in another order over 32 and 24 layers), the two images' cosines with
# their prompts (CLIP-score before its clamp at 0) within COSINE_ATOL, and
# FID(A, A) below FID_SELF_TOL (fp64 on the host; eps = 1e-6 on both
# covariances leaves rounding only).
EVAL_SEED = 31
EVAL_RTOL = 1e-4
COSINE_ATOL = 1e-4
FID_SELF_TOL = 1e-6
CLIP_VISION_CONFIG = {
    "hidden_size": 1280, "image_size": 224, "patch_size": 14, "num_hidden_layers": 32,
    "num_attention_heads": 16, "intermediate_size": 5120, "hidden_act": "quick_gelu",
    "layer_norm_eps": 1e-5,
}
# Training from webdataset shards (`shards_phase`, in the SDXL training
# phase, on its stack): 4 shards written under build/ from seed 0, 10 JPEGs
# in each of four aspect buckets ({bucket id: the source image's w x h, each
# 1.25x its bucket's sides}) and SHARDS_FILTERED samples the quality filters
# drop; one pass of make_train_iterator at micro-batch 10 through the card's
# prefetcher: the warmup of those buckets, then one fit step a bucket, the
# last step profiled (its trace is written when fit returns, after the
# timed steps). Level-1 self-attention runs at S = 1600, 1536, 1568
# and 1456 (level 2 at 364-400, plain).
SHARDS_PATH, SHARDS_WARMUP = "sdxl shards training", "sdxl shards warmup"
SHARD_BUCKETS = {4: (800, 800), 6: (960, 640), 0: (560, 1120), 7: (1040, 560)}
SHARDS_FILTERED = 8
SHARDS_BATCH, SHARDS_WORKERS = 10, 4
SHARDS_PROFILE_STEP = len(SHARD_BUCKETS) - 1
LOADER_EPOCHS = 3           # passes over the shards per loader timing
REMAT_GRAD_RTOL = 1e-2      # adapter gradient, a remat policy vs "full" (of max |full|)
# The deployment's config files, as diffusers and transformers write them
# for SDXL-base, SDXL-Turbo's scheduler and the Chinese-CLIP RoBERTa-large
# text tower (BERT layout).
SDXL_UNET_CONFIG = {
    "_class_name": "UNet2DConditionModel", "act_fn": "silu",
    "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
    "attention_head_dim": [5, 10, 20], "block_out_channels": [320, 640, 1280],
    "cross_attention_dim": 2048,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4, "layers_per_block": 2,
    "mid_block_type": "UNetMidBlock2DCrossAttn", "norm_num_groups": 32, "out_channels": 4,
    "projection_class_embeddings_input_dim": 2816, "sample_size": 128,
    "transformer_layers_per_block": [1, 2, 10],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "use_linear_projection": True,
}
SDXL_VAE_CONFIG = {
    "_class_name": "AutoencoderKL", "act_fn": "silu", "block_out_channels": [128, 256, 512, 512],
    "down_block_types": ["DownEncoderBlock2D"] * 4, "force_upcast": True, "in_channels": 3,
    "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 32, "out_channels": 3,
    "sample_size": 1024, "scaling_factor": 0.13025, "up_block_types": ["UpDecoderBlock2D"] * 4,
}
TURBO_SCHEDULER_CONFIG = {
    "_class_name": "EulerAncestralDiscreteScheduler", "beta_end": 0.012,
    "beta_schedule": "scaled_linear", "beta_start": 0.00085, "num_train_timesteps": 1000,
    "prediction_type": "epsilon", "steps_offset": 1, "timestep_spacing": "trailing",
}
CHINESE_CLIP_TEXT_CONFIG = {
    "architectures": ["BertModel"], "model_type": "bert", "hidden_act": "gelu",
    "hidden_size": 1024, "intermediate_size": 4096, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "num_attention_heads": 16, "num_hidden_layers": 24,
    "pad_token_id": 0, "type_vocab_size": 2, "vocab_size": 21128,
}
PROMPTS = ["一只戴着帽子的可爱猫咪", "雪山下的湖泊，清晨的阳光"]
SWEEP_PATH = "onepass sweep"
SWEEP_SHAPES, SWEEP_ITERS = "b16,b2", 20
QUEUE_SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's 1.98 GHz: the host queues the launches
# Multi-GPU. (a) `fsdp_phase`, at the end of the SDXL training phase on its
# stack: one process joins a world of size 1 over NCCL (initialize() from
# torchrun's environment variables), make_mesh((1, 1)), and KDTrainer takes
# FSDP_STEPS fit steps at the reference point (micro-batch 10, 640²) with
# the adapter gradient reduced over the data group (shard_params wraps
# nothing at fsdp 1, as the JAX rule replicates); then the UNet goes under
# FSDP2 itself (fully_shard_unet), its adapter gradient against the
# unwrapped one on the same draws (KD_GRAD_RTOL, beside the unwrapped stack
# against itself), and FSDP_STEPS more steps. (b) `multigpu_phase`, last: two
# ranks of this script (--multigpu-rank) share the card over gloo (NCCL
# takes one rank a card): TP = 2 on the SDXL serving UNet at 1024² (its
# forward and the unsharded bf16 forward against an fp32 one; collectives
# per forward against the layout's count), two requests of cli/generate.py
# --tp 2 (DDIM TP_STEPS, CFG 7.5) against --tp 1's images, with the
# GroupNorm opt-in off and on, and a data = 2 KD step at 640², 2 rows a
# rank, against one process's step on the 4 rows with the same draws
# (DATA2_RTOL), beside two readings of that one process: the floor, its
# step on the same rows and draws as two 2-row micro-batches
# (grad_accum_steps 2, the ranks' shapes; the UNet's GroupNorm and GEMMs
# pick their forms by batch), which data = 2 must equal (DATA2_ACCUM_RTOL),
# and a planted fault, rank 0's 2-row step with no reduce, which
# DATA2_RTOL must refuse. Two ranks on one card measure no scaling: their
# times are labelled so.
FSDP_PATH = "sdxl fsdp kd training"
FSDP_STEPS = 2
TP_PATH, TP_GN_PATH = "sdxl tp2 serving", "sdxl tp2 serving, fused gn"
DATA2_PATH = "sdxl data2 kd step"
TP, TP_STEPS, TP_SEED = 2, 4, 3
DATA2_ROWS, DATA2_SEED = 2, 17  # rows a rank; the shared generator's seed
# the adapter's first moment, data = 2 against one process, of its max. On
# the 4 rows at once: between the floor (7.52e-3) and the planted fault
# (7.692e-2), both in the run before this bound was set (PERF.md §6).
DATA2_RTOL = 2.5e-2
# As 2 micro-batches of 2 rows: the ranks' shapes and draws, and the reduce's
# fp32 sum of two addends is the accumulation's, so the bits are equal (0 in
# that run); the bound leaves an fp32 rounding.
DATA2_ACCUM_RTOL = 1e-6
MULTIGPU_TIMEOUT = 480      # seconds the two ranks may take


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


def queued_ms(torch, fn, iters, flush):
    """time_ms with every launch queued behind a device sleep of
    QUEUE_SLEEP_CYCLES, so that the host's time to issue the launches (the
    wrapper's Python and ctypes) falls outside the timed windows: the
    device time of `fn` alone, each launch after an L2 flush."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def ptxas_lines(log_text):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name,
    element type and integer and bool template arguments (head dim and tile
    shape for the attention kernels; the wgmma body's warpgroups, stages and
    TMA; the GroupNorm's vector width and, for the persistent variant,
    channels-last), registers, static shared memory (the persistent
    GroupNorm's ring is dynamic: its bytes are in its kernel rows), and
    spill stores and loads; and any line of ptxas's about
    wgmma (a warning that it serialised a kernel's wgmma instructions) as
    it stands."""
    import re

    lines, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "wgmma." in line or "serializ" in line:  # not the kernel's mangled name
            lines.append(line.strip())
            continue
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = rest = entry.group(1)
            if rest.startswith("_ZN"):  # pea::[ns::]kernel<T, ints...>(params)
                rest, parts = rest[3:], []
                while (ident := re.match(r"(\d+)", rest)):
                    n, rest = int(ident.group(1)), rest[ident.end():]
                    parts.append(rest[:n])
                    rest = rest[n:]
                kind = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}.get(
                    re.match(r"(?:I(13__nv_bfloat16|6__half|f))?", rest).group(1), "")
                args = re.findall(r"L[ib](\d+)E", rest)
                name = f"{'::'.join(parts[1:])}<{','.join(filter(None, [kind] + args))}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {regs} registers, {smem.group(1) if smem else 0} bytes "
                         f"static smem; {spill}")
            name, spill = None, ""
    return lines


def persistent_smem_line(torch):
    """The persistent GroupNorm's dynamic shared memory (its ring, fold
    buffer and mbarriers, set per launch by the plan) at the GroupNorm
    shapes of the paths, channels-last, on this card's SMs."""
    from pea_diffusion_tpu_torch.ops import groupnorm as gn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem = {}
    for _, b, c, h, w, groups, _, dtype, _, _ in groupnorm_cases():
        size = torch.empty((), dtype=dtype).element_size()
        plan = gn.persistent_plan(b, c, h * w, groups, True,
                                  gn.vector_width(c // groups, size, 0), size, sms)
        smem[f"{b}x{c}x{h}x{w}"] = (plan.smem, plan.resident)
    lo, hi = min(v[0] for v in smem.values()), max(v[0] for v in smem.values())
    return (f"gn::gn_persistent dynamic shared memory a block: {lo}-{hi} bytes at the "
            f"GroupNorm shapes (at most {gn.SMEM_MAX}; {gn.P_THREADS} threads, one block an "
            f"SM on {sms} SMs); resident maps: "
            + ", ".join(k for k, (_, res) in smem.items() if res))


def errors(out, ref):
    """Max abs error of `out` against `ref`, and that over max |ref|."""
    err = (out.float() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def bound(flops, nbytes, peak=H100_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chunked(torch, fn, scores_per_row, budget, *tensors):
    """`fn` over row chunks (dim 0) of `tensors`, each chunk holding at most
    `budget` fp32 score elements, its outputs concatenated: a plain version
    over (batch, head) rows whose fp32 score matrices would not fit at once."""
    n = max(1, budget // scores_per_row)
    outs = [fn(*(t[i:i + n] for t in tensors)) for i in range(0, tensors[0].shape[0], n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


KERNELS = {
    "B1": dict(name="B1 onepass_attention", route="cuda",
               source=SRC + "attention_fwd_sm90_body.cuh",
               replaces="pea_diffusion_tpu/ops/onepass_attention.py:50"),
    "B3": dict(name="B3 flash_attention", route="cuda", source=SRC + "attention_fwd_sm90_body.cuh",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:31"),
    "B4": dict(name="B4 flash_backward_dkdv", route="cuda",
               source=SRC + "attention_bwd_sm90_body.cuh",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:156"),
    "B5": dict(name="B5 flash_backward_dq", route="cuda",
               source=SRC + "attention_bwd_sm90_body.cuh",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:203"),
    "B6": dict(name="B6 group_norm", route="cuda", source=SRC + "groupnorm_sm90.cu",
               replaces="pea_diffusion_tpu/ops/groupnorm.py:126"),
    "B6-b": dict(name="B6-b group_norm with bias", route="cuda",
                 source=SRC + "groupnorm_sm90.cu",
                 replaces="pea_diffusion_tpu/ops/groupnorm.py:131"),
    "S1": dict(name="S1 onepass_attention tile variant", route="cuda",
               source=SRC + "attention_fwd.cu", replaces="tools/sweep_onepass.py:50"),
}
GN_KERNELS = ("B6", "B6-b")


# Kernel launches per attention call of each route (models.layers.
# attention_route), by the caller's role. Serving runs the UNet without
# gradients. A training step runs the teacher UNet without gradients (B1;
# B3 without lse) and the student UNet under full remat, each call's
# forward twice (forward and recompute): through the autograd Functions
# (B3 with lse, then B4 and B5 once) where its inputs depend on the
# adapter, without them (B1; B3 without lse) where they do not.
PER_CALL = {
    "serving": {"B1": {"onepass": 1}, "B3": {"flash": 1}},
    "student": {"B3": {"onepass": 2, "flash": 2}, "B3 with lse": {"onepass": 2, "flash": 2},
                "B4": {"onepass": 1, "flash": 1}, "B5": {"onepass": 1, "flash": 1}},
    "student, no gradient": {"B1": {"onepass": 2}, "B3": {"flash": 2}},
    "teacher": {"B1": {"onepass": 1}, "B3": {"flash": 1}},
    # the "blocks" remat policy (shards phase A/B): every attention call sits
    # in a transformer block segment nested in a unit segment, so its
    # forward runs three times (forward, the unit's recompute, the block's)
    "student, blocks": {"B3": {"onepass": 3, "flash": 3},
                        "B3 with lse": {"onepass": 3, "flash": 3},
                        "B4": {"onepass": 1, "flash": 1}, "B5": {"onepass": 1, "flash": 1}},
}
COUNTERS = ("B1", "B3", "B3 with lse", "B4", "B5", "B6", "B6-b")


def _check(name, what, outs, refs, rtol):
    """Max abs error and max relative error over the outputs; raises if
    any output's error over its max |plain| reaches `rtol`."""
    worst_abs, worst_rel = 0.0, 0.0
    for out, ref in zip(outs, refs):
        err, rel = errors(out, ref)
        if not rel < rtol:
            raise AssertionError(f"{name} {what}: max abs error {err}, {rel} of "
                                 f"max |plain| >= {rtol}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def shards_t(key):
    """The shards path's warmup and fit steps run the same shapes."""
    return {SHARDS_PATH: key, SHARDS_WARMUP: key}


def sdxl_t(key):
    """SDXL training, the mul_zh KD step, the shards path's 640² bucket, the
    FSDP steps and a data-parallel rank's step run the same shapes (the
    rows' batch 2 is a data rank's)."""
    return dict({"sdxl training": key, MUL_ZH_KD_PATH: key, FSDP_PATH: key, DATA2_PATH: key},
                **shards_t(key))


def tp_s(key):
    """The TP = 2 serving paths (opt-in off and on) run the same shapes."""
    return {TP_PATH: key, TP_GN_PATH: key}


def shard_bucket_shapes():
    """(bucket id, (w, h), level-1 sequence) of each bucket of the shards
    path other than 640², whose shapes are SDXL training's."""
    from pea_diffusion_tpu_torch.data.buckets import BUCKETS

    out = []
    for b in SHARD_BUCKETS:
        w, h = BUCKETS[b]
        if (w, h) != (640, 640):
            out.append((b, (w, h), (h // 16) * (w // 16)))
    return out


def forward_cases():
    """(kernel, batch, sq, skv, heads, head_dim, with lse, {path: (route, sq,
    skv)}, what). B3 rows are head-major: batch is B*H, heads 1."""
    sd15_s, sd15_t = "sd15 serving", "sd15 training"

    def sdxl_s(key, heads):
        """SDXL serving, the ControlNet, inpainting, SSD-1B and towers paths
        and the ensemble's base run the same shapes; the ensemble's keys
        carry the heads, which tell the base's calls from the refiner's."""
        paths = ("sdxl serving", CONTROLNET_PATH, INPAINT_9CH, INPAINT_BLEND,
                 SSD_1B_PATH, INT8_PATH, INT8_WIDE_PATH) + tuple(TOWERS)
        return dict({path: key for path in paths}, **{ENSEMBLE_PATH: key + (heads,),
                                                      BATCHED_PATH: key + (2,)})

    cases = [
        ("B1", 2, 4096, 4096, 10, 64, False, sdxl_s(("onepass", 4096, 4096), 10),
         "SDXL serving (ControlNet, inpainting, SSD-1B, ensemble base): self-attention, "
         "level 1"),
        ("B1", 2, 1024, 1024, 20, 64, False, sdxl_s(("onepass", 1024, 1024), 20),
         "SDXL serving (ControlNet, inpainting, SSD-1B, ensemble base): self-attention, "
         "level 2"),
        ("B1", 10, 1600, 1600, 10, 64, False, sdxl_t(("onepass", 1600, 1600)),
         "SDXL training teacher (and the mul_zh KD step's): self-attention, level 1"),
        ("B1", 1, 4096, 4096, 10, 64, False, {LCM_PATH: ("onepass", 4096, 4096)},
         "LCM-LoRA 1024², no CFG: self-attention, level 1"),
        ("B1", 1, 1024, 1024, 20, 64, False, {LCM_PATH: ("onepass", 1024, 1024)},
         "LCM-LoRA 1024², no CFG: self-attention, level 2"),
        ("B1", 1, 1024, 1024, 10, 64, False, {TURBO_PATH: ("onepass", 1024, 1024)},
         "Turbo 512², no CFG: self-attention, level 1"),
        ("B1", 2, 4096, 4096, 12, 64, False, {ENSEMBLE_PATH: ("onepass", 4096, 4096, 12)},
         "SDXL refiner (ensemble): self-attention, level 1"),
        ("B1", 2, 1024, 1024, 24, 64, False, {ENSEMBLE_PATH: ("onepass", 1024, 1024, 24)},
         "SDXL refiner (ensemble): self-attention, level 2"),
        ("B1", 2, 2304, 2304, 10, 64, False, {SD21_PATH: ("onepass", 2304, 2304)},
         "SD2.1 768²: self-attention, level 1"),
        ("B1", 2, 1024, 1000, 10, 64, False, {}, "masked ragged KV"),
        ("B1", 2, 1024, 1024, 10, 128, False, {}, "head_dim 128"),
        ("B3", 20, 4096, 52, 1, 64, False, sdxl_s(("flash", 4096, 52), 10),
         "SDXL serving (ControlNet, inpainting, SSD-1B, ensemble base): cross-attention, "
         "level 1"),
        ("B3", 40, 1024, 52, 1, 64, False, sdxl_s(("flash", 1024, 52), 20),
         "SDXL serving (ControlNet, inpainting, SSD-1B, ensemble base): cross-attention, "
         "level 2"),
        ("B3", 24, 4096, 52, 1, 64, False, {ENSEMBLE_PATH: ("flash", 4096, 52, 12)},
         "SDXL refiner (ensemble): cross-attention, level 1"),
        ("B3", 48, 1024, 52, 1, 64, False, {ENSEMBLE_PATH: ("flash", 1024, 52, 24)},
         "SDXL refiner (ensemble): cross-attention, level 2"),
        ("B3", 10, 9216, 9216, 1, 64, False, {SD21_PATH: ("flash", 9216, 9216)},
         "SD2.1 768²: self-attention, level 0 (5 heads: no one-pass kernel)"),
        ("B3", 10, 9216, SD21_TOKENS, 1, 64, False, {SD21_PATH: ("flash", 9216, SD21_TOKENS)},
         "SD2.1 768²: cross-attention, level 0"),
        ("B3", 20, 2304, SD21_TOKENS, 1, 64, False, {SD21_PATH: ("flash", 2304, SD21_TOKENS)},
         "SD2.1 768²: cross-attention, level 1"),
        ("B3", 10, 4096, 52, 1, 64, False, {LCM_PATH: ("flash", 4096, 52)},
         "LCM-LoRA 1024², no CFG: cross-attention, level 1"),
        ("B3", 20, 1024, 52, 1, 64, False, {LCM_PATH: ("flash", 1024, 52)},
         "LCM-LoRA 1024², no CFG: cross-attention, level 2"),
        ("B3", 10, 1024, 52, 1, 64, False, {TURBO_PATH: ("flash", 1024, 52)},
         "Turbo 512², no CFG: cross-attention, level 1"),
        ("B3", 20, 1600, 52, 1, 64, True, sdxl_t(("flash", 1600, 52)),
         "SDXL training student (and mul_zh KD): cross-attention, level 1, batch 2"),
        ("B3", 20, 1600, 77, 1, 64, False, sdxl_t(("flash", 1600, 77)),
         "SDXL training teacher (and mul_zh KD): cross-attention, level 1, batch 2"),
        ("B3", 20, 1600, 1600, 1, 64, True, sdxl_t(("onepass", 1600, 1600)),
         "SDXL training student (and mul_zh KD): self-attention (head-major), batch 2"),
        ("B3", 16, 4096, 4096, 1, 40, False, {sd15_s: ("flash", 4096, 4096)},
         "SD1.5 serving: self-attention, level 0"),
        ("B3", 16, 4096, 52, 1, 40, False, {sd15_s: ("flash", 4096, 52)},
         "SD1.5 serving: cross-attention, level 0"),
        ("B3", 16, 1024, 1024, 1, 80, False, {sd15_s: ("flash", 1024, 1024)},
         "SD1.5 serving: self-attention, level 1"),
        ("B3", 16, 1024, 52, 1, 80, False, {sd15_s: ("flash", 1024, 52)},
         "SD1.5 serving: cross-attention, level 1"),
        ("B3", 10, 4096, 4096, 1, 64, False, tp_s(("flash", 4096, 4096)),
         "SDXL TP = 2 serving, a rank's 5 of 10 heads (B1 takes even counts at D = 64): "
         "self-attention, level 1"),
        ("B1", 2, 1024, 1024, 10, 64, False, tp_s(("onepass", 1024, 1024)),
         "SDXL TP = 2 serving, a rank's 10 of 20 heads: self-attention, level 2"),
        ("B3", 10, 4096, 52, 1, 64, False, tp_s(("flash", 4096, 52)),
         "SDXL TP = 2 serving, a rank's 5 heads: cross-attention, level 1"),
        ("B3", 20, 1024, 52, 1, 64, False, tp_s(("flash", 1024, 52)),
         "SDXL TP = 2 serving, a rank's 10 heads: cross-attention, level 2"),
    ]
    for padded in BATCHED_PADDED:
        b = 2 * padded
        what = f"SDXL batched serving, {padded} requests a call (CFG batch {b})"
        cases += [
            ("B1", b, 4096, 4096, 10, 64, False, {BATCHED_PATH: ("onepass", 4096, 4096, b)},
             f"{what}: self-attention, level 1"),
            ("B1", b, 1024, 1024, 20, 64, False, {BATCHED_PATH: ("onepass", 1024, 1024, b)},
             f"{what}: self-attention, level 2"),
            ("B3", 10 * b, 4096, TEXT_TOKENS, 1, 64, False,
             {BATCHED_PATH: ("flash", 4096, TEXT_TOKENS, b)}, f"{what}: cross-attention, level 1"),
            ("B3", 20 * b, 1024, TEXT_TOKENS, 1, 64, False,
             {BATCHED_PATH: ("flash", 1024, TEXT_TOKENS, b)}, f"{what}: cross-attention, level 2"),
        ]
    for _, (w, h), s in shard_bucket_shapes():
        what = f"SDXL shards training, bucket {w}x{h}"
        cases += [
            ("B1", 10, s, s, 10, 64, False, shards_t(("onepass", s, s)),
             f"{what} teacher: self-attention, level 1"),
            ("B3", 100, s, TEXT_TOKENS, 1, 64, True, shards_t(("flash", s, TEXT_TOKENS)),
             f"{what} student: cross-attention, level 1"),
            ("B3", 100, s, TEACHER_TOKENS, 1, 64, False, shards_t(("flash", s, TEACHER_TOKENS)),
             f"{what} teacher: cross-attention, level 1"),
            ("B3", 100, s, s, 1, 64, True, shards_t(("onepass", s, s)),
             f"{what} student: self-attention (head-major)"),
        ]
    sd15_1k_s, sd15_1k_t, bh_1k = "sd15 1024 serving", "sd15 1024 training", SD15_1024_SERVING_BH
    for level, d, s in ((0, 40, 16384), (1, 80, 4096), (2, 160, 1024)):
        cases += [
            ("B3", bh_1k, s, s, 1, d, False, {sd15_1k_s: ("flash", s, s)},
             f"SD1.5 1024² serving: self-attention, level {level}"),
            ("B3", bh_1k, s, TEXT_TOKENS, 1, d, False, {sd15_1k_s: ("flash", s, TEXT_TOKENS)},
             f"SD1.5 1024² serving: cross-attention, level {level}"),
        ]
    for path, bh, what, levels in (
            (sd15_t, SD15_TRAIN_BH, "SD1.5 training", ((0, 40, 4096), (1, 80, 1024))),
            (sd15_1k_t, SD15_1024_TRAIN_BH, "SD1.5 1024² training",
             ((0, 40, 16384), (1, 80, 4096), (2, 160, 1024)))):
        for level, d, s in levels:
            first = " (and the student's first, gradient-free call)" if level == 0 else ""
            cases += [
                ("B3", bh, s, s, 1, d, False, {path: ("flash", s, s)},
                 f"{what} teacher{first}: self-attention, level {level}"),
                ("B3", bh, s, s, 1, d, True, {path: ("flash", s, s)},
                 f"{what} student: self-attention, level {level}"),
                ("B3", bh, s, TEXT_TOKENS, 1, d, True, {path: ("flash", s, TEXT_TOKENS)},
                 f"{what} student: cross-attention, level {level}"),
                ("B3", bh, s, TEACHER_TOKENS, 1, d, False, {path: ("flash", s, TEACHER_TOKENS)},
                 f"{what} teacher: cross-attention, level {level}"),
            ]
    cases += [("B3", 16, 1000, 1000, 1, d, False, {}, f"ragged Sq and Skv, head_dim {d}")
              for d in (40, 80, 160)]
    return cases


def run_forward_cases(torch, F, randn, flush):
    from pea_diffusion_tpu_torch.ops import flash_attention, onepass_attention

    def plain_flash(q, k, v, with_lse):
        return chunked(torch, lambda *t: flash_attention.flash_forward_ref(
            *(x.float() for x in t), with_lse=with_lse), q.shape[1] * k.shape[1],
            PLAIN_SCORES, q, k, v)

    entries = []
    for kern, b, sq, skv, h, d, lse, stands_for, what in forward_cases():
        feat = h * d
        if kern == "B1":
            q, k, v = randn(b, sq, feat), randn(b, skv, feat), randn(b, skv, feat)
            run = lambda: onepass_attention.onepass_forward(q, k, v, h, d)  # noqa: E731
            plain = lambda: chunked(  # noqa: E731
                torch, lambda *t: onepass_attention.onepass_forward_ref(
                    *(x.float() for x in t), h, d), h * sq * skv, PLAIN_SCORES, q, k, v)
            views = [t.view(b, -1, h, d).transpose(1, 2) for t in (q, k, v)]
        else:
            q, k, v = randn(b, sq, d), randn(b, skv, d), randn(b, skv, d)
            run = lambda: flash_attention.flash_forward(q, k, v, with_lse=lse)  # noqa: E731
            plain = lambda: plain_flash(q, k, v, lse)  # noqa: E731
            views = [t.unsqueeze(0) for t in (q, k, v)]
        out = run()
        ref = plain()
        torch.cuda.synchronize()
        err, rel = _check(KERNELS[kern]["name"], what, [out[0] if lse else out],
                          [ref[0] if lse else ref], KERNEL_RTOL)
        variants = {}
        if kern == "B3":  # with and without lse: the same output, and the lse
            out_l, lse_l = out if lse else flash_attention.flash_forward(q, k, v, with_lse=True)
            out_p = flash_attention.flash_forward(q, k, v) if lse else out
            ref_lse = ref[1] if lse else plain_flash(q, k, v, True)[1]
            lse_err = (lse_l - ref_lse).abs().max().item()
            if not lse_err < LSE_ATOL or not torch.equal(out_l, out_p):
                raise AssertionError(f"B3 {what}: lse error {lse_err}, or the output "
                                     "differs with and without lse")
            variants = check_flash_variants(torch, flash_attention, what, q, k, v, out_l, lse_l,
                                            ref[0] if lse else ref, ref_lse)
            del out_l, lse_l, out_p, ref_lse
        del out, ref
        for name in variants:
            variants[name]["ms"] = time_ms(torch, lambda: flash_attention.flash_forward_variant(
                q, k, v, name, with_lse=lse), 10, flush)
        ms = time_ms(torch, run, 20, flush)
        plain_ms = time_ms(torch, plain, 3, flush)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(*views), 20, flush)
        flops = 4 * b * h * sq * skv * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + (4 * b * sq if lse else 0)
        entries.append(_entry(kern, b, sq, skv, h, d, what, err, rel, KERNEL_RTOL, ms,
                              plain_ms, flops, nbytes, library_ms, stands_for, lse, variants))
    return entries


def check_flash_variants(torch, fa, what, q, k, v, out, lse, ref, ref_lse):
    """Every B3 variant built at q's head dim against the plain version
    (output below KERNEL_RTOL of max |plain|, lse within LSE_ATOL); the
    variant the library ships at the shape must give shipped B3's bits
    (`out`, `lse`), and a self-attention row at Sq = Skv >= 1024 must ship a
    wgmma variant. Returns {variant: {"max_rel_err", "shipped"}}."""
    _, sq, d = q.shape
    skv = k.shape[1]
    shipped = fa.shipped_flash_variant(skv, d)
    if sq == skv >= 1024 and shipped == "mma_sync":
        raise AssertionError(f"B3 {what}: self-attention ships the mma.sync body")
    found = {}
    for name, dims in fa.FLASH_VARIANTS.items():
        if d not in dims:
            continue
        got, got_lse = fa.flash_forward_variant(q, k, v, name, with_lse=True)
        torch.cuda.synchronize()
        _, rel = errors(got, ref)
        lse_err = (got_lse - ref_lse).abs().max().item()
        if not (rel < KERNEL_RTOL and lse_err < LSE_ATOL):
            raise AssertionError(f"B3 variant {name} {what}: {rel} of max |plain| (limit "
                                 f"{KERNEL_RTOL}), lse error {lse_err} (limit {LSE_ATOL})")
        if name == shipped and not (torch.equal(got, out) and torch.equal(got_lse, lse)):
            raise AssertionError(f"B3 {what}: the shipped variant {name} differs from B3")
        found[name] = {"max_rel_err": rel, "shipped": name == shipped}
        del got, got_lse
    return found


def backward_cases():
    """(bh, sq, skv, head_dim, {path: (route, sq, skv)}, what), head-major."""
    sd15_t, bh = "sd15 training", SD15_TRAIN_BH
    return [
        (20, 1600, 1600, 64, sdxl_t(("onepass", 1600, 1600)),
         "SDXL training (and mul_zh KD): self-attention, level 1, batch 2"),
        (20, 1600, 52, 64, sdxl_t(("flash", 1600, 52)),
         "SDXL training (and mul_zh KD): cross-attention, level 1, batch 2"),
        (20, 6400, 6400, 64, {}, "long sequence: S=6400 (1280² level 1)"),
        (20, 6400, 52, 64, {}, "long sequence: cross-attention, Sq=6400"),
        (20, 1000, 1000, 64, {}, "ragged Sq and Skv"),
        (20, 1024, 1024, 128, {}, "head_dim 128"),
        (bh, 4096, 4096, 40, {sd15_t: ("flash", 4096, 4096)},
         "SD1.5 training: self-attention, level 0"),
        (bh, 4096, TEXT_TOKENS, 40, {sd15_t: ("flash", 4096, TEXT_TOKENS)},
         "SD1.5 training: cross-attention, level 0"),
        (bh, 1024, 1024, 80, {sd15_t: ("flash", 1024, 1024)},
         "SD1.5 training: self-attention, level 1"),
        (bh, 1024, TEXT_TOKENS, 80, {sd15_t: ("flash", 1024, TEXT_TOKENS)},
         "SD1.5 training: cross-attention, level 1"),
    ] + [
        (SD15_1024_TRAIN_BH, s, kv, d, {"sd15 1024 training": ("flash", s, kv)},
         f"SD1.5 1024² training: {'self' if kv == s else 'cross'}-attention, level {level}")
        for level, d, s in ((0, 40, 16384), (1, 80, 4096), (2, 160, 1024))
        for kv in (s, TEXT_TOKENS)
    ] + [(16, 1000, 1000, d, {}, f"ragged Sq and Skv, head_dim {d}") for d in (40, 80, 160)] + [
        (100, s, kv, 64, shards_t((route, s, kv)),
         f"SDXL shards training, bucket {w}x{h}: {'self' if kv == s else 'cross'}-attention, "
         "level 1")
        for _, (w, h), s in shard_bucket_shapes()
        for route, kv in (("onepass", s), ("flash", TEXT_TOKENS))]


def run_backward_cases(torch, F, randn, flush):
    """B4 and B5 against flash_backward_ref, head-major [BH, S, D] bf16, each
    with every variant built at the row's head dim (check_bwd_variants)."""
    from pea_diffusion_tpu_torch.ops import flash_attention as fa

    entries = []
    for bh, sq, skv, d, stands_for, what in backward_cases():
        q, k, v, do = randn(bh, sq, d), randn(bh, skv, d), randn(bh, skv, d), randn(bh, sq, d)
        scale = d ** -0.5
        with torch.no_grad():
            out, lse = fa.flash_forward(q, k, v, scale, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        run4 = lambda: fa.flash_backward_dkdv(q, k, v, do, lse, delta, scale)  # noqa: E731
        run5 = lambda: fa.flash_backward_dq(q, k, v, do, lse, delta, scale)  # noqa: E731
        plain = lambda: chunked(  # noqa: E731
            torch, lambda q_, k_, v_, o_, l_, g_: fa.flash_backward_ref(
                q_.float(), k_.float(), v_.float(), o_.float(), l_, g_.float(), scale),
            sq * skv, PLAIN_SCORES // 2, q, k, v, out, lse, do)
        dk, dv = run4()
        dq = run5()
        ref_dq, ref_dk, ref_dv = plain()
        torch.cuda.synchronize()
        err4, rel4 = _check("B4", what, [dk, dv], [ref_dk, ref_dv], BWD_RTOL)
        err5, rel5 = _check("B5", what, [dq], [ref_dq], BWD_RTOL)
        args = (q, k, v, do, lse, delta, scale)
        variants4 = check_bwd_variants(torch, fa, "dkdv", what, args, (dk, dv), (ref_dk, ref_dv))
        variants5 = check_bwd_variants(torch, fa, "dq", what, args, (dq,), (ref_dq,))
        del ref_dq, ref_dk, ref_dv, dq, dk, dv
        for which, variants in (("dkdv", variants4), ("dq", variants5)):
            for name in variants:
                variants[name]["ms"] = time_ms(torch, lambda: fa.flash_backward_variant(
                    *args, name, which), 10, flush)
        ms4, ms5 = time_ms(torch, run4, 10, flush), time_ms(torch, run5, 10, flush)
        plain_ms = time_ms(torch, plain, 2, flush)
        qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_(True) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qs, ks, vs)
        g = do.unsqueeze(0)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qs, ks, vs), g, retain_graph=True), 10, flush)
        del sdpa
        rows = 2 * bh * sq * 4  # lse and delta, fp32
        ops = bh * sq * skv * d
        exp_ms = bh * sq * skv / H100_EXP2_PER_S * 1e3  # one exp2 a score, both kernels
        entries.append(_entry("B4", bh, sq, skv, 1, d, what, err4, rel4, BWD_RTOL, ms4,
                              plain_ms, 8 * ops, 2 * bh * (2 * sq + 4 * skv) * d + rows,
                              library_ms, stands_for, variants=variants4, exp_ms=exp_ms))
        entries.append(_entry("B5", bh, sq, skv, 1, d, what, err5, rel5, BWD_RTOL, ms5,
                              plain_ms, 6 * ops, 2 * bh * (3 * sq + 2 * skv) * d + rows,
                              library_ms, stands_for, variants=variants5, exp_ms=exp_ms))
    return entries


def check_bwd_variants(torch, fa, which, what, args, outs, refs):
    """Every variant of B4 (`which` "dkdv") or B5 ("dq") built at the head
    dim against the plain version (each output below BWD_RTOL of its max
    |plain|), launched twice with the same bits; the variant the library
    ships at the shape must give the entry point's bits (`outs`), and a
    self-attention row at Sq = Skv >= 1024 must ship a wgmma variant.
    Returns {variant: {"max_rel_err", "shipped"}}."""
    kern = "B4" if which == "dkdv" else "B5"
    q, k = args[0], args[1]
    _, sq, d = q.shape
    skv = k.shape[1]
    shipped = fa.shipped_bwd_variant(which, sq, skv, d)
    if sq == skv >= 1024 and shipped == "mma_sync":
        raise AssertionError(f"{kern} {what}: self-attention ships the mma.sync body")
    found = {}
    for name, dims in fa.BWD_VARIANTS[which].items():
        if d not in dims:
            continue
        got = fa.flash_backward_variant(*args, name, which)
        again = fa.flash_backward_variant(*args, name, which)
        got, again = ((got,), (again,)) if which == "dq" else (got, again)
        torch.cuda.synchronize()
        rel = max(errors(a, b)[1] for a, b in zip(got, refs))
        if not rel < BWD_RTOL:
            raise AssertionError(f"{kern} variant {name} {what}: {rel} of max |plain| (limit "
                                 f"{BWD_RTOL})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kern} variant {name} {what}: two launches differ")
        if name == shipped and not all(torch.equal(a, b) for a, b in zip(got, outs)):
            raise AssertionError(f"{kern} {what}: the shipped variant {name} differs from {kern}")
        found[name] = {"max_rel_err": rel, "shipped": name == shipped}
        del got, again
    return found


def _entry(kern, b, sq, skv, h, d, what, err, rel, rtol, ms, plain_ms, flops, nbytes,
           library_ms, stands_for, lse=False, variants=None, exp_ms=None):
    """One row of the kernels line. `stands_for` maps each path that runs
    this shape to its attention call key (route, sq, skv); the row's launches
    on a path are the launches of that path's calls at the key (for B3, those
    with lse on a row with lse, the others on a row without). A B3 row names
    the variant it ships (`body`) and every variant's time and error
    (`variants`); its source is the shipped variant's body. B4 and B5 rows
    carry `exp_ms`, the least time the card's exp2 units take for the
    scores' exponentials, beside the bound."""
    bound_ms, bound_by = bound(flops, nbytes)
    shape = f"batch={b} sq={sq} skv={skv} heads={h} head_dim={d} bf16"
    e = dict(KERNELS[kern], shape=shape + (", with lse" if lse else ""),
             what=what, max_abs_err=err, max_rel_err=rel, rel_tolerance=rtol, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
             kernel=kern, lse=lse, stands_for=stands_for, launches_by_path={})
    if kern == "B1" and d != 64:  # B1 at D = 128 runs the mma.sync body
        e["source"] = SRC + "attention_fwd.cu"
    if exp_ms is not None:
        e["exp_ms"] = exp_ms
    if variants:
        e["body"] = next(name for name, v in variants.items() if v["shipped"])
        e["variants"] = variants
        if e["body"] == "mma_sync":
            e["source"] = SRC + ("attention_fwd.cu" if kern == "B3" else "attention_bwd.cu")
    log(f"[kernel] {e['name']} {what} ({e['shape']}): err {err:.3g} (rel {rel:.3g}) "
        f"ms {ms:.4f} plain {plain_ms:.4f} library {library_ms:.4f} "
        f"bound {bound_ms:.4f} ({bound_by})"
        + (f", exp2 floor {exp_ms:.4f}" if exp_ms is not None else "")
        + (f"; ships {e['body']}; variants ms " + ", ".join(
            f"{name} {v['ms']:.4f}" for name, v in variants.items()) if variants else ""))
    return e


def groupnorm_calls(model, side, batch):
    """{(kernel, batch, channels, side, act): calls} of one forward of a UNet
    or ControlNet at latent side `side`, or of a VAE decoder from latent side
    `side`: tools/sweep_groupnorm.py's walk of the GroupNorm modules (B6-b for
    a resnet's norm2 that adds the time embedding, B6 for every other one),
    without the group count."""
    from collections import Counter

    from pea_diffusion_tpu_torch.tools.sweep_groupnorm import groupnorm_calls as walk

    counts = Counter()
    for (kern, b, c, _, s, act), n in walk(model, side, batch).items():
        counts[kern, b, c, s, act] += n
    return counts


def controlnet_path_gn_calls(unet, controlnet, decoder, latent, forwards, decodes):
    """{(kernel, batch, channels, side, act): launches} of the ControlNet
    serving path: `forwards` UNet and ControlNet forwards of the CFG pair,
    `decodes` VAE decodes of one image."""
    from collections import Counter

    total = Counter()
    for model, batch, n in ((unet, 2, forwards), (controlnet, 2, forwards),
                            (decoder, 1, decodes)):
        for key, calls in groupnorm_calls(model, latent, batch).items():
            total[key] += calls * n
    return total


def groupnorm_cases():
    """(kernel, batch, channels, h, w, groups, act, dtype, {path: (batch,
    channels, side, act)}, what): each distinct B6/B6-b call of the SDXL
    ControlNet serving path (read from the SDXL UNet, ControlNet and VAE
    built on the meta device), then the check cases no path runs."""
    from collections import defaultdict

    import torch

    from pea_diffusion_tpu_torch.configs import SDXL_UNET, SDXL_VAE, ControlNetConfig
    from pea_diffusion_tpu_torch.models import AutoencoderKL, ControlNet, UNet2DCondition

    with torch.device("meta"):
        modules = (("UNet", UNet2DCondition(SDXL_UNET), 2),
                   ("ControlNet", ControlNet(ControlNetConfig(unet=SDXL_UNET)), 2),
                   ("VAE decoder", AutoencoderKL(SDXL_VAE).decoder, 1))
    owners = defaultdict(set)
    latent = SERVING["sdxl serving"]["size"] // 8
    for label, model, batch in modules:
        for key in groupnorm_calls(model, latent, batch):
            owners[key].add(label)
    # the TP = 2 path with the opt-in: B6 on whole channels as unsharded (the
    # UNet's and the VAE decoder's), B6-b on a rank's half of norm2's
    # channels in 16 of its 32 groups
    tp_b6 = {k for label, model, batch in modules if label != "ControlNet"
             for k in groupnorm_calls(model, latent, batch) if k[0] == "B6"}
    cases = []
    for key in sorted(owners, key=lambda k: (k[0], -k[3], k[2], k[4])):
        kern, b, c, side, act = key
        what = (f"SDXL ControlNet serving: {' + '.join(sorted(owners[key]))}, "
                f"{c} channels at {side}², act {act}")
        stands_for = {CONTROLNET_PATH: key[1:]}
        if key in tp_b6:
            stands_for[TP_GN_PATH] = key[1:]
        cases.append((kern, b, c, side, side, 32, act, torch.bfloat16, stands_for, what))
    for key in sorted(k for k in owners if k[0] == "B6-b" and "UNet" in owners[k]):
        _, b, c, side, act = key
        half = (b, c // TP, side, act)
        cases.append(("B6-b", b, c // TP, side, side, 32 // TP, act, torch.bfloat16,
                      {TP_GN_PATH: half}, f"SDXL TP = 2 serving with the opt-in: a rank's "
                      f"norm2, {c // TP} of {c} channels in {32 // TP} groups at {side}²"))
    return cases + [
        ("B6", 1, 128, 512, 512, 32, "silu", torch.float32, {},
         "fp32: the VAE encoder's first level at 512² (KD training encodes in fp32)"),
        ("B6-b", 2, 960, 30, 30, 32, "silu", torch.bfloat16, {},
         "ragged: H*W = 900 (no 8-element vectors), 30 channels per group"),
        ("B6-b", 1, 93, 17, 19, 3, "none", torch.float16, {},
         "ragged: 31 channels per group, H*W = 323, fp16"),
    ]


def run_groupnorm_cases(torch, F, flush):
    """B6 and B6-b against fused_gn_ref in fp32 from the same inputs, each
    input contiguous and channels-last, in every variant (group_norm_variant:
    three_pass and persistent): each below KERNEL_RTOL of max |plain|, two
    launches with the same bits, and the shipped wrappers with the bits of
    the variant the library's rule picks for the shape and layout. CUDA-event
    times of each variant in both layouts, as time_ms takes them and queued
    behind a device sleep (queued_ms: the wrapper's host time outside the
    window); "ms" is the shipped variant's channels-last time (the UNet,
    ControlNet and VAE take NHWC and permute it, so every GroupNorm on the
    path gets a channels-last tensor, as the ControlNet phase tallies), with
    whether its map stayed resident in shared memory; then the plain version
    in the input's type and one F.group_norm call (x + t formed beforehand:
    the GroupNorm alone), each on the channels-last input."""
    from pea_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kern, b, c, h, w, groups, act, dtype, stands_for, what in groupnorm_cases():
        def randn(*shape, sd=1.0, mean=0.0):
            return (mean + sd * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

        x = randn(b, c, h, w, sd=2.0, mean=0.5)
        scale, bias = randn(c, sd=0.1, mean=1.0), randn(c, sd=0.1)
        tb = randn(b, c) if kern == "B6-b" else None

        def run(xx):
            if tb is None:
                return gn.group_norm_fwd(xx, scale, bias, groups, 1e-5, act)
            return gn.group_norm_bias_fwd(xx, tb, scale, bias, groups, 1e-5, act)

        x_cl = x.contiguous(memory_format=torch.channels_last)
        layouts = (("contiguous", x), ("channels-last", x_cl))
        ref = gn.fused_gn_ref(x.float(), scale.float(), bias.float(), groups, 1e-5, act,
                              None if tb is None else tb.float())
        shipped = {name: gn.shipped_gn_variant(b, c, h * w, groups, name == "channels-last",
                                               dtype, xx.data_ptr()) for name, xx in layouts}
        outs = {name: run(xx) for name, xx in layouts}
        variants, err, rel = {}, 0.0, 0.0
        for var in gn.GN_VARIANTS:
            def run_var(xx, var=var):
                return gn.group_norm_variant(xx, scale, bias, groups, 1e-5, act, t=tb,
                                             variant=var)

            for name, xx in layouts:
                out, again = run_var(xx), run_var(xx)
                torch.cuda.synchronize()
                if out.dtype != dtype or out.is_contiguous(
                        memory_format=torch.channels_last) != (name == "channels-last"):
                    raise AssertionError(f"{kern} {what}, {var} {name}: output type or layout")
                if not torch.equal(out, again):
                    raise AssertionError(f"{kern} {what}, {var} {name}: two launches differ")
                if shipped[name] == var and not torch.equal(outs[name], out):
                    raise AssertionError(f"{kern} {what}, {name}: shipped B6/B6-b does not "
                                         f"give the bits of {var}")
                e_abs, e_rel = _check(KERNELS[kern]["name"], f"{what}, {var} {name}", [out],
                                      [ref], KERNEL_RTOL)
                err, rel = max(err, e_abs), max(rel, e_rel)
                variants.setdefault(var, {})["max_rel_err" if name == "channels-last"
                                             else "max_rel_err_contiguous"] = e_rel
                del out, again
            v = variants[var]
            gc.collect()  # no collection inside the timed windows of these short launches
            gc.disable()
            try:
                v["ms"] = time_ms(torch, lambda: run_var(x_cl), 20, flush)
                v["ms_contiguous"] = time_ms(torch, lambda: run_var(x), 20, flush)
                v["queued_ms"] = queued_ms(torch, lambda: run_var(x_cl), 20, flush)
                v["queued_ms_contiguous"] = queued_ms(torch, lambda: run_var(x), 20, flush)
            finally:
                gc.enable()
        del outs, ref
        size = x.element_size()
        plan = gn.persistent_plan(b, c, h * w, groups, True,
                                  gn.vector_width(c // groups, size, x_cl.data_ptr()), size,
                                  sms)
        variants["persistent"].update(resident=plan.resident, smem_bytes=plan.smem)
        ship = variants[shipped["channels-last"]]
        plain_ms = time_ms(torch, lambda: gn.fused_gn_ref(
            x_cl, scale, bias, groups, 1e-5, act, tb), 5, flush)
        xt = x_cl if tb is None else x_cl + tb[:, :, None, None]
        library_ms = time_ms(torch, lambda: F.group_norm(xt, groups, scale, bias, 1e-5), 20,
                             flush)
        nbytes = 2 * x.numel() * size + 2 * c * size + (0 if tb is None else tb.numel() * size)
        flops = x.numel() * (5 + (4 if act == "silu" else 0) + (0 if tb is None else 1))
        bound_ms, bound_by = bound(flops, nbytes, H100_FP32_FLOPS)
        shape = (f"batch={b} channels={c} h={h} w={w} groups={groups} act={act} "
                 f"{str(dtype).replace('torch.', '')}")
        source = "groupnorm_sm90.cu" if shipped["channels-last"] == "persistent" else "groupnorm.cu"
        e = dict(KERNELS[kern], source=SRC + source, shape=shape, what=what, max_abs_err=err,
                 max_rel_err=rel, rel_tolerance=KERNEL_RTOL, ms=ship["ms"],
                 ms_contiguous=variants[shipped["contiguous"]]["ms_contiguous"],
                 queued_ms=ship["queued_ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms,
                 library_what="F.group_norm" + (", GN only" if act == "silu" or tb is not None
                                                else ""),
                 kernel=kern, lse=False, body=shipped["channels-last"],
                 body_contiguous=shipped["contiguous"],
                 resident=plan.resident if shipped["channels-last"] == "persistent" else None,
                 variants=variants, stands_for=stands_for, launches_by_path={})
        log(f"[kernel] {e['name']} {what} ({shape}): err {err:.3g} (rel {rel:.3g}); ships "
            f"{e['body']} (channels-last, resident {e['resident']}, smem {plan.smem} bytes) / "
            f"{e['body_contiguous']} (contiguous); ms {e['ms']:.4f} (queued "
            f"{e['queued_ms']:.4f}) contiguous {e['ms_contiguous']:.4f} plain {plain_ms:.4f} "
            f"library {library_ms:.4f} bound {bound_ms:.4f} ({bound_by}); variants ms "
            + ", ".join(f"{var} {v['ms']:.4f} (queued {v['queued_ms']:.4f}) / contiguous "
                        f"{v['ms_contiguous']:.4f} (queued {v['queued_ms_contiguous']:.4f})"
                        for var, v in variants.items()))
        entries.append(e)
        del x, x_cl, xt
    return entries


def kernel_phases(torch, F):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    entries = (run_forward_cases(torch, F, randn, flush)
               + run_backward_cases(torch, F, randn, flush)
               + run_groupnorm_cases(torch, F, flush))
    del flush
    torch.cuda.empty_cache()
    return entries


def sweep_phase(torch, F):
    """The sweep path (S1): the sweep tool's function at SWEEP_SHAPES from
    launch counts of 0. Each variant below KERNEL_RTOL of max |plain|, the
    variant B1 ships at the shape bit-equal to shipped B1 (the tool's one
    B1 launch per shape makes that comparison); then, per shape, the plain
    version's and one SDPA call's times on the same inputs. One row per
    variant and shape."""
    from pea_diffusion_tpu_torch.tools import sweep_onepass as sw

    reset_launch_counts()
    rows = sw.sweep(SWEEP_SHAPES, SWEEP_ITERS)
    counted, b1 = dict(sw.onepass_forward_variant.launches), launch_counts()["B1"]
    n_shapes = len(sw.shapes(SWEEP_SHAPES))
    by_variant = {name: sum(r["launches"] for r in rows if r["variant"] == name)
                  for name in sw.VARIANTS}
    log(f"[sweep] variant launches {counted}; B1 launches {b1} (the base of each of "
        f"{n_shapes} shapes)")
    if by_variant != counted or b1 != n_shapes or min(counted.values()) == 0:
        raise AssertionError(f"sweep: rows account for {by_variant}, the wrapper counted "
                             f"{counted}; B1 {b1}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    entries = []
    for label, b, h, s, d in sw.shapes(SWEEP_SHAPES):
        q, k, v = sw.make_inputs(b, h, s, d)
        views = [t.view(b, s, h, d).transpose(1, 2) for t in (q, k, v)]
        plain_ms = time_ms(torch, lambda: sw.plain_forward(q, k, v, h, d), 3, flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(*views), 20, flush)
        bound_ms, bound_by = bound(4 * b * h * s * s * d, 2 * 4 * q.numel())
        for r in (r for r in rows if r["shape"] == label):
            what = f"sweep {label}: variant {r['variant']}"
            if not r["rel_err_vs_plain"] < KERNEL_RTOL:
                raise AssertionError(f"S1 {what}: {r['rel_err_vs_plain']} of max |plain| >= "
                                     f"{KERNEL_RTOL}")
            if r["shipped"] and not r["equals_base"]:
                raise AssertionError(f"S1 {what}: the shipped variant differs from shipped B1 "
                                     f"by {r['max_abs_err_vs_base']}")
            shape = f"batch={b} sq={s} skv={s} heads={h} head_dim={d} bf16"
            e = dict(KERNELS["S1"], name=f"{KERNELS['S1']['name']} {r['variant']}",
                     source=SRC + ("attention_fwd_sm90_body.cuh" if r["variant"].startswith("wg")
                                   else "attention_fwd.cu"),
                     shape=shape, what=what, max_abs_err=r["max_abs_err_vs_base"],
                     max_rel_err=r["rel_err_vs_plain"], rel_tolerance=KERNEL_RTOL,
                     ms=r["us"] / 1e3, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms, tflops=r["tflops"], equals_b1=r["equals_base"],
                     kernel="S1", lse=False, stands_for={},
                     launches_by_path={SWEEP_PATH: r["launches"]})
            log(f"[kernel] {e['name']} {what} ({shape}): rel err vs plain "
                f"{r['rel_err_vs_plain']:.3g}, max abs vs B1 {r['max_abs_err_vs_base']:.3g} "
                f"ms {e['ms']:.4f} ({r['tflops']:.1f} TFLOP/s) plain {plain_ms:.4f} library "
                f"{library_ms:.4f} bound {bound_ms:.4f} ({bound_by})")
            entries.append(e)
        del q, k, v, views
    del flush
    torch.cuda.empty_cache()
    return entries


def attention_calls(unet, latent, skv: int, device_type="cuda", grad_free=None,
                    heads=False):
    """(route, sq, skv, head_dim) of each attention call of one UNet forward
    at a latent side `latent` (an int, or (height, width) for an aspect
    bucket's latents), in the order the forward runs them, from the
    dispatch each attention module takes at its level's sequence length;
    with `heads`, the call's head count after the head dim.
    With `grad_free` False or True, only the calls whose inputs do or do not
    depend on the text conditioning, which is what decides whether autograd
    records them when the adapter trains: without SDXL's added conditioning
    (pooled text in the time embedding), the calls before the first
    cross-attention see only the latents and the timestep (SD1.5: the first
    self-attention of level 0)."""
    from pea_diffusion_tpu_torch.models.layers import attention_route

    n = len(unet.down_blocks)
    levels = ([(blk, i) for i, blk in enumerate(unet.down_blocks)] + [(unet.mid_block, n - 1)]
              + [(blk, n - 1 - i) for i, blk in enumerate(getattr(unet, "up_blocks", []))])
    conditioned = getattr(unet.config, "unet", unet.config).addition_embed_type == "text_time"
    lh, lw = (latent, latent) if isinstance(latent, int) else latent
    for block, level in levels:
        sq = (lh >> level) * (lw >> level)
        for tr in getattr(block, "attentions", []):
            for tb in tr.transformer_blocks:
                for attn, kv in ((tb.attn1, sq), (tb.attn2, skv)):
                    conditioned = conditioned or attn is tb.attn2
                    if grad_free is not None and grad_free == conditioned:
                        continue
                    route = attention_route(sq, kv, attn.num_heads, attn.head_dim,
                                            attn.backend, device_type)
                    yield (route, sq, kv, attn.head_dim) + ((attn.num_heads,) if heads else ())


def attention_routes(unet, latent, skv: int, device_type="cuda", grad_free=None,
                     heads=False):
    """{(route, sq, skv): calls} of one UNet forward (see `attention_calls`);
    with `heads`, keyed (route, sq, skv, heads)."""
    from collections import Counter

    return Counter(call[:3] + call[4:] for call in attention_calls(
        unet, latent, skv, device_type, grad_free, heads))


def routes_by_head_dim(unet, latent, skv: int):
    """{(route, head_dim): calls} of one UNet forward, for the log."""
    from collections import Counter

    return Counter((route, d) for route, _, _, d in attention_calls(unet, latent, skv))


def launches_at(calls, key):
    """{counter: launches} that the attention calls at `key` (route, sq, skv)
    make on a path whose UNet forwards are `calls`: [(role, {key: calls per
    forward}, forwards)]."""
    out = dict.fromkeys(COUNTERS, 0)
    for role, routes, forwards in calls:
        for name in COUNTERS:
            per_call = PER_CALL[role].get(name, {}).get(key[0], 0)
            out[name] += forwards * routes.get(key, 0) * per_call
    return out


def path_launches(calls):
    """{counter: launches} of a whole path (see `launches_at`)."""
    total = dict.fromkeys(COUNTERS, 0)
    for key in {key for _, routes, _ in calls for key in routes}:
        for name, n in launches_at(calls, key).items():
            total[name] += n
    return total


def stamp_launches(kernels, path, calls, measured, gn_calls=None):
    """Gives each kernel row the launches that `path` made at the shape the
    row stands for (attention rows from the attention `calls`, GroupNorm
    rows from `gn_calls`, {(kernel, batch, channels, side, act): launches}),
    and checks that the rows account for every launch the wrappers counted
    on the path."""
    gn_calls = gn_calls or {}
    for e in kernels:
        key = e["stands_for"].get(path)
        n = 0
        if key is not None and e["kernel"] in GN_KERNELS:
            n = gn_calls.get((e["kernel"],) + key, 0)
        elif key is not None:
            at = launches_at(calls, key)
            n = at[e["kernel"]]
            if e["kernel"] == "B3":
                n = at["B3 with lse"] if e["lse"] else n - at["B3 with lse"]
        e["launches_by_path"][path] = n
    for kern in ("B1", "B3", "B4", "B5") + GN_KERNELS:
        rows = sum(e["launches_by_path"][path] for e in kernels if e["kernel"] == kern)
        if rows != measured[kern]:
            raise AssertionError(f"{path}: the {kern} rows account for {rows} launches, "
                                 f"the wrapper counted {measured[kern]}")
    rows = sum(e["launches_by_path"][path] for e in kernels
               if e["kernel"] == "B3" and e["lse"])
    if rows != measured["B3 with lse"]:
        raise AssertionError(f"{path}: the B3 rows with lse account for {rows} launches, "
                             f"the wrapper counted {measured['B3 with lse']}")


def log_gn_path_sums(kernels, path):
    """The kernel rows' times summed over `path`'s B6 and B6-b launches,
    channels-last, per variant and for the shipped kernel, beside the sum of
    their bounds: the UNet and ControlNet maps (batch 2) and the VAE
    decoder's (batch 1) apart."""
    sums = {}
    for e in kernels:
        n = e["launches_by_path"].get(path, 0) if e["kernel"] in GN_KERNELS else 0
        if not n:
            continue
        part = "VAE decoder" if e["stands_for"][path][0] == 1 else "UNet + ControlNet"
        row = sums.setdefault(part, {"launches": 0, "bound": 0.0, "shipped": 0.0,
                                     "shipped queued": 0.0})
        row["launches"] += n
        row["bound"] += n * e["bound_ms"]
        row["shipped"] += n * e["ms"]
        row["shipped queued"] += n * e["queued_ms"]
        for var, v in e["variants"].items():
            row[var] = row.get(var, 0.0) + n * v["ms"]
            row[f"{var} queued"] = row.get(f"{var} queued", 0.0) + n * v["queued_ms"]
    for part, row in sums.items():
        log(f"[{path}] GroupNorm kernel ms summed over the path's channels-last launches, "
            f"{part}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in row.items()))


def launch_counts():
    from pea_diffusion_tpu_torch.ops import flash_attention as fa
    from pea_diffusion_tpu_torch.ops import groupnorm as gn
    from pea_diffusion_tpu_torch.ops import onepass_attention as op

    return {"B1": op.onepass_forward.launches, "B3": fa.flash_forward.launches,
            "B3 with lse": fa.flash_forward.lse_launches,
            "B4": fa.flash_backward_dkdv.launches, "B5": fa.flash_backward_dq.launches,
            "B6": gn.group_norm_fwd.launches, "B6-b": gn.group_norm_bias_fwd.launches}


def reset_launch_counts():
    from pea_diffusion_tpu_torch.ops import flash_attention as fa
    from pea_diffusion_tpu_torch.ops import groupnorm as gn
    from pea_diffusion_tpu_torch.ops import onepass_attention as op

    from pea_diffusion_tpu_torch.tools import sweep_onepass as sw

    for fn in (op.onepass_forward, fa.flash_forward, fa.flash_backward_dkdv,
               fa.flash_backward_dq, gn.group_norm_fwd, gn.group_norm_bias_fwd):
        fn.launches = 0
    fa.flash_forward.lse_launches = 0
    gn.group_norm_fwd.copies = 0
    sw.onepass_forward_variant.launches = dict.fromkeys(sw.VARIANTS, 0)


def check_launches(path, got, want):
    log(f"[{path}] launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want {want}")


def reference_tiny_stack(torch, build_demo, model):
    """The tiny fp32 stack on the card against the same weights on the CPU
    (the CPU path is the one the tests hold against the JAX package)."""
    import numpy as np

    from pea_diffusion_tpu_torch.pipelines.text2image import generate_sd, generate_sdxl

    cpu, tokenize, _ = build_demo("cpu", model)
    gpu, _, _ = build_demo("cuda", model)
    for name in ("text_encoder", "adapter", "unet", "vae"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    noise = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(np.float32)
    ids, uncond = tokenize(["一只猫"]), tokenize([""])
    generate = generate_sd if model == "sd15" else generate_sdxl
    imgs = [generate(m, ids, uncond, sampler_name="ddim", height=64, width=64, num_steps=2,
                     guidance_scale=GUIDANCE, init_noise=noise).cpu() for m in (cpu, gpu)]
    err = (imgs[0] - imgs[1]).abs().max().item()
    log(f"[reference] tiny {model} stack, card vs CPU (fp32): max abs {err:.3g}")
    if not err < TINY_ATOL:
        raise AssertionError(f"tiny {model} stack on the card differs from the CPU: {err}")


def reference_attention_modules(torch, unet, latent, levels):
    """The full-width UNet's attention modules at the serving shapes of the
    down levels `levels` (sequence (latent >> level)²), through the kernels
    and through plain attention: outputs (relative max error), and the
    input gradients dx and dcontext through the differentiable routes (B3
    with lse, B4, B5) against plain attention's autograd."""
    from pea_diffusion_tpu_torch.models.layers import attention_route

    gen = torch.Generator(device="cuda").manual_seed(3)
    ctx = torch.randn(2, TEXT_TOKENS, unet.config.cross_attention_dim, generator=gen,
                      device="cuda").bfloat16()
    for level in levels:
        blk = unet.down_blocks[level].attentions[0].transformer_blocks[0]
        dim = blk.attn1.to_q.in_features
        s = (latent >> level) ** 2
        x = torch.randn(2, s, dim, generator=gen, device="cuda").bfloat16()
        gout = torch.randn(2, s, dim, generator=gen, device="cuda").bfloat16()
        for attn, c in ((blk.attn1, None), (blk.attn2, ctx)):
            route = attention_route(s, s if c is None else TEXT_TOKENS, attn.num_heads,
                                    attn.head_dim, "auto", "cuda")
            with torch.inference_mode():
                got = attn(x, c).float()
                attn.backend = "xla"
                want = attn(x, c).float()
                attn.backend = "auto"
            _, rel = errors(got, want)
            grads = {}
            for backend in ("auto", "xla"):
                attn.backend = backend
                xs = x.clone().requires_grad_(True)
                cs = None if c is None else c.clone().requires_grad_(True)
                attn(xs, cs).backward(gout)
                grads[backend] = [t.grad.float() for t in (xs, cs) if t is not None]
            attn.backend = "auto"
            rels = [errors(g, w)[1] for g, w in zip(grads["auto"], grads["xla"])]
            log(f"[reference] level {level} ({dim} channels, {attn.num_heads} heads of "
                f"{attn.head_dim}) {route} attention module: relative max error {rel:.3g}; "
                f"input gradients (dx, dcontext) {rels}")
            if not rel < MODULE_RTOL or not all(r < MODULE_RTOL for r in rels):
                raise AssertionError(f"attention module, level {level} {route}: "
                                     f"{rel} {rels}")
            if not all(g.abs().max().item() > 0 for g in grads["auto"]):
                raise AssertionError(f"attention module, level {level} {route}: "
                                     "zero input gradient through the kernels")


def check_image(img, size, tag, seconds):
    if tuple(img.shape) != (1, size, size, 3):
        raise AssertionError(f"{tag}: image shape {tuple(img.shape)}")
    f = img.float()
    if not bool(f.isfinite().all()) or f.min() < 0 or f.max() > 1:
        raise AssertionError(f"{tag}: image not finite in [0, 1]")
    log(f"[{tag}] {seconds:.4f}s, image mean {f.mean().item():.4f} std {f.std().item():.4f}")


def main_path(torch, pipe, tokenize, prompts, size, steps, tag):
    torch.cuda.reset_peak_memory_stats()
    req_s = []
    for i, prompt in enumerate(prompts[:REQUESTS]):
        torch.cuda.synchronize()
        t = time.time()
        imgs = pipe(tokenize([prompt]), tokenize([""]), height=size, width=size,
                    num_steps=steps, guidance_scale=GUIDANCE, seed=i)
        torch.cuda.synchronize()
        req_s.append(time.time() - t)
        if tuple(imgs.shape) != (1, size, size, 3):
            raise AssertionError(f"{tag}: image shape {tuple(imgs.shape)}")
        f = imgs.float()
        if not torch.isfinite(f).all() or f.min() < 0 or f.max() > 1:
            raise AssertionError(f"{tag}: image not finite in [0, 1]")
        log(f"[{tag}] request {i}: {req_s[-1]:.4f}s, image mean {f.mean().item():.4f}"
            f" std {f.std().item():.4f}")
    return req_s


def event_ms(torch, fn, n=3):
    """Mean CUDA-event time of `fn` over `n` warm runs."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(n):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / n


def stage_times(torch, models, tokenize, prompt, kernels, forwards, model, size, path):
    """CUDA-event times of one request's stages, each the mean of 3 warm runs."""
    from pea_diffusion_tpu_torch.pipelines.text2image import (
        decode_latents, encode_prompt_sd, encode_prompt_sdxl, make_add_time_ids)

    dev = models.device
    ids = torch.as_tensor(tokenize([prompt]), device=dev)
    uncond = torch.as_tensor(tokenize([""]), device=dev)
    x = torch.randn((2, size // 8, size // 8, 4), device=dev)
    t = torch.full((2,), 500, device=dev)

    with torch.inference_mode():
        if model == "sd15":
            encode = lambda: encode_prompt_sd(models, ids, uncond)  # noqa: E731
            context, added = encode(), None
        else:
            encode = lambda: encode_prompt_sdxl(models, ids, uncond)  # noqa: E731
            context, pooled = encode()
            added = {"text_embeds": pooled, "time_ids": make_add_time_ids(
                (size, size), (0, 0), (size, size), 2, dev)}
        enc = event_ms(torch, encode)
        unet = event_ms(torch, lambda: models.unet(x, t, context, added))
        dec = event_ms(torch, lambda: decode_latents(models, x[:1]))
    attn_ms = sum(e["ms"] * e["launches_by_path"][path] for e in kernels) / forwards
    log(f"[{path} stages] prompt encoding {enc:.3f} ms; UNet forward of the CFG pair "
        f"{unet:.3f} ms, of which attention kernels ~{attn_ms:.3f} ms (kernel ms x "
        f"launches per forward); VAE decode {dec:.3f} ms")


def gn_kernel_launches(gn_calls):
    """The GroupNorm kernel launches a profile must show for `gn_calls`
    ({(kernel, batch, channels, side, act): calls}, channels-last bf16 maps
    in 32 groups): one a call where the library ships the persistent
    variant, three (statistics, finalize, apply) where it ships three_pass."""
    import torch

    from pea_diffusion_tpu_torch.ops import groupnorm as gn

    return sum(n * (1 if gn.shipped_gn_variant(b, c, side * side, 32, True, torch.bfloat16)
                    == "persistent" else 3)
               for (_, b, c, side, _), n in gn_calls.items())


def profile_run(torch, fn, unprofiled_s, table_path, tag, gn_calls=None):
    """torch.profiler over one call of `fn`: device busy time against wall
    time and against the unprofiled call (`unprofiled_s`), and the kernels
    that take the most device time. The full table goes to `table_path`.
    With `gn_calls` ({(kernel, batch, channels, side, act): calls}, see
    `gn_kernel_launches`), the call must make that many GroupNorm wrapper
    launches (their own counts, exact in every call), and the GroupNorm
    kernels (pea::gn) the profile saw must be the kernel launches those
    calls make. The profiler has missed one kernel record of a call on a
    card (213 of 214): a profile that misses the count is taken once more,
    and the second must see them all. Returns the idle share of the
    unprofiled call. The profiler records device activity alone: the table
    lists kernels, and the host does not parse every CPU op, which took
    most of a profile's time."""
    from torch.profiler import ProfilerActivity, profile

    from pea_diffusion_tpu_torch.ops import groupnorm as gn

    def wrapper_launches():
        return gn.group_norm_fwd.launches + gn.group_norm_bias_fwd.launches

    want_calls = None if gn_calls is None else sum(gn_calls.values())
    want = None if gn_calls is None else gn_kernel_launches(gn_calls)
    for attempt in (1, 2):
        calls = wrapper_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3
        calls = wrapper_launches() - calls
        per_kernel, gn_count, gn_ms = {}, 0, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) + ms
                if "pea::gn::" in e.name or "_ZN3pea2gn" in e.name:
                    gn_count, gn_ms = gn_count + 1, gn_ms + ms
        if want_calls is not None and calls != want_calls:
            raise AssertionError(f"[{tag}] {calls} GroupNorm wrapper launches in the call, "
                                 f"want {want_calls}")
        if want is None or gn_count == want:
            break
        if attempt == 2:
            raise AssertionError(f"[{tag}] {gn_count} GroupNorm kernel launches in the "
                                 f"profile, want {want}, in both profiles")
        log(f"[{tag}] the profile saw {gn_count} GroupNorm kernel launches of the {want} "
            f"that the wrappers' {calls} launches make: profiling the call once more")
    busy = sum(per_kernel.values())
    if busy == 0:
        raise AssertionError(f"[{tag}] the profiler saw no device time")
    idle = max(0.0, 1 - busy / (unprofiled_s * 1e3))
    fwd = sum(v for k, v in per_kernel.items()
              if "attention_fwd_kernel" in k or "wgmma_attention_kernel" in k)
    bwd = sum(v for k, v in per_kernel.items() if "attention_bwd_" in k or "flash_bwd_" in k)
    log(f"[{tag}] device busy {busy:.1f} ms of {wall_ms:.1f} ms wall under the "
        f"profiler; of the unprofiled run ({unprofiled_s * 1e3:.1f} ms) the device "
        f"is idle {idle:.3f}; B1+B3 kernels {fwd:.1f} ms, B4+B5 kernels {bwd:.1f} ms, "
        f"GroupNorm kernels {gn_ms:.1f} ms in {gn_count} launches"
        + ("" if want is None else f" (want {want}, from {calls} wrapper launches)"))
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[{tag}]   {ms:9.2f} ms  {name[:110]}")
    table_path.parent.mkdir(exist_ok=True)
    table_path.write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=80))
    return idle


def checksums(torch, modules):
    """{tensor: int64 sum of its raw bits} over every tensor of `modules`."""
    names, sums = [], []
    for mname, m in modules.items():
        for k, t in m.state_dict().items():
            bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            names.append(f"{mname}.{k}")
            sums.append(bits.sum(dtype=torch.int64))
    return dict(zip(names, torch.stack(sums).tolist()))


def set_fused_gn(on):
    """Turns the fused GroupNorm kernels on (PEA_FUSED_GROUPNORM=1: under
    autograd too) or off (=0: the plain form everywhere; unset would take
    the kernels wherever no input needs a gradient)."""
    import os

    os.environ["PEA_FUSED_GROUPNORM"] = "1" if on else "0"


def reference_kd_step(torch, models, model, compare="attention", size=512, head_dim=None):
    """One KD step's adapter gradient at batch 1, `size`², with the same
    draws: through the attention kernels against plain attention (`compare`
    "attention"; with `head_dim`, only the attention modules of that head
    dim switch, the others run the kernels both times), or with the fused
    GroupNorm opt-in on against off ("groupnorm": B6/B6-b forward, the plain
    VJP backward, on every norm of the student UNet and the fp32 VAE
    encoder). Relative L2 error."""
    from pea_diffusion_tpu_torch.cli.train import demo_full_batches
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention
    from pea_diffusion_tpu_torch.train.kd import kd_loss

    batch = next(demo_full_batches("cuda", 1, size, seed=5, model=model))
    batch["zh_or_not"] = torch.full((1,), 0.5, device="cuda")  # both loss routes
    gen = torch.Generator(device="cuda").manual_seed(11)
    draws, grads, losses = {}, {}, {}
    attns = [m for m in models.unet.modules() if isinstance(m, MultiHeadAttention)
             and head_dim in (None, m.head_dim)]
    settings = ("auto", "xla") if compare == "attention" else ("on", "off")
    gn_launches = 0
    for setting in settings:
        if compare == "attention":
            for m in attns:
                m.backend = setting
        else:
            set_fused_gn(setting == "on")
            reset_launch_counts()
        models.adapter.zero_grad()
        loss, _ = kd_loss(models, TrainConfig(), batch, gen, draws)
        loss.backward()
        losses[setting] = loss.item()
        grads[setting] = torch.cat([p.grad.flatten() for p in models.adapter.parameters()])
        if setting == "on":
            counts = launch_counts()
            gn_launches = counts["B6"] + counts["B6-b"]
    set_fused_gn(False)
    for m in attns:
        m.backend = "auto"
    models.adapter.zero_grad()
    a, b = settings
    rel = ((grads[a] - grads[b]).norm() / grads[b].norm()).item()
    what = ("kernels vs plain attention" if compare == "attention"
            else f"fused GroupNorm on ({gn_launches} B6/B6-b launches) vs off")
    if head_dim is not None:
        what += f" in the {len(attns)} attention modules of head dim {head_dim}"
    log(f"[reference] {model} KD step, batch 1, {size}², {what}: loss {losses[a]:.6g} vs "
        f"{losses[b]:.6g}; adapter gradient relative L2 error {rel:.3g}")
    if not (rel < KD_GRAD_RTOL and grads[a].norm().item() > 0):
        raise AssertionError(f"{model} KD adapter gradient, {what}: {rel}")
    if compare != "attention" and gn_launches == 0:
        raise AssertionError(f"{model} KD step with the opt-in on launched no GroupNorm kernel")


def training_path(torch, models, repo, kernels, path):
    """KDTrainer.fit for TRAIN_STEPS steps at the path's micro-batch and
    image side (synthetic batches from cli/train.py's demo_full_batches,
    seeded as its build_demo_full seeds them), from launch counts of 0;
    stamps the launches on the kernel rows. Returns the peak memory, GiB, and
    keeps the step time in STEP_S."""
    import shutil

    from pea_diffusion_tpu_torch.cli.train import demo_full_batches
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    spec = TRAINING[path]
    batch_size, size, tag = spec["batch"], spec["size"], path

    def make_batches(start_step=0):
        return demo_full_batches(models.device, batch_size, size, 1 + start_step, spec["model"])

    out = repo / "build" / spec["table"].replace("_profile.txt", "")
    shutil.rmtree(out, ignore_errors=True)
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(out),
                      every_n_steps=TRAIN_STEPS, log_every_n_steps=1,
                      batch_size_per_device=batch_size)
    trainer = KDTrainer(models, cfg)
    frozen = checksums(torch, models.frozen_modules())
    adapter = {k: v.clone() for k, v in models.adapter.state_dict().items()}
    latent = size // 8
    student = attention_routes(models.unet, latent, TEXT_TOKENS, grad_free=False)
    grad_free = attention_routes(models.unet, latent, TEXT_TOKENS, grad_free=True)
    teacher = attention_routes(models.unet, latent, TEACHER_TOKENS)
    calls = [("student", student, TRAIN_STEPS), ("student, no gradient", grad_free, TRAIN_STEPS),
             ("teacher", teacher, TRAIN_STEPS)]
    want = path_launches(calls)
    log(f"[{tag}] attention calls per UNet forward at {size}² by (route, head dim): "
        f"{dict(routes_by_head_dim(models.unet, latent, TEACHER_TOKENS))}; student by (route, sq, "
        f"skv): {dict(student)}, of which no input depends on the adapter: "
        f"{dict(grad_free)}; teacher: {dict(teacher)}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer.fit(make_batches(), max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(tag, launches, want)
    stamp_launches(kernels, path, calls, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    if len(recs) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: training losses {losses}")
    moved = any(not torch.equal(v, models.adapter.state_dict()[k]) for k, v in adapter.items())
    if not moved:
        raise AssertionError(f"{tag}: the adapter did not change")
    if checksums(torch, models.frozen_modules()) != frozen:
        raise AssertionError(f"{tag}: a frozen tensor changed")
    if not (out / f"proj_{TRAIN_STEPS}" / "pytorch_model.bin").is_file():
        raise AssertionError(f"{tag}: no exported adapter")
    step_s = STEP_S[path] = (recs[-1]["time"] - recs[0]["time"]) / (TRAIN_STEPS - 1)
    log(f"[{tag}] {TRAIN_STEPS} steps at micro-batch {batch_size}, {size}²: losses "
        f"{losses}; grad norms {[r['grad_norm'] for r in recs]}; step time (mean of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f} s, {batch_size / step_s:.4f} samples/s; peak memory "
        f"{peak:.2f} GiB; adapter moved, {len(frozen)} frozen tensors bit-identical")

    batch = next(make_batches(TRAIN_STEPS))
    gen = torch.Generator(device="cuda").manual_seed(99)
    profile_run(torch, lambda: trainer.step_fn(trainer.state, batch, gen), step_s,
                repo / "build" / spec["table"], f"{tag} profile")
    return peak


STEP_S = {}  # training path: its step time (s), the mean of steps 2..TRAIN_STEPS


def serving_phase(torch, model, kernels, repo):
    """The full-width serving stack of `model` and each of its serving
    paths (`serve_path`); for SDXL then the fused GroupNorm A/B."""
    from pea_diffusion_tpu_torch.cli.generate import build_demo_full

    t1 = time.time()
    models, tokenize, _ = build_demo_full("cuda", model=model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (models.text_encoder, models.adapter,
                                       models.unet, models.vae)
                   for p in m.parameters())
    log(f"[init] full-width {model} serving stack on the card in {time.time() - t1:.1f}s, "
        f"{n_params / 1e9:.3f}B parameters")
    for path, spec in SERVING.items():
        if spec["model"] == model:
            pipe = serve_path(torch, models, tokenize, path, kernels, repo)
            log(f"[{path}] done at {time.time() - t1:.1f}s after the stack's build")
    if model == "sdxl":
        fused_gn_ab(torch, models, pipe, tokenize, PROMPTS[0], repo)
        fewstep_phase(torch, models, tokenize, kernels, repo)
        log(f"[fewstep] done at {time.time() - t1:.1f}s after the stack's build")
        int8_phase(torch, models, tokenize, kernels, repo)
        log(f"[int8] done at {time.time() - t1:.1f}s after the stack's build")
        presets_phase(torch, models, tokenize, kernels, repo)
        log(f"[presets] done at {time.time() - t1:.1f}s after the stack's build")
        towers_phase(torch, models, kernels, repo)
        log(f"[towers] done at {time.time() - t1:.1f}s after the stack's build")
        pngs = batched_serve_phase(torch, models, tokenize, kernels, repo)
        log(f"[batched] done at {time.time() - t1:.1f}s after the stack's build")
        evaluate_phase(torch, tokenize, pngs, repo)
        log(f"[evaluate] done at {time.time() - t1:.1f}s after the stack's build")


def serve_path(torch, models, tokenize, path, kernels, repo):
    """One serving path: the UNet's attention modules at the path's levels
    against plain attention, then REQUESTS requests with the launch counts
    set to 0 just before and read just after, the stage times and a
    profile. Returns the pipeline."""
    from pea_diffusion_tpu_torch.pipelines.text2image import (StableDiffusionPEAPipeline,
                                                              StableDiffusionXLPEAPipeline)

    spec = SERVING[path]
    size, steps, model, tag = spec["size"], spec["steps"], spec["model"], path
    reference_attention_modules(torch, models.unet, size // 8, spec["levels"])
    pipe = (StableDiffusionXLPEAPipeline if model == "sdxl" else StableDiffusionPEAPipeline)(
        models, sampler_name="ddim")
    routes = attention_routes(models.unet, size // 8, TEXT_TOKENS)
    calls = [("serving", routes, steps * REQUESTS)]
    want = path_launches(calls)
    reset_launch_counts()
    req_s = main_path(torch, pipe, tokenize, PROMPTS, size, steps, tag)
    served = launch_counts()
    log(f"[{tag}] attention calls per UNet forward at {size}² by (route, head dim): "
        f"{dict(routes_by_head_dim(models.unet, size // 8, TEXT_TOKENS))}; by (route, sq, skv): "
        f"{dict(routes)}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches(tag, served, want)
    stamp_launches(kernels, path, calls, served)

    stage_times(torch, models, tokenize, PROMPTS[0], kernels, steps * REQUESTS, model, size,
                path)
    profile_run(torch, lambda: pipe(tokenize([PROMPTS[0]]), tokenize([""]), height=size,
                                    width=size, num_steps=steps, guidance_scale=GUIDANCE,
                                    seed=7),
                min(req_s), repo / "build" / spec["table"], f"{tag} profile")
    return pipe


def fused_gn_ab(torch, models, pipe, tokenize, prompt, repo):
    """The SDXL serving stack with the fused GroupNorm opt-in off and on.
    One UNet forward of the CFG pair: in fp32 (the same weights upcast,
    plain attention) on vs off must agree within MODULE_RTOL, the kernels'
    function against the plain one with no bf16 rounding in the way; in
    bf16, where the two round at other points and 46 norms feed each other,
    the opt-in must keep the forward within MODULE_RTOL of the fp32 one or
    no further from it than the plain GroupNorm is. Then warm 1024²
    requests in turns (off, on, on, off) for latency, a profile of one
    request each way (device busy and idle share), and the largest
    difference between the two images."""
    import copy

    from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention
    from pea_diffusion_tpu_torch.pipelines.text2image import (encode_prompt_sdxl,
                                                              make_add_time_ids)

    size, steps = SERVING["sdxl serving"]["size"], SERVING["sdxl serving"]["steps"]
    dev = models.device
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((2, size // 8, size // 8, 4), generator=gen, device=dev)
    t = torch.full((2,), 500, device=dev)
    ids, uncond = tokenize([prompt]), tokenize([""])
    outs = {}
    try:
        with torch.inference_mode():
            context, pooled = encode_prompt_sdxl(models, torch.as_tensor(ids, device=dev),
                                                 torch.as_tensor(uncond, device=dev))
            added = {"text_embeds": pooled,
                     "time_ids": make_add_time_ids((size, size), (0, 0), (size, size), 2, dev)}
            unet32 = copy.deepcopy(models.unet).float()
            for m in unet32.modules():
                if isinstance(m, MultiHeadAttention):
                    m.backend = "xla"
            for on in (False, True):
                set_fused_gn(on)
                reset_launch_counts()
                outs["bf16", on] = models.unet(x, t, context, added).float()
                outs["fp32", on] = unet32(x, t, context.float(),
                                          {k: v.float() for k, v in added.items()})
                counts = launch_counts()
                if (counts["B6"] + counts["B6-b"] > 0) != on:
                    raise AssertionError(f"opt-in {on}: GroupNorm launches {counts}")
            del unet32
        ref = outs["fp32", False]
        rel = {name: errors(outs[key], ref)[1] for name, key in (
            ("fp32 on", ("fp32", True)), ("bf16 off", ("bf16", False)),
            ("bf16 on", ("bf16", True)))}
        rel["bf16 on vs off"] = errors(outs["bf16", True], outs["bf16", False])[1]
        log(f"[fused gn] SDXL UNet forward of the CFG pair at {size}², relative max error "
            f"against the fp32 forward with the opt-in off: fp32 on {rel['fp32 on']:.3g}, "
            f"bf16 off {rel['bf16 off']:.3g}, bf16 on {rel['bf16 on']:.3g}; bf16 on vs off "
            f"{rel['bf16 on vs off']:.3g}")
        if not (rel["fp32 on"] < MODULE_RTOL
                and rel["bf16 on"] < max(MODULE_RTOL, rel["bf16 off"])):
            raise AssertionError(f"fused GroupNorm UNet forward: {rel}")
        del outs, ref
        lat, imgs = {False: [], True: []}, {}

        def request():
            return pipe(ids, uncond, height=size, width=size, num_steps=steps,
                        guidance_scale=GUIDANCE, seed=3)

        for on in (False, True, True, False):
            set_fused_gn(on)
            torch.cuda.synchronize()
            t0 = time.time()
            imgs[on] = request().float()
            torch.cuda.synchronize()
            lat[on].append(time.time() - t0)
        diff = (imgs[True] - imgs[False]).abs().max().item()
        idle = {}
        latent = size // 8
        per_request = groupnorm_calls(models.unet, latent, 2)
        for key, n in groupnorm_calls(models.vae.decoder, latent, 1).items():
            per_request[key] += n
        per_request = {key: n * (steps if key[1] == 2 else 1) for key, n in per_request.items()}
        for on in (False, True):
            set_fused_gn(on)
            idle[on] = profile_run(torch, request, min(lat[on]),
                                   repo / "build" / f"chip_smoke_gn_{'on' if on else 'off'}"
                                   "_profile.txt", f"fused gn {'on' if on else 'off'} profile",
                                   per_request if on else {})
    finally:
        set_fused_gn(False)
    log(f"[fused gn] warm {size}² request, opt-in off {lat[False]} s, on {lat[True]} s "
        f"(turns off, on, on, off); idle share off {idle[False]:.3f}, on {idle[True]:.3f}; "
        f"max |image on - image off| {diff:.4g}")


def write_deployment(torch, models, root):
    """Writes the serving stack `models` in the layouts a user downloads:
    a diffusers model directory (unet/ and vae/ as bf16 safetensors with
    their configs, scheduler/ with SDXL-Turbo's trailing spacing), the
    Chinese-CLIP tower in a transformers BERT directory (text/), the
    reference adapter (proj_0/) and a peft LoRA (lora.safetensors, fp16 as
    LCM-LoRA ships) of rank LORA_RANK over every to_q/to_k/to_v/to_out.0 of
    the UNet, A ~ N(0, 1/in) and B ~ N(0, 0.02²) from a seed. Returns the
    LoRA's {UNet weight name: (A, B)} on the card and {file: bytes}."""
    from pea_diffusion_tpu_torch.checkpoints.orbax_io import export_adapter
    from pea_diffusion_tpu_torch.checkpoints.safetensors_io import save_safetensors

    for sub, config, name, module in (
            ("unet", SDXL_UNET_CONFIG, "diffusion_pytorch_model", models.unet),
            ("vae", SDXL_VAE_CONFIG, "diffusion_pytorch_model", models.vae),
            ("text", CHINESE_CLIP_TEXT_CONFIG, "model", models.text_encoder)):
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(config))
        save_safetensors(str(root / sub / f"{name}.safetensors"), module.state_dict())
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(TURBO_SCHEDULER_CONFIG))
    export_adapter(models.adapter, str(root), 0)
    dev = models.device
    gen = torch.Generator(device=dev).manual_seed(17)
    pairs, lora = {}, {}
    for k, w in models.unet.state_dict().items():
        path = k[:-len(".weight")]
        if not (k.endswith(".weight") and path.endswith((".to_q", ".to_k", ".to_v", ".to_out.0"))):
            continue
        out_f, in_f = w.shape
        a = (torch.randn(LORA_RANK, in_f, generator=gen, device=dev) / in_f ** 0.5).half()
        b = (torch.randn(out_f, LORA_RANK, generator=gen, device=dev) * 0.02).half()
        pairs[k] = (a, b)
        lora[f"unet.{path}.lora_A.weight"], lora[f"unet.{path}.lora_B.weight"] = a, b
    save_safetensors(str(root / "lora.safetensors"), lora)
    return pairs, {str(f.relative_to(root)): f.stat().st_size
                   for f in sorted(root.rglob("*")) if f.is_file()}


def load_deployment(torch, root, device="cuda"):
    """The deployment under `root` through the port's loaders onto the card
    (`device`) in bf16 (the adapter's weights fp32), each load timed: {part: module or
    config} and {load: seconds}. The files were just written, so they are
    read from the page cache."""
    from pea_diffusion_tpu_torch.checkpoints.load_pretrained import (
        load_schedule, load_student_tower, load_unet, load_vae)
    from pea_diffusion_tpu_torch.checkpoints.orbax_io import import_adapter
    from pea_diffusion_tpu_torch.configs.adapter import ADAPTER_PRESETS
    from pea_diffusion_tpu_torch.models.adapter import PEAAdapter
    from pea_diffusion_tpu_torch.pipelines.factory import load_weights

    bf16, d = torch.bfloat16, str(root)

    def adapter():
        with torch.device("meta"):
            m = PEAAdapter(ADAPTER_PRESETS["sdxl_chinese_clip"], dtype=bf16)
        sd = import_adapter(str(root / "proj_0" / "pytorch_model.bin"))
        return load_weights(m, sd, torch.float32, device, "adapter")

    loads = {
        "unet": lambda: load_unet(d, dtype=bf16, device=device),
        "unet with the LoRA fused": lambda: load_unet(
            d, lora_paths=[str(root / "lora.safetensors")], dtype=bf16, device=device),
        "vae": lambda: load_vae(d, dtype=bf16, device=device),
        "schedule": lambda: load_schedule(d),
        "text tower": lambda: load_student_tower("chinese_clip", str(root / "text"), dtype=bf16,
                                                 device=device),
        "adapter": adapter,
    }
    out, seconds = {}, {}
    for name, load in loads.items():
        torch.cuda.synchronize()
        t0 = time.time()
        out[name] = load()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
    return out, seconds


def check_loaded(torch, models, tokenize, loaded, pairs):
    """(a) the loaded stack without the LoRA gives the written stack's bits:
    every UNet and VAE tensor, one UNet forward of the CFG pair at 1024²,
    the text tower and adapter on one prompt; (b) the fused UNet differs
    from it in exactly the LoRA's weights; (c) each fused weight is within
    one bf16 step of bf16(W + B.A), computed here in fp32 (scale 1, no
    alpha). Returns the worst (c) error in bf16 steps and the share of
    elements not equal to that reference."""
    from pea_diffusion_tpu_torch.pipelines.text2image import encode_prompt_sdxl, make_add_time_ids

    unet, fused = loaded["unet"][1], loaded["unet with the LoRA fused"][1]
    if unet.config != models.unet.config or loaded["text tower"][0] != models.text_encoder.config:
        raise AssertionError("fewstep: the loaded configs differ from the written stack's")
    for name, a, b in (("unet", models.unet, unet), ("vae", models.vae, loaded["vae"][1]),
                       ("text tower", models.text_encoder, loaded["text tower"][1]),
                       ("adapter", models.adapter, loaded["adapter"])):
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            raise AssertionError(f"fewstep: the loaded {name} differs from the written one")
    dev = models.device
    ids = torch.as_tensor(tokenize([PROMPTS[0]]), device=dev)
    uncond = torch.as_tensor(tokenize([""]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    size = SERVING["sdxl serving"]["size"]
    x = torch.randn((2, size // 8, size // 8, 4), generator=gen, device=dev)
    t = torch.full((2,), 500, device=dev)
    with torch.inference_mode():
        want = encode_prompt_sdxl(models, ids, uncond)
        got = encode_prompt_sdxl(loaded["models"], ids, uncond)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("fewstep: text tower + adapter bits differ after the load")
        added = {"text_embeds": want[1], "time_ids": make_add_time_ids(
            (size, size), (0, 0), (size, size), 2, dev)}
        if not torch.equal(unet(x, t, want[0], added), models.unet(x, t, want[0], added)):
            raise AssertionError("fewstep: the loaded UNet's forward differs in bits")
    sa, sf = unet.state_dict(), fused.state_dict()
    moved = {k for k in sa if not torch.equal(sa[k], sf[k])}
    if moved != set(pairs):
        raise AssertionError(f"fewstep: {len(moved)} weights moved, the LoRA has "
                             f"{len(pairs)} pairs")
    steps, off, total = 0.0, 0, 0
    for k, (a, b) in pairs.items():
        ref = (sa[k].float() + b.float() @ a.float()).bfloat16().float()
        err = (sf[k].float() - ref).abs() / 2.0 ** (torch.frexp(ref)[1] - 8)
        steps = max(steps, err.max().item())
        off, total = off + int((err > 0).sum()), total + err.numel()
    if steps > 1:
        raise AssertionError(f"fewstep: a fused weight is {steps} bf16 steps from bf16(W + B.A)")
    return steps, off / total


def fewstep_phase(torch, models, tokenize, kernels, repo):
    """Few-step serving from a model directory written from `models` (the
    SDXL serving stack): the write, the loads and their checks
    (`check_loaded`), then each FEWSTEP path: REQUESTS requests at guidance
    0 from launch counts of 0 (B1/B3 launches as the walk gives them, every
    UNet call at batch 1), the first request again (the same bits) and at
    another seed (other bits), and a profile of one request."""
    import shutil

    from pea_diffusion_tpu_torch.pipelines.factory import make_text_encoder_fn
    from pea_diffusion_tpu_torch.pipelines.text2image import PEAModels

    root = repo / "build" / "fewstep_deployment"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.time()
        pairs, sizes = write_deployment(torch, models, root)
        log(f"[fewstep] wrote the deployment in {time.time() - t0:.1f}s: {len(pairs)} LoRA "
            f"pairs of rank {LORA_RANK}; bytes {sizes}")
        loaded, seconds = load_deployment(torch, root, models.device)
        log("[fewstep] load seconds " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
        text_cfg, text = loaded["text tower"]
        vae_cfg, vae = loaded["vae"]
        common = dict(text_encoder=text,
                      text_encoder_fn=make_text_encoder_fn("chinese_clip", text_cfg, text)[1],
                      adapter=loaded["adapter"], vae=vae, schedule=loaded["schedule"],
                      vae_scaling=vae_cfg.scaling_factor, device=models.device)
        loaded["models"] = PEAModels(unet=loaded["unet"][1], **common)
        steps, off = check_loaded(torch, models, tokenize, loaded, pairs)
        log(f"[fewstep] loaded stack = written stack (bits: every tensor, UNet forward, text "
            f"tower + adapter); {len(pairs)} fused weights, the rest unchanged; fused vs "
            f"bf16(W + B.A) in fp32: worst {steps:.3g} bf16 steps, {off:.3g} of the elements "
            f"off; schedule {loaded['schedule']}")
        for path, spec in FEWSTEP.items():
            unet = loaded["unet with the LoRA fused" if spec["lora"] else "unet"][1]
            serve_fewstep(torch, PEAModels(unet=unet, **common), tokenize, path, kernels, repo)
        del loaded, common
        gc.collect()
        torch.cuda.empty_cache()
        startup_phase(root, repo)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_fewstep(torch, models, tokenize, path, kernels, repo):
    """One FEWSTEP path (see `fewstep_phase`)."""
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline

    spec = FEWSTEP[path]
    size, steps = spec["size"], spec["steps"]
    pipe = StableDiffusionXLPEAPipeline(models, spec["sampler"])

    def request(prompt, seed):
        return pipe(tokenize([prompt]), tokenize([""]), height=size, width=size,
                    num_steps=steps, guidance_scale=0.0, seed=seed).float()

    routes = attention_routes(models.unet, size // 8, TEXT_TOKENS)
    batches = []
    hook = models.unet.register_forward_pre_hook(lambda m, args: batches.append(args[0].shape[0]))
    try:
        images, req_s = serve_requests(torch, path, request, size,
                                       [("serving", routes, steps * REQUESTS)], kernels)
    finally:
        hook.remove()
    log(f"[{path}] attention calls per UNet forward at {size}² by (route, sq, skv): "
        f"{dict(routes)}; UNet calls at batch {sorted(set(batches))}")
    if batches != [1] * (steps * (REQUESTS + 1)):  # the requests and the first again
        raise AssertionError(f"{path}: UNet calls at batches {batches}")
    diff = (request(PROMPTS[0], 1) - images[0]).abs().max().item()
    log(f"[{path}] seed 1: max |image difference| {diff:.4g}")
    if not diff > 1e-3:
        raise AssertionError(f"{path}: another seed gave the same image")
    idle = profile_run(torch, lambda: request(PROMPTS[0], 7), min(req_s),
                       repo / "build" / spec["table"], f"{path} profile")
    log(f"[{path}] requests {req_s} s; idle share {idle:.3f}")


def startup_phase(root, repo):
    """tools/bench_startup.py in a fresh process for each of STARTUP_RUNS,
    over the deployment under `root` (its files were just written, so the
    weights are read from the page cache), into one new kernel-library
    cache: each run must build or find the library as its name says and
    give a finite image. Logs each run's JSON line."""
    import os
    import shutil
    import tempfile

    cache = tempfile.mkdtemp(prefix="chip_smoke_aot_", dir=repo / "build")
    try:
        for name, library, extra in STARTUP_RUNS:
            cmd = [sys.executable, "-m", "pea_diffusion_tpu_torch.tools.bench_startup",
                   "--model-dir", str(root), "--aot-cache", cache, *extra]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                                  timeout=STARTUP_TIMEOUT,
                                  env=dict(os.environ, PYTHONPATH=str(repo)))
            wall = time.time() - t0
            for line in proc.stderr.strip().splitlines()[-12:]:
                log(f"[startup {name}] {line}")
            if proc.returncode != 0:
                raise AssertionError(f"startup {name}: exit code {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            log(f"[startup {name}] process wall {wall:.3f}s; {json.dumps(res)}")
            detail = res["detail"]
            size = SERVING["sdxl serving"]["size"]
            if (detail["kernel_library"] != library or not detail["image_ok"]
                    or detail["image_shape"] != [1, size, size, 3]):
                raise AssertionError(f"startup {name}: library {detail['kernel_library']} "
                                     f"(want {library}), image {detail['image_shape']} finite "
                                     f"in [0, 1]: {detail['image_ok']}")
            if not {"pea_onepass_attention_fwd", "pea_flash_attention_fwd"} <= set(
                    detail["launchers"]):
                raise AssertionError(f"startup {name}: prefetch resolved {detail['launchers']}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def int8_conv_checks(torch, F):
    """Each INT8_CONV_SHAPES conv on the card: the int8 product against its
    float64 plain version (the int32 sums must be equal), then CUDA-event
    times of the whole int8 conv (quantize, product, dequantize and bias:
    QConvInt8's forward), of the product alone and of the bf16 cuDNN conv it
    replaces (channels-last, as the models run it), beside the int8
    product's bound."""
    from pea_diffusion_tpu_torch.quant.int8 import (QConvInt8, int8_conv, int8_conv_plain,
                                                    quantize_weight)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for b, c, side, stride in INT8_CONV_SHAPES:
        x = torch.randn(b, c, side, side, generator=gen, device=dev).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(c, c, 3, 3, generator=gen, device=dev) * 0.02).bfloat16()
        bias = torch.zeros(c, device=dev, dtype=torch.bfloat16)
        conv = QConvInt8(c, c, 3, stride).to(dev)
        kq, w_scale = quantize_weight(w)
        with torch.no_grad():
            conv.kernel_q.copy_(kq)
            conv.w_scale.copy_(w_scale)
            conv.x_scale.fill_(x.float().abs().max().item() / 127.0)
        xq = torch.randint(-127, 128, x.shape, generator=gen, device=dev,
                           dtype=torch.int8).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            got = int8_conv(xq, kq, (stride, stride))
            want = int8_conv_plain(xq, kq, (stride, stride))
            exact = torch.equal(got.double(), want)
            del want
            int8_ms = event_ms(torch, lambda: conv(x))
            mm_ms = event_ms(torch, lambda: int8_conv(xq, kq, (stride, stride)))
            bf16_ms = event_ms(torch, lambda: F.conv2d(x, w, bias, stride=stride, padding=1))
        ho = -(-side // stride)
        ops = 2 * b * ho * ho * c * c * 9
        nbytes = x.numel() + kq.numel() + 4 * b * ho * ho * c
        bound_ms = max(ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S) * 1e3
        log(f"[int8 conv] {b}x{c}x{side}² stride {stride}: int32 sums equal to the float64 "
            f"plain version: {exact}; int8 conv {int8_ms:.4f} ms (product alone "
            f"{mm_ms:.4f} ms), bf16 cuDNN conv {bf16_ms:.4f} ms, bf16 / int8 "
            f"{bf16_ms / int8_ms:.3f}; the product's bound {bound_ms:.4f} ms")
        if not exact:
            raise AssertionError(f"int8 conv {b}x{c}x{side}² stride {stride}: the int32 sums "
                                 "differ from the float64 plain version")
        del x, xq, got, conv
        torch.cuda.empty_cache()


def int8_phase(torch, models, tokenize, kernels, repo):
    """Int8 serving on the SDXL serving stack `models` (see INT8_PATH):
    calibrate and quantize, serve, reload the ranges (same bits), the
    widest scope, the conv checks and times, the UNet's eps int8 vs float
    and the worst convs' SQNR."""
    import torch.nn.functional as F

    from pea_diffusion_tpu_torch.pipelines.text2image import (
        StableDiffusionXLPEAPipeline, decode_latents, encode_prompt_sdxl, generate_sdxl,
        make_add_time_ids)
    from pea_diffusion_tpu_torch.quant.int8 import load_ranges, per_conv_sqnr, quantize_for_serving

    size, steps, dev = 1024, SERVING["sdxl serving"]["steps"], models.device
    ids, uncond = tokenize([PROMPTS[0]]), tokenize([""])
    ranges_path = repo / "build" / "chip_smoke_int8_ranges.json"
    wide_path = repo / "build" / "chip_smoke_int8_wide_ranges.json"
    for f in (ranges_path, wide_path):
        f.unlink(missing_ok=True)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        quant = quantize_for_serving(models, ids, uncond, size, ranges_path=str(ranges_path))
        torch.cuda.synchronize()
        ranges = load_ranges(str(ranges_path))
        log(f"[{INT8_PATH}] calibrated and quantized in {time.time() - t0:.3f}s: "
            f"{len(ranges)} conv ranges, max|x| from {min(ranges.values()):.4g} to "
            f"{max(ranges.values()):.4g}")
        pipe = StableDiffusionXLPEAPipeline(quant, "ddim")

        def request(prompt, seed):
            return pipe(tokenize([prompt]), tokenize([""]), height=size, width=size,
                        num_steps=steps, guidance_scale=GUIDANCE, seed=seed)

        routes = attention_routes(quant.unet, size // 8, TEXT_TOKENS)
        images, req_s = serve_requests(torch, INT8_PATH, request, size,
                                       [("serving", routes, steps * REQUESTS)], kernels)
        idle = profile_run(torch, lambda: request(PROMPTS[0], 7), min(req_s),
                           repo / "build" / INT8_TABLE, f"{INT8_PATH} profile")
        log(f"[{INT8_PATH}] requests {req_s} s; idle share {idle:.3f}")

        reloaded = quantize_for_serving(models, ids, uncond, size, ranges_path=str(ranges_path))
        same = torch.equal(StableDiffusionXLPEAPipeline(reloaded, "ddim")(
            ids, uncond, height=size, width=size, num_steps=steps, guidance_scale=GUIDANCE,
            seed=0).float(), images[0])
        log(f"[{INT8_PATH}] quantized again from the ranges file: same bits {same}")
        if not same:
            raise AssertionError(f"{INT8_PATH}: the reloaded ranges gave other bits")
        del reloaded

        with torch.inference_mode():
            context, pooled = encode_prompt_sdxl(quant, torch.as_tensor(ids, device=dev),
                                                 torch.as_tensor(uncond, device=dev))
        added = {"text_embeds": pooled, "time_ids": make_add_time_ids(
            (size, size), (0, 0), (size, size), 2, dev)}
        gen = torch.Generator(device=dev).manual_seed(29)
        x = torch.randn((2, size // 8, size // 8, 4), generator=gen, device=dev).bfloat16()
        t = torch.full((2,), 499, device=dev)
        with torch.inference_mode():
            eps_f = models.unet(x, t, context, added).float()
            eps_q = quant.unet(x, t, context, added).float()
        rel = ((eps_q - eps_f).norm() / eps_f.norm()).item()
        sqnr = per_conv_sqnr(models.unet, [(x, t, context, added)], ranges)
        worst = sorted(sqnr.items(), key=lambda kv: kv[1])[:5]
        log(f"[{INT8_PATH}] UNet eps at t=499, int8 vs bf16 float: rel L2 {rel:.5f}; "
            f"per-conv SQNR over {len(sqnr)} convs, worst five (dB): "
            + ", ".join(f"{k} {v:.2f}" for k, v in worst))
        del quant, pipe, eps_f, eps_q

        wide = quantize_for_serving(models, ids, uncond, size, ranges_path=str(wide_path),
                                    conv_quant=INT8_WIDE)

        def wide_request(prompt, seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return generate_sdxl(wide, tokenize([prompt]), tokenize([""]), generator=gen,
                                 sampler_name="ddim", height=size, width=size,
                                 num_steps=steps, guidance_scale=GUIDANCE, split_decode=True,
                                 decode_chunk=INT8_DECODE_CHUNK)

        routes = attention_routes(wide.unet, size // 8, TEXT_TOKENS)
        _, wide_s = serve_requests(torch, INT8_WIDE_PATH, wide_request, size,
                                   [("serving", routes, steps * REQUESTS)], kernels)
        z = torch.randn((3, size // 8, size // 8, 4), generator=gen, device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            whole = decode_latents(wide, z)
            peak_whole = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            chunked = decode_latents(wide, z, chunk=INT8_DECODE_CHUNK)
            peak_chunked = torch.cuda.max_memory_allocated() / 2**30
            gap = (whole - chunked).abs()
            float_gap = (decode_latents(models, z) - decode_latents(
                models, z, chunk=INT8_DECODE_CHUNK)).abs()
        log(f"[{INT8_WIDE_PATH}] requests {wide_s} s; {INT8_WIDE} decode of 3 latents at "
            f"once vs in chunks of {INT8_DECODE_CHUNK}: |difference| max {gap.max().item():.4g} "
            f"mean {gap.mean().item():.4g} (the bf16 decoder's: max "
            f"{float_gap.max().item():.4g} mean {float_gap.mean().item():.4g}; GroupNorm's "
            f"form and cuDNN's kernels change with the batch), peak memory {peak_whole:.2f} vs "
            f"{peak_chunked:.2f} GiB")
        del wide, whole, chunked
        gc.collect()
        torch.cuda.empty_cache()
        int8_conv_checks(torch, F)
    finally:
        for f in (ranges_path, wide_path):
            f.unlink(missing_ok=True)


def serve_requests(torch, path, request, size, calls, kernels):
    """REQUESTS requests (prompt i, seed i) of `request(prompt, seed)` from
    launch counts of 0: finite [1, size, size, 3] images in [0, 1] and the
    launches of `calls` (stamped on the kernel rows); then the first again,
    which must give the same bits. Returns the images and request seconds."""
    want = path_launches(calls)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    images, req_s = [], []
    for i, prompt in enumerate(PROMPTS[:REQUESTS]):
        torch.cuda.synchronize()
        t0 = time.time()
        images.append(request(prompt, i).float())
        torch.cuda.synchronize()
        req_s.append(time.time() - t0)
        check_image(images[-1], size, f"{path} request {i}", req_s[-1])
    served = launch_counts()
    log(f"[{path}] UNet forwards {[n for _, _, n in calls]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches(path, served, want)
    stamp_launches(kernels, path, calls, served)
    same = torch.equal(request(PROMPTS[0], 0).float(), images[0])
    log(f"[{path}] seed 0 again: same bits {same}")
    if not same:
        raise AssertionError(f"{path}: the same seed gave other bits")
    return images, req_s


def inpaint_inputs(torch, size):
    """A seeded image of 64-pixel blocks and a mask repainting a centred
    square of half the side, preprocessed as the CLI does, on the card."""
    import numpy as np

    from pea_diffusion_tpu_torch.pipelines.inpaint import preprocess_image, preprocess_mask

    blocks = np.random.default_rng(1).integers(0, 256, (size // 64, size // 64, 3))
    image = np.kron(blocks, np.ones((64, 64, 1))).astype(np.uint8)
    mask = np.zeros((size, size), np.uint8)
    mask[size // 4:3 * size // 4, size // 4:3 * size // 4] = 255
    return (torch.from_numpy(preprocess_image(image, size, size)).cuda(),
            torch.from_numpy(preprocess_mask(mask, size, size)).cuda())


def presets_phase(torch, models, tokenize, kernels, repo):
    """The inpainting paths, the base + refiner ensemble, SSD-1B serving and
    the SD2.1 checks, on the SDXL serving stack's tower, adapter and VAE
    (`models`), each extra UNet built from a seed and freed after its path."""
    from pea_diffusion_tpu_torch import configs
    from pea_diffusion_tpu_torch.pipelines.factory import with_unet

    for path, spec in INPAINT.items():
        m = models if spec["unet"] is None else with_unet(
            models, getattr(configs, spec["unet"]), seed=11)
        serve_inpaint(torch, m, tokenize, path, kernels, repo)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    refiner = with_unet(models, configs.SDXL_REFINER_UNET,
                        configs.AdapterConfig(**REFINER_ADAPTER), seed=12)
    reference_attention_modules(torch, refiner.unet, PRESET_SIZE // 8, (1, 2))
    serve_ensemble(torch, models, refiner, tokenize, kernels, repo)
    del refiner
    gc.collect()
    torch.cuda.empty_cache()
    serve_ssd_1b(torch, with_unet(models, configs.SSD_1B_UNET, seed=13), tokenize, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    sd21_checks(torch, kernels)


def serve_inpaint(torch, models, tokenize, path, kernels, repo):
    """One INPAINT path: REQUESTS requests (`serve_requests`), the VAE
    encodes' and the UNet's stage times; for the blend, the final latents
    outside the mask against the image's encoded latents (bit for bit; both
    captured by wrapping the inpaint module's decode_latents and
    encode_vae_image) and a request at `other_strength`, which must differ;
    for the 9-channel path, a profile."""
    from pea_diffusion_tpu_torch.pipelines import inpaint
    from pea_diffusion_tpu_torch.pipelines.text2image import (encode_prompt_sdxl,
                                                              make_add_time_ids)

    spec, size, steps = INPAINT[path], PRESET_SIZE, PRESET_STEPS
    latent, nine = size // 8, models.unet.config.in_channels == 9
    image, mask = inpaint_inputs(torch, size)

    def request(prompt, seed, strength=spec["strength"]):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return inpaint.generate_sdxl_inpaint(
            models, tokenize([prompt]), tokenize([""]), image, mask, generator=gen,
            sampler_name="ddim", height=size, width=size, num_steps=steps,
            guidance_scale=GUIDANCE, strength=strength)

    forwards = steps - inpaint.strength_start(steps, spec["strength"])
    routes = attention_routes(models.unet, latent, TEXT_TOKENS)
    log(f"[{path}] {models.unet.config.in_channels}-channel UNet, strength {spec['strength']}: "
        f"steps {steps - forwards}-{steps - 1} ({forwards} UNet forwards a request)")
    images, req_s = serve_requests(torch, path, request, size,
                                   [("serving", routes, forwards * REQUESTS)], kernels)

    if not nine:
        encoded, final = [], []
        encode, decode = inpaint.encode_vae_image, inpaint.decode_latents

        def encode_and_keep(*args, **kw):
            encoded.append(encode(*args, **kw))
            return encoded[-1]

        def keep_and_decode(m, z, *args, **kw):
            final.append(z)
            return decode(m, z, *args, **kw)

        inpaint.encode_vae_image, inpaint.decode_latents = encode_and_keep, keep_and_decode
        try:
            again = request(PROMPTS[0], 0).float()
        finally:
            inpaint.encode_vae_image, inpaint.decode_latents = encode, decode
        keep = inpaint.mask_to_latents(mask, latent, latent)[0, ..., 0] == 0
        final, encoded = final[0][0].float(), encoded[0][0].float()  # the image's, not the masked
        kept = torch.equal(final[keep], encoded[keep])
        repainted = (final[~keep] - encoded[~keep]).abs().max().item()
        other = request(PROMPTS[0], 0, spec["other_strength"]).float()
        diff = (other - images[0]).abs().max().item()
        log(f"[{path}] final latents outside the mask ({int(keep.sum())} of {keep.numel()} "
            f"positions x 4) equal the image's encoded latents: {kept}; inside, max "
            f"|difference| {repainted:.4g}; same bits as request 0: "
            f"{torch.equal(again, images[0])}; strength {spec['other_strength']}: max |image "
            f"difference| {diff:.4g}")
        if not kept or not repainted > 0 or not diff > 1e-3:
            raise AssertionError(f"{path}: the blend did not keep the image outside the "
                                 f"mask ({kept}, {repainted}) or strength did nothing ({diff})")

    dev = models.device
    ids = torch.as_tensor(tokenize([PROMPTS[0]]), device=dev)
    uncond = torch.as_tensor(tokenize([""]), device=dev)
    x = torch.randn((2, latent, latent, models.unet.config.in_channels), device=dev)
    t = torch.full((2,), 500, device=dev)
    with torch.inference_mode():
        context, pooled = encode_prompt_sdxl(models, ids, uncond)
        added = {"text_embeds": pooled, "time_ids": make_add_time_ids(
            (size, size), (0, 0), (size, size), 2, dev)}
        enc = event_ms(torch, lambda: encode_prompt_sdxl(models, ids, uncond))
        vae_enc = event_ms(torch, lambda: inpaint.encode_vae_image(models, image))
        unet = event_ms(torch, lambda: models.unet(x, t, context, added))
        dec = event_ms(torch, lambda: inpaint.decode_latents(models, x[:1, ..., :4]))
    attn_ms = sum(e["ms"] * e["launches_by_path"][path] for e in kernels) / (
        forwards * REQUESTS)
    log(f"[{path} stages] prompt encoding {enc:.3f} ms; VAE encode {vae_enc:.3f} ms (two a "
        f"request: the image and the masked image); UNet forward of the CFG pair {unet:.3f} "
        f"ms, of which attention kernels ~{attn_ms:.3f} ms; VAE decode {dec:.3f} ms")
    if "table" in spec:
        idle = profile_run(torch, lambda: request(PROMPTS[0], 7), min(req_s),
                           repo / "build" / spec["table"], f"{path} profile")
        log(f"[{path}] requests {req_s} s; idle share {idle:.3f}")
    else:
        log(f"[{path}] requests {req_s} s")


def serve_ensemble(torch, base, refiner, tokenize, kernels, repo):
    """The base + refiner ensemble: REQUESTS requests (`serve_requests`;
    launches keyed by heads, the base's and the refiner's calls apart), each
    stage's time and a profile."""
    from pea_diffusion_tpu_torch.pipelines.sampling import make_sampler
    from pea_diffusion_tpu_torch.pipelines.text2image import (
        decode_latents, encode_prompt_sdxl, generate_sdxl_ensemble, make_add_time_ids,
        steps_at_or_above)

    size, steps, latent, path = PRESET_SIZE, PRESET_STEPS, PRESET_SIZE // 8, ENSEMBLE_PATH

    def request(prompt, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return generate_sdxl_ensemble(
            base, refiner, tokenize([prompt]), tokenize([""]), generator=gen, height=size,
            width=size, num_steps=steps, guidance_scale=GUIDANCE,
            high_noise_frac=HIGH_NOISE_FRAC, sampler_name="ddim")

    base_steps = steps_at_or_above(make_sampler("ddim", base.schedule, steps), base.schedule,
                                   HIGH_NOISE_FRAC)
    calls = [("serving", attention_routes(base.unet, latent, TEXT_TOKENS, heads=True),
              base_steps * REQUESTS),
             ("serving", attention_routes(refiner.unet, latent, TEXT_TOKENS, heads=True),
              (steps - base_steps) * REQUESTS)]
    log(f"[{path}] base steps 0-{base_steps - 1}, refiner {base_steps}-{steps - 1}; refiner "
        f"calls per forward by (route, sq, skv, heads): {dict(calls[1][1])}")
    _, req_s = serve_requests(torch, path, request, size, calls, kernels)

    dev = base.device
    ids = torch.as_tensor(tokenize([PROMPTS[0]]), device=dev)
    uncond = torch.as_tensor(tokenize([""]), device=dev)
    x = torch.randn((2, latent, latent, 4), device=dev)
    t = torch.full((2,), 500, device=dev)
    times = {}
    with torch.inference_mode():
        for name, m, tid in (("base", base, {}), ("refiner", refiner, {"aesthetic_score": 6.0})):
            context, pooled = encode_prompt_sdxl(m, ids, uncond)
            added = {"text_embeds": pooled, "time_ids": make_add_time_ids(
                (size, size), (0, 0), (size, size), 2, dev, **tid)}
            times[f"{name} prompt encoding"] = event_ms(
                torch, lambda m=m: encode_prompt_sdxl(m, ids, uncond))
            times[f"{name} UNet forward (CFG pair)"] = event_ms(
                torch, lambda m=m, c=context, a=added: m.unet(x, t, c, a))
        times["VAE decode"] = event_ms(torch, lambda: decode_latents(refiner, x[:1]))
    log(f"[{path} stages] " + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    idle = profile_run(torch, lambda: request(PROMPTS[0], 7), min(req_s),
                       repo / "build" / ENSEMBLE_TABLE, f"{path} profile")
    log(f"[{path}] requests {req_s} s; idle share {idle:.3f}")


def serve_ssd_1b(torch, models, tokenize, kernels):
    """SSD-1B through StableDiffusionXLPEAPipeline: REQUESTS requests of
    SSD_1B_STEPS DDIM steps (`serve_requests`)."""
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline

    size, latent = PRESET_SIZE, PRESET_SIZE // 8
    pipe = StableDiffusionXLPEAPipeline(models, sampler_name="ddim")
    routes = attention_routes(models.unet, latent, TEXT_TOKENS)
    log(f"[{SSD_1B_PATH}] {sum(p.numel() for p in models.unet.parameters()) / 1e9:.3f}B UNet "
        f"parameters; calls per forward by (route, sq, skv): {dict(routes)}")
    _, req_s = serve_requests(
        torch, SSD_1B_PATH, lambda prompt, seed: pipe(
            tokenize([prompt]), tokenize([""]), height=size, width=size,
            num_steps=SSD_1B_STEPS, guidance_scale=GUIDANCE, seed=seed),
        size, [("serving", routes, SSD_1B_STEPS * REQUESTS)], kernels)
    log(f"[{SSD_1B_PATH}] requests {req_s} s")


def sd21_checks(torch, kernels):
    """SD2.1's UNet in bf16 from a seed: its level-0/1 attention modules at
    768² through the kernels against plain attention, then one forward of
    the CFG pair over SD21_TOKENS random text states from launch counts of
    0 (finite, the launches the walk gives)."""
    from pea_diffusion_tpu_torch import configs
    from pea_diffusion_tpu_torch.pipelines.factory import build_unet

    latent = SD21_SIZE // 8
    unet = build_unet(configs.SD21_UNET, seed=14)
    reference_attention_modules(torch, unet, latent, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((2, latent, latent, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, SD21_TOKENS, configs.SD21_UNET.cross_attention_dim), generator=gen,
                      device="cuda")
    t = torch.full((2,), 500, device="cuda")
    calls = [("serving", attention_routes(unet, latent, SD21_TOKENS), 1)]
    want = path_launches(calls)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.inference_mode():
        out = unet(x, t, ctx).float()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    served = launch_counts()
    log(f"[{SD21_PATH}] {SD21_SIZE}²: calls by (route, head dim) "
        f"{dict(routes_by_head_dim(unet, latent, SD21_TOKENS))}; output "
        f"{tuple(out.shape)} std {out.std().item():.4f} in {seconds:.4f}s")
    check_launches(SD21_PATH, served, want)
    stamp_launches(kernels, SD21_PATH, calls, served)
    if tuple(out.shape) != (2, latent, latent, 4) or not bool(out.isfinite().all()):
        raise AssertionError(f"{SD21_PATH}: output {tuple(out.shape)} not finite")
    del unet, out
    gc.collect()
    torch.cuda.empty_cache()


def tower_configs(names):
    """The configs a TOWERS entry names: one, or mul_zh's (mul, zh) pair;
    the TINY_TOWER_SETTINGS names are BERT_TINY with those settings."""
    import dataclasses

    from pea_diffusion_tpu_torch import configs

    cfgs = tuple(dataclasses.replace(configs.BERT_TINY, **TINY_TOWER_SETTINGS[n])
                 if n in TINY_TOWER_SETTINGS else getattr(configs, n) for n in names)
    return cfgs if len(cfgs) == 2 else cfgs[0]


def tower_ids(cfg, seed, lengths):
    """[len(lengths), TEXT_TOKENS] int64 ids drawn inside `cfg`'s vocab from
    `seed`, row i real for lengths[i] tokens and then the pad id, as a
    tokenizer pads; for mul_zh's (mul, zh) configs a {"mul", "zh"} dict of
    such rows, the same length."""
    import numpy as np

    if isinstance(cfg, tuple):
        return {k: tower_ids(c, seed + i, lengths)
                for i, (k, c) in enumerate(zip(("mul", "zh"), cfg))}
    ids = np.random.default_rng(seed).integers(5, cfg.vocab_size, (len(lengths), TEXT_TOKENS))
    for row, n in enumerate(lengths):
        ids[row, n:] = cfg.pad_token_id
    return ids


def reference_tiny_tower(torch, family, cfg):
    """The family's tiny tower in fp32 (torch's default initialisation from
    seed 0) on the card against the same weights on the CPU."""
    import copy

    from pea_diffusion_tpu_torch.pipelines.factory import make_text_encoder_fn
    from pea_diffusion_tpu_torch.pipelines.text2image import as_ids

    torch.manual_seed(0)
    cpu, cpu_fn = make_text_encoder_fn(family, cfg)
    _, gpu_fn = make_text_encoder_fn(family, cfg, copy.deepcopy(cpu).cuda())
    ids = tower_ids(cfg, 3, TOWER_PROMPT_LENGTHS)
    with torch.inference_mode():
        want = cpu_fn(as_ids(ids, "cpu"))
        got = gpu_fn(as_ids(ids, "cuda")).cpu()
    err = (got - want).abs().max().item()
    log(f"[reference] tiny {family} tower {tuple(want.shape)}, card vs CPU (fp32): max abs "
        f"{err:.3g}")
    if not err < TINY_ATOL:
        raise AssertionError(f"tiny {family} tower on the card differs from the CPU: {err}")


def towers_phase(torch, models, kernels, repo):
    """Each other student family of TOWERS on the SDXL serving stack's UNet
    and VAE (`serve_tower`), each tower freed before the next."""
    t1 = time.time()
    for path in TOWERS:
        serve_tower(torch, models, path, kernels, repo)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[towers] phase took {time.time() - t1:.1f}s")


def serve_tower(torch, base, path, kernels, repo):
    """One TOWERS path: the tiny tower on the card against the CPU; the
    full-width bf16 tower and its adapter (fp32 weights) from a seed on
    `base`'s UNet and VAE; REQUESTS requests through
    StableDiffusionXLPEAPipeline (`serve_requests`); the prompt-encoding
    stage time; the full-width tower's states against an fp32 copy of it on
    the card (printed, not gated); a profile where the spec names a table."""
    import copy

    from pea_diffusion_tpu_torch import configs
    from pea_diffusion_tpu_torch.pipelines.factory import make_text_encoder_fn, with_text_tower
    from pea_diffusion_tpu_torch.pipelines.text2image import (StableDiffusionXLPEAPipeline,
                                                              as_ids, encode_prompt_sdxl)

    spec = TOWERS[path]
    family, size = spec["family"], PRESET_SIZE
    reference_tiny_tower(torch, family, tower_configs(spec["tiny"]))
    cfg = tower_configs(spec["text"])
    torch.cuda.synchronize()
    t0 = time.time()
    models = with_text_tower(base, family, cfg, configs.ADAPTER_PRESETS[spec["adapter"]],
                             seed=21)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models.text_encoder.parameters())
    log(f"[{path}] the {family} tower at full width in bf16 ({n_params / 1e9:.3f}B "
        f"parameters) and the {spec['adapter']} adapter built in {time.time() - t0:.1f}s")
    pipe = StableDiffusionXLPEAPipeline(models, sampler_name="ddim")
    uncond = tower_ids(cfg, 100, (2,))

    def request(prompt, seed):
        ids = tower_ids(cfg, 10 + seed, (TOWER_PROMPT_LENGTHS[seed % 2],))
        return pipe(ids, uncond, height=size, width=size, num_steps=TOWER_STEPS,
                    guidance_scale=GUIDANCE, seed=seed)

    routes = attention_routes(models.unet, size // 8, TEXT_TOKENS)
    _, req_s = serve_requests(torch, path, request, size,
                              [("serving", routes, TOWER_STEPS * REQUESTS)], kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    dev = models.device
    ids = as_ids(tower_ids(cfg, 10, TOWER_PROMPT_LENGTHS[:1]), dev)
    un = as_ids(uncond, dev)
    with torch.inference_mode():
        enc_ms = event_ms(torch, lambda: encode_prompt_sdxl(models, ids, un))
        got = models.text_encoder_fn(ids).float()
        _, fp32_fn = make_text_encoder_fn(family, cfg, copy.deepcopy(models.text_encoder).float())
        want = fp32_fn(ids)
    _, gap = errors(got, want)
    del fp32_fn  # the fp32 copy
    log(f"[{path} stages] prompt encoding (tower + adapter, the CFG pair) {enc_ms:.3f} ms; "
        f"tower states {tuple(got.shape)}, bf16 against fp32 of the same weights on the "
        f"card: max relative gap {gap:.4g} (printed, not gated)")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{path}: the tower's states are not finite")
    idle = "not profiled"
    if "table" in spec:
        idle = "{:.3f}".format(profile_run(torch, lambda: request(PROMPTS[0], 0), min(req_s),
                                           repo / "build" / spec["table"], f"{path} profile"))
    log(f"[{path}] requests {req_s} s; idle share {idle}; {n_params / 1e9:.3f}B tower "
        f"parameters; peak memory {peak:.2f} GiB")


class RecordingPipe:
    """The serving pipeline, each call's inputs and host seconds (up to the
    card's end of the call) recorded, for the batched serving phase."""

    def __init__(self, torch, pipe):
        self.torch, self.pipe, self.models = torch, pipe, pipe.models
        self.calls = []

    def __call__(self, *args, **kwargs):
        t0 = time.time()
        out = self.pipe(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.calls.append(dict(args=args, kwargs=kwargs, seconds=time.time() - t0))
        return out


def batched_calls(routes, batch_hist, steps):
    """The attention calls of the engine's pipeline calls: [("serving",
    {(route, sq, skv, CFG batch): calls per UNet forward}, forwards)] for
    each group size n of `batch_hist` ({str(n): calls}), padded to a power
    of two."""
    calls = {}
    for n, count in batch_hist.items():
        b = 2 * (1 << (int(n) - 1).bit_length())
        calls[b] = calls.get(b, 0) + steps * count
    return [("serving", {key + (b,): v for key, v in routes.items()}, forwards)
            for b, forwards in sorted(calls.items())]


def decode_png(data):
    import io

    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return img, np.asarray(img.convert("RGB"))


def batched_serve_phase(torch, models, tokenize, kernels, repo):
    """The port's HTTP server and BatchingEngine over the SDXL serving stack,
    loaded by the port's client (BATCHED), from launch counts of 0: every
    response a 1024x1024 RGB PNG, fewer engine calls than requests, B1 and
    B3 as the walk gives them at each call's padded batch (70 each a UNet
    forward); requests/s, latency, the engine's counters, peak memory. Then
    the co-batched call with the most requests again through the pipeline
    with the same ids, noise and guidance: each of its requests' PNGs must
    hold that run's to_pil image bit for bit (and each row of every call,
    found by its request's noise, must carry that request's ids and
    guidance); the same inputs at
    `profile_steps` under the profiler; and one of the requests alone, its
    difference from the co-batched image printed. Returns
    ({request index: PNG bytes} of the timed load, the same of the warm-up
    requests and the solo one, {index: prompt})."""
    import threading

    import numpy as np

    from pea_diffusion_tpu_torch.cli.serve import BatchingEngine, make_server
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline, to_pil
    from pea_diffusion_tpu_torch.tools import bench_serve

    spec, size, path = BATCHED, PRESET_SIZE, BATCHED_PATH
    pipe = RecordingPipe(torch, StableDiffusionXLPEAPipeline(models, spec["sampler"]))
    engine = BatchingEngine(pipe, tokenize, size, max_batch=spec["max_batch"],
                            window_ms=spec["window_ms"])
    srv = make_server(engine, 0, spec["steps"], host="127.0.0.1")
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        if not bench_serve.wait_healthy("127.0.0.1", port, timeout_s=60):
            raise AssertionError(f"{path}: the server never answered /healthz")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        load = bench_serve.run("127.0.0.1", port, clients=spec["clients"],
                               requests=spec["requests"], steps=spec["steps"],
                               mixed_guidance=True, warmup=spec["warmup"], timeout_s=900,
                               keep_images=True)
        served = launch_counts()
        load_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = engine.stats_snapshot()
        cob = load["cobatch"]
        log(f"[{path}] {load['requests']} timed requests in {load['wall_s']:.4f} s: "
            f"{load['requests_per_s']:.4f} requests/s, p50 {load['p50_s']:.4f} s, p95 "
            f"{load['p95_s']:.4f} s, max {load['max_s']:.4f} s; timed load: engine calls "
            f"{cob.get('device_calls')} for {cob.get('requests_batched')} requests "
            f"({cob.get('vector_cfg_calls')} with a guidance vector); whole run "
            f"({load_s:.1f} s, warm-up included): {stats}; peak memory {peak:.2f} GiB")
        if load["errors"]:
            raise AssertionError(f"{path}: {len(load['errors'])} failed requests, first: "
                                 f"{load['errors'][0]}")
        n_timed, first = spec["requests"], spec["warmup"] + spec["clients"]
        if load["requests"] != n_timed or len(load["images"]) != first + n_timed:
            raise AssertionError(f"{path}: {load['requests']} timed requests answered, "
                                 f"{len(load['images'])} PNGs")
        if not (0 < cob["device_calls"] < cob["requests_batched"]
                and stats["device_calls"] < stats["requests_batched"]):
            raise AssertionError(f"{path}: no co-batching: {cob}, {stats}")
        pixels = {}
        for i, data in load["images"].items():
            img, pixels[i] = decode_png(data)
            if img.size != (size, size) or img.mode != "RGB":
                raise AssertionError(f"{path}: request {i} gave a {img.mode} {img.size} PNG")
        routes = attention_routes(models.unet, size // 8, TEXT_TOKENS)
        calls = batched_calls(routes, stats["batch_hist"], spec["steps"])
        per_kernel = stats["device_calls"] * spec["steps"] * sum(routes.values()) // 2
        log(f"[{path}] UNet forwards by CFG batch "
            f"{ {next(iter(r))[3]: n for _, r, n in calls} }; B1 and B3 want {per_kernel} "
            f"each ({stats['device_calls']} calls x {spec['steps']} steps x "
            f"{sum(routes.values()) // 2})")
        check_launches(path, served, path_launches(calls))
        if not served["B1"] == served["B3"] == per_kernel:
            raise AssertionError(f"{path}: B1 {served['B1']}, B3 {served['B3']}, want "
                                 f"{per_kernel} each")
        stamp_launches(kernels, path, calls, served)

        noise = {i: engine._noise(i, 1)[0] for i in range(first, first + n_timed)}
        groups = []
        for call in pipe.calls:
            rows = call["kwargs"]["init_noise"]
            match = {j: i for j in range(len(rows)) for i, n in noise.items()
                     if np.array_equal(rows[j], n)}
            groups.append((len(match), call, match))
        for _, c, m in groups:  # each row carries its own request's ids and guidance
            ids = np.asarray(c["args"][0])
            gs = np.broadcast_to(np.asarray(c["kwargs"]["guidance_scale"], np.float32),
                                 (len(c["kwargs"]["init_noise"]),))
            for j, i in m.items():
                body = bench_serve.request_body(i, spec["steps"], True)
                if not (np.array_equal(ids[j], tokenize([body["prompt"]])[0])
                        and gs[j] == np.float32(body["guidance"])):
                    raise AssertionError(f"{path}: row {j} of an engine call has request "
                                         f"{i}'s noise but not its ids or guidance")
        n, call, match = max(groups, key=lambda g: g[0])
        if n < 2:
            raise AssertionError(f"{path}: no engine call co-batched timed requests")
        t0 = time.time()
        again = to_pil(pipe.pipe(*call["args"], **call["kwargs"]))
        same = all(np.array_equal(np.asarray(again[j]), pixels[i]) for j, i in match.items())
        log(f"[{path}] requests {sorted(match.values())} again through the pipeline in "
            f"{time.time() - t0:.4f} s (the engine's call {call['seconds']:.4f} s): served PNGs "
            f"equal the pipeline's images bit for bit: {same}")
        if not same:
            raise AssertionError(f"{path}: a served PNG differs from its pipeline image")
        short = dict(call["kwargs"], num_steps=spec["profile_steps"])
        torch.cuda.synchronize()
        t0 = time.time()
        pipe.pipe(*call["args"], **short)
        torch.cuda.synchronize()
        short_s = time.time() - t0
        profile_run(torch, lambda: pipe.pipe(*call["args"], **short), short_s,
                    repo / "build" / spec["table"],
                    f"{path} profile (the call's {n} requests, CFG batch "
                    f"{2 * len(call['kwargs']['init_noise'])}, {spec['profile_steps']} steps)")

        solo_i = min(match.values())
        status, body = post_generate(port, bench_serve.request_body(solo_i, spec["steps"], True))
        if status != 200:
            raise AssertionError(f"{path}: the solo request gave {status}: {body[:200]!r}")
        _, solo = decode_png(body)
        diff = np.abs(solo.astype(np.int16) - pixels[solo_i].astype(np.int16))
        rest = min(np.abs(solo.astype(np.int16) - pixels[i].astype(np.int16)).mean()
                   for i in match.values() if i != solo_i)
        log(f"[{path}] request {solo_i} alone against co-batched: max {int(diff.max())} "
            f"mean {diff.mean():.4f} uint8 levels (printed, not gated); against the call's "
            f"other requests: mean at least {rest:.4f}")
        j_solo = next(j for j, i in match.items() if i == solo_i)
        batch_invariance(torch, pipe.pipe, call, pipe.calls[-1], j_solo, spec, path)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)
        engine.close(60)
    timed = {i: d for i, d in load["images"].items() if i >= first}
    others = {i: d for i, d in load["images"].items() if i < first}
    others[f"solo {solo_i}"] = body
    prompts = {i: bench_serve.request_body(i, spec["steps"], True)["prompt"] for i in timed}
    return timed, others, prompts


def batch_invariance(torch, pipe, group, solo, row, spec, path):
    """Solo against co-batched again through the pipeline, the engine's
    recorded inputs of the co-batched call `group` (the request at `row`)
    and of the solo call: at `profile_steps` with GroupNorm's form left to
    the batch (grouped up to 2 rows, sums from 3; the served steps are the
    HTTP reading), then with the form pinned to the grouped one
    (PEA_GN_GROUPED=1), so that the form's share of the difference shows.
    Printed, not gated."""
    import os

    import numpy as np

    from pea_diffusion_tpu_torch.pipelines.text2image import to_pil

    def image(call, steps, j):
        out = pipe(*call["args"], **dict(call["kwargs"], num_steps=steps))
        return np.asarray(to_pil(out[j:j + 1])[0]).astype(np.int16)

    before = os.environ.get("PEA_GN_GROUPED")
    try:
        for pin, steps in ((None, spec["profile_steps"]), ("1", spec["profile_steps"])):
            if pin is None:
                os.environ.pop("PEA_GN_GROUPED", None)
            else:
                os.environ["PEA_GN_GROUPED"] = pin
            diff = np.abs(image(group, steps, row) - image(solo, steps, 0))
            log(f"[{path}] solo against co-batched through the pipeline, {steps} steps, "
                f"GroupNorm {'pinned grouped' if pin else 'by batch'}: max "
                f"{int(diff.max())} mean {diff.mean():.4f} uint8 levels")
    finally:
        if before is None:
            os.environ.pop("PEA_GN_GROUPED", None)
        else:
            os.environ["PEA_GN_GROUPED"] = before


def post_generate(port, req):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        c.request("POST", "/generate", json.dumps(req))
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def write_clip_dir(torch, root, device="cuda"):
    """The Chinese-CLIP dual tower at full width in fp32 from EVAL_SEED, on
    the card, written under `root` as a transformers ChineseCLIPModel
    directory: config.json (text_config, vision_config, projection_dim)
    and model.safetensors (text_model.*, vision_model.*, text_projection,
    visual_projection). Returns the bytes written."""
    from pea_diffusion_tpu_torch.checkpoints.safetensors_io import save_safetensors
    from pea_diffusion_tpu_torch.configs.text_encoder import CHINESE_CLIP_LARGE
    from pea_diffusion_tpu_torch.models.bert_text import BertTextEncoder
    from pea_diffusion_tpu_torch.models.clip_vision import CHINESE_CLIP_VIT_H, CLIPVisionEncoder
    from pea_diffusion_tpu_torch.pipelines.factory import _materialize

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(EVAL_SEED)
    with torch.device("meta"):
        text, vision = BertTextEncoder(CHINESE_CLIP_LARGE), CLIPVisionEncoder(CHINESE_CLIP_VIT_H)
    text = _materialize(text, torch.float32, dev, gen)
    vision = _materialize(vision, torch.float32, dev, gen)
    proj = CHINESE_CLIP_VIT_H.projection_dim
    sd = {f"text_model.{k}": v for k, v in text.state_dict().items()}
    for k, v in vision.state_dict().items():
        sd[k if k.startswith("visual_projection.") else f"vision_model.{k}"] = v
    sd["text_projection.weight"] = torch.empty(proj, CHINESE_CLIP_LARGE.hidden_size,
                                               device=dev).normal_(0.0, 0.02, generator=gen)
    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps({
        "model_type": "chinese_clip", "projection_dim": proj,
        "text_config": CHINESE_CLIP_TEXT_CONFIG, "vision_config": CLIP_VISION_CONFIG}))
    save_safetensors(str(root / "model.safetensors"), sd)
    return sum(f.stat().st_size for f in root.iterdir())


def evaluate_phase(torch, tokenize, pngs, repo, device="cuda"):
    """The evaluate CLI's path on the batched serving phase's PNGs: the
    dual tower written (`write_clip_dir`) and loaded back with
    `cli.evaluate.load_dual_tower`; CLIP-score of the timed images against
    the ids their prompts were served from; CLIP-FID of the timed images
    against the warm-up and solo ones, and of the timed set against
    itself; the same directory loaded on the CPU: two images' vision
    features, every prompt's text features and the two images' cosines
    with their prompts on the card against it; load seconds and the vision
    tower's ms per 32-image chunk."""
    import shutil

    import numpy as np

    from pea_diffusion_tpu_torch.cli.evaluate import clip_score, load_dual_tower
    from pea_diffusion_tpu_torch.models.clip_vision import preprocess_clip_image
    from pea_diffusion_tpu_torch.utils.fid import fid_from_features

    timed, others, prompts = pngs
    root = repo / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    try:
        paths = {}
        (root / "images").mkdir(parents=True)
        for name, data in list(timed.items()) + list(others.items()):
            paths[name] = root / "images" / f"{name}.png".replace(" ", "_")
            paths[name].write_bytes(data)
        t0 = time.time()
        nbytes = write_clip_dir(torch, root / "cn-clip", device)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        write_s = time.time() - t0
        t0 = time.time()
        towers = load_dual_tower(str(root / "cn-clip"), device)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        n_params = sum(p.numel() for m in (towers.text, towers.vision) for p in m.parameters())
        log(f"[evaluate] dual tower ({n_params / 1e9:.3f}B parameters, fp32) written in "
            f"{write_s:.1f} s ({nbytes / 2**30:.2f} GiB), loaded in {load_s:.4f} s")

        order = sorted(timed)
        a_paths = [str(paths[i]) for i in order]
        b_paths = [str(paths[k]) for k in others]
        torch.cuda.synchronize()
        t0 = time.time()
        feats_a = towers.image_features(a_paths)
        torch.cuda.synchronize()
        feat_s = time.time() - t0
        feats_b = towers.image_features(b_paths)
        ids = tokenize([prompts[i] for i in order])
        text = towers.text_features(ids)
        scores = clip_score(text, feats_a).cpu().numpy()
        cos = torch.nn.functional.cosine_similarity(text, feats_a).cpu().numpy()
        fa, fb = feats_a.cpu().numpy(), feats_b.cpu().numpy()
        fid_ab, fid_aa = fid_from_features(fa, fb), fid_from_features(fa, fa)
        log(f"[evaluate] CLIP-score over {len(scores)} images: mean {scores.mean():.6f} "
            f"(min {scores.min():.6f}, max {scores.max():.6f}; cosines before the clamp at 0 "
            f"{cos.min():.6f} to {cos.max():.6f}: random towers); CLIP-FID {fid_ab:.6f} "
            f"({len(fa)} co-batched against {len(fb)} warm-up and solo images); FID(A, A) "
            f"{fid_aa:.3e} (want < {FID_SELF_TOL}); features of {len(a_paths)} images "
            f"{feat_s:.4f} s with decode and preprocessing")
        if not (np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()):
            raise AssertionError(f"evaluate: CLIP-scores {scores}")
        if not (np.isfinite(fid_ab) and fid_ab >= 0 and 0 <= fid_aa < FID_SELF_TOL):
            raise AssertionError(f"evaluate: CLIP-FID {fid_ab}, FID(A, A) {fid_aa}")
        if tuple(fa.shape) != (len(a_paths), towers.vision.config.projection_dim):
            raise AssertionError(f"evaluate: features {fa.shape}")

        size = towers.vision.config.image_size
        imgs = np.stack([decode_png(timed[i])[1] for i in order[:32]])
        pix = torch.from_numpy(preprocess_clip_image(imgs, size).astype(np.float32))
        pix32 = torch.cat([pix, torch.zeros((32 - len(pix),) + tuple(pix.shape[1:]))]).to(device)
        with torch.inference_mode():
            chunk_ms = event_ms(torch, lambda: towers.vision(pix32))
        log(f"[evaluate] vision tower {chunk_ms:.3f} ms per 32-image chunk (CUDA events)")

        cpu = load_dual_tower(str(root / "cn-clip"), "cpu")
        with torch.inference_mode():
            got = towers.vision(pix[:2].to(device))
            want = cpu.vision(pix[:2])
        text_cpu = cpu.text_features(ids)
        rels = {}
        for name in ("projected", "pooled", "last_hidden_state"):
            _, rels[name] = errors(getattr(got, name).cpu(), getattr(want, name))
        _, rels["text_features"] = errors(text.cpu(), text_cpu)
        cos_cpu = torch.nn.functional.cosine_similarity(text_cpu[:2], want.projected).numpy()
        cos_err = float(np.abs(cos[:2] - cos_cpu).max())
        log(f"[evaluate] card against CPU (fp32, TF32 off): relative max error of 2 images' "
            f"vision features and {len(order)} prompts' text features {rels} (want < "
            f"{EVAL_RTOL}); the 2 images' cosines with their prompts {cos[:2].tolist()} "
            f"against {cos_cpu.tolist()}: max abs error {cos_err:.3e} (want < {COSINE_ATOL})")
        if not all(r < EVAL_RTOL for r in rels.values()):
            raise AssertionError(f"evaluate: card features differ from the CPU's: {rels}")
        if not cos_err < COSINE_ATOL:
            raise AssertionError(f"evaluate: card cosines {cos[:2]} against the CPU's {cos_cpu}")
        del towers, cpu, feats_a, feats_b, text
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def mul_zh_kd_step(torch, models, kernels):
    """One kd_loss + backward of the SDXL KD stack `models` with the mul_zh
    tower (bf16) and the sdxl_concat adapter (fp32, training) swapped in, at
    the SDXL training path's micro-batch and size with dict ids
    (input_ids / input_ids_zh), from launch counts of 0: a finite loss,
    finite nonzero adapter gradients and the launches the walk gives."""
    from pea_diffusion_tpu_torch import configs
    from pea_diffusion_tpu_torch.cli.train import demo_full_batches
    from pea_diffusion_tpu_torch.pipelines.factory import with_text_tower
    from pea_diffusion_tpu_torch.train.kd import kd_loss

    spec, path = TRAINING["sdxl training"], MUL_ZH_KD_PATH
    b, size, latent = spec["batch"], spec["size"], spec["size"] // 8
    cfg = tower_configs(TOWERS["mul_zh serving"]["text"])
    kd = with_text_tower(models, "mul_zh", cfg, configs.ADAPTER_PRESETS["sdxl_concat"], seed=22)
    kd.adapter.train()
    kd.freeze()
    batch = next(demo_full_batches("cuda", b, size, seed=23))
    ids = tower_ids(cfg, 24, [14 + 3 * i for i in range(b)])
    uncond = tower_ids(cfg, 100, [2] * b)
    for key, rows in (("input_ids", ids["mul"]), ("input_ids_uncond", uncond["mul"]),
                      ("input_ids_zh", ids["zh"]), ("input_ids_uncond_zh", uncond["zh"])):
        batch[key] = torch.as_tensor(rows, device="cuda")
    calls = [("student", attention_routes(kd.unet, latent, TEXT_TOKENS, grad_free=False), 1),
             ("student, no gradient",
              attention_routes(kd.unet, latent, TEXT_TOKENS, grad_free=True), 1),
             ("teacher", attention_routes(kd.unet, latent, TEACHER_TOKENS), 1)]
    want = path_launches(calls)
    gen = torch.Generator(device="cuda").manual_seed(25)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    reset_launch_counts()
    loss, _ = kd_loss(kd, configs.TrainConfig(), batch, gen)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = launch_counts()
    check_launches(path, launches, want)
    stamp_launches(kernels, path, calls, launches)
    grads = [p.grad for p in kd.adapter.parameters()]
    finite = all(g is not None and bool(g.isfinite().all()) for g in grads)
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in grads)) if finite else 0.0
    log(f"[{path}] micro-batch {b}, {size}², mul_zh ids {tuple(batch['input_ids'].shape)} + "
        f"{tuple(batch['input_ids_zh'].shape)}: loss {loss.item():.6g}; adapter gradient "
        f"norm {norm:.6g} over {len(grads)} tensors, finite {finite}; {seconds:.4f}s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (math.isfinite(loss.item()) and finite and norm > 0):
        raise AssertionError(f"{path}: loss {loss.item()}, adapter gradients finite {finite}, "
                             f"norm {norm}")
    del kd, loss, grads


def write_shards(root):
    """4 webdataset shards of SHARD_BUCKETS' images, seed 0: 10 JPEGs a
    bucket (sine gratings under seeded noise, so that decode does real
    work), captions Chinese-native (caption_ori) and parallel (caption_zh +
    caption_en) in turns within each bucket, and per shard one image under
    the 640² area filter and one at watermark 0.9, their captions unique.
    Returns the shards' url and {filtered caption}."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    words = list("猫狗山湖花树云雪河桥城鸟马船灯月")
    root.mkdir(parents=True, exist_ok=True)
    sizes, n_good = list(SHARD_BUCKETS.values()), 10 * len(SHARD_BUCKETS)
    per_shard = n_good // 4
    filtered = set()

    def jpeg(w, h):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = rng.uniform(0.01, 0.05, 3)
        img = np.stack([127 + 100 * np.sin(f[c] * xx + (c + 1) * f[c] * yy) for c in range(3)], -1)
        img += rng.normal(0, 12, img.shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    for shard in range(4):
        samples = []
        for j in range(per_shard):
            g = shard * per_shard + j
            w, h = sizes[g % len(sizes)]
            zh = "".join(rng.choice(words, 6))
            meta = ({"caption_ori": zh, "caption_en": f"picture {g}"} if (g // 4) % 2 == 0
                    else {"caption_zh": zh, "caption_en": f"picture {g}",
                          "watermark": 0.1, "aesthetic_score": 7.0})
            samples.append((f"{shard:02d}{g:04d}", (w, h), meta))
        for k, (size, meta) in enumerate((
                ((560, 560), {"caption_ori": f"过滤小图{shard}", "watermark": 0.1}),
                ((800, 800), {"caption_zh": f"过滤水印{shard}", "caption_en": f"filtered {shard}",
                              "watermark": 0.9, "aesthetic_score": 7.0}))):
            filtered.add(meta.get("caption_ori") or meta["caption_zh"])
            samples.append((f"{shard:02d}x{k}", size, meta))
        with tarfile.open(root / f"{shard:05d}.tar", "w") as tf:
            for key, (w, h), meta in samples:
                for name, data in ((f"{key}.jpg", jpeg(w, h)),
                                   (f"{key}.json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    assert len(filtered) == SHARDS_FILTERED
    return str(root / "{00000..00003}.tar"), filtered


def shard_tokenizers():
    """Seeded character tokenizers: the student's 52 ids in the Chinese-CLIP
    vocab, each CLIP teacher's 77 in its own (the smoke reads no tokenizer
    files)."""
    from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
    from pea_diffusion_tpu_torch.configs import CHINESE_CLIP_LARGE, CLIP_BIG_G, CLIP_VIT_L

    return (make_tokenizer(CHINESE_CLIP_LARGE.vocab_size, TEXT_TOKENS),
            [make_tokenizer(c.vocab_size - 1, TEACHER_TOKENS) for c in (CLIP_VIT_L, CLIP_BIG_G)])


def loader_rate(url, workers):
    """Host samples/s of make_train_iterator over LOADER_EPOCHS passes of
    the shards at `workers` decode threads (read, decode, filter, crop,
    batch and tokenize; no device)."""
    from pea_diffusion_tpu_torch.configs import DataConfig
    from pea_diffusion_tpu_torch.data.pipeline import make_train_iterator

    tokenize, teacher = shard_tokenizers()
    cfg = DataConfig(urls=(url,), batch_size=SHARDS_BATCH, num_workers=workers)
    t = time.time()
    n = sum(len(b["prompts"]) for b in make_train_iterator(cfg, tokenize, teacher,
                                                          epochs=LOADER_EPOCHS))
    return n, n / (time.time() - t)


def trace_busy_ms(path):
    """Device busy time of a Chrome trace: the union of its kernel and
    memcpy/memset intervals, in ms."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, sum(1 for e in events if e.get("cat") == "kernel")


def shard_calls(models, bucket, role="student"):
    """The attention calls of one KD step's UNet forwards at `bucket`'s
    latents: [(role, routes, 1)] for the student and the teacher."""
    from pea_diffusion_tpu_torch.data.buckets import BUCKETS

    w, h = BUCKETS[bucket]
    latent = (h // 8, w // 8)
    return [(role, attention_routes(models.unet, latent, TEXT_TOKENS, grad_free=False), 1),
            ("student, no gradient",
             attention_routes(models.unet, latent, TEXT_TOKENS, grad_free=True), 1),
            ("teacher", attention_routes(models.unet, latent, TEACHER_TOKENS), 1)]


def shards_phase(torch, models, kernels, repo, single_peak):
    """Training from webdataset shards on the SDXL KD stack `models`
    (micro-batch 10): the shards (`write_shards`), the loader's host
    samples/s at 1 and SHARDS_WORKERS decode threads, then one pass of
    make_train_iterator through the card's prefetcher, KDTrainer.warmup of
    each bucket (path SHARDS_WARMUP) and KDTrainer.fit of one step a bucket
    (SHARDS_PATH, the last step profiled): the native reader fed the
    stream, every batch single-bucket with its shape and time ids, the
    filtered samples absent, finite losses, a moved adapter, bit-identical
    frozen tensors, a trace file, B1/B3/B4/B5 launches per bucket as the
    walk gives them. Then the remat A/B ("full", "blocks", "dots") and the
    tap-dtype A/B on the 640² batch with the same draws. `single_peak` is
    the 640²-only training path's peak memory (GiB), for the log."""
    import shutil

    from pea_diffusion_tpu_torch.configs import DataConfig, TrainConfig
    from pea_diffusion_tpu_torch.data import wds_reader
    from pea_diffusion_tpu_torch.data.buckets import BUCKETS, scaled_size_to_cover
    from pea_diffusion_tpu_torch.data.pipeline import make_train_iterator, prefetch_to_device
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    t_phase = time.time()
    url, filtered = write_shards(repo / "build" / "chip_smoke_shards")
    log(f"[{SHARDS_PATH}] wrote 4 shards ({10 * len(SHARD_BUCKETS)} images in buckets "
        f"{sorted(SHARD_BUCKETS)} + {SHARDS_FILTERED} to filter) in {time.time() - t_phase:.2f}s")
    wds_reader.sample_stream.samples = {"native": 0, "python": 0}
    for workers in (1, SHARDS_WORKERS):
        n, rate = loader_rate(url, workers)
        log(f"[{SHARDS_PATH}] loader, {workers} decode thread(s): {n} samples in "
            f"{LOADER_EPOCHS} passes, {rate:.4f} samples/s on the host")
    reads = dict(wds_reader.sample_stream.samples)
    if reads["native"] == 0 or reads["python"] != 0:
        raise AssertionError(f"{SHARDS_PATH}: the native reader did not feed the stream: {reads}")

    out = repo / "build" / "chip_smoke_shards_run"
    shutil.rmtree(out, ignore_errors=True)
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(out), log_every_n_steps=1,
                      batch_size_per_device=SHARDS_BATCH)  # no checkpoint inside the timed steps
    trainer = KDTrainer(models, cfg, profile_window=(SHARDS_PROFILE_STEP, SHARDS_PROFILE_STEP + 1))
    frozen = checksums(torch, models.frozen_modules())
    adapter = {k: v.clone() for k, v in models.adapter.state_dict().items()}
    tokenize, teacher = shard_tokenizers()
    wds_reader.sample_stream.samples = {"native": 0, "python": 0}
    data_cfg = DataConfig(urls=(url,), batch_size=SHARDS_BATCH, num_workers=SHARDS_WORKERS)
    batches = prefetch_to_device(make_train_iterator(data_cfg, tokenize, teacher, epochs=1), "cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm_s, warm_launches = {}, {}
    for b in SHARD_BUCKETS:
        reset_launch_counts()
        t = time.time()
        trainer.warmup(SHARDS_BATCH, TEXT_TOKENS, TEACHER_TOKENS, buckets=[b])
        warm_s[b] = time.time() - t
        warm_launches[b] = launch_counts()
        check_launches(f"{SHARDS_WARMUP} bucket {b}", warm_launches[b],
                       path_launches(shard_calls(models, b)))
    stamp_launches(kernels, SHARDS_WARMUP,
                   [c for b in SHARD_BUCKETS for c in shard_calls(models, b)],
                   {k: sum(v[k] for v in warm_launches.values()) for k in COUNTERS})

    steps, kept = [], {}

    def observed(it):
        it = iter(it)
        while True:
            t0 = time.time()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.time()
            b = int(batch["bucket_id"])
            w, h = BUCKETS[b]
            px = batch["pixel_values"]
            if not (px.is_cuda and tuple(px.shape) == (SHARDS_BATCH, h, w, 3)):
                raise AssertionError(f"{SHARDS_PATH}: bucket {b} batch {tuple(px.shape)} "
                                     f"on {px.device}")
            ow, oh = SHARD_BUCKETS[b]
            nw, nh = scaled_size_to_cover((ow, oh), (w, h))  # the crop's frame
            tid = batch["time_ids"].cpu()
            want = torch.tensor([oh, ow, h, w], dtype=torch.float32)
            if not (torch.equal(tid[:, [0, 1, 4, 5]], want.expand(SHARDS_BATCH, 4))
                    and bool((tid[:, 2] <= nh - h).all()) and bool((tid[:, 3] <= nw - w).all())):
                raise AssertionError(f"{SHARDS_PATH}: bucket {b} time ids {tid.tolist()}")
            zh = sorted(set(batch["zh_or_not"].tolist()))
            if zh != [0.0, 1.0] or filtered & set(batch["prompts"]):
                raise AssertionError(f"{SHARDS_PATH}: bucket {b} zh_or_not {zh}, prompts "
                                     f"{batch['prompts']}")
            if (w, h) == (640, 640):
                kept["batch"] = batch
            reset_launch_counts()
            yield batch
            torch.cuda.synchronize()
            steps.append(dict(bucket=b, wait_s=t1 - t0, step_s=time.time() - t1,
                              launches=launch_counts()))

    trainer.fit(observed(batches), max_steps=len(SHARD_BUCKETS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reads = dict(wds_reader.sample_stream.samples)

    if sorted(s["bucket"] for s in steps) != sorted(SHARD_BUCKETS):
        raise AssertionError(f"{SHARDS_PATH}: buckets {[s['bucket'] for s in steps]}, want one "
                             f"batch each of {sorted(SHARD_BUCKETS)}")
    if reads["native"] != 10 * len(SHARD_BUCKETS) + SHARDS_FILTERED or reads["python"]:
        raise AssertionError(f"{SHARDS_PATH}: raw samples by reader {reads}")
    for s in steps:
        check_launches(f"{SHARDS_PATH} bucket {s['bucket']}", s["launches"],
                       path_launches(shard_calls(models, s["bucket"])))
    stamp_launches(kernels, SHARDS_PATH,
                   [c for s in steps for c in shard_calls(models, s["bucket"])],
                   {k: sum(s["launches"][k] for s in steps) for k in COUNTERS})
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    if len(recs) != len(SHARD_BUCKETS) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{SHARDS_PATH}: losses {losses}")
    if all(torch.equal(v, models.adapter.state_dict()[k]) for k, v in adapter.items()):
        raise AssertionError(f"{SHARDS_PATH}: the adapter did not change")
    if checksums(torch, models.frozen_modules()) != frozen:
        raise AssertionError(f"{SHARDS_PATH}: a frozen tensor changed")
    trace = Path(trainer.profiler.path)
    if not trace.is_file():
        raise AssertionError(f"{SHARDS_PATH}: no trace at {trace}")
    busy_ms, n_kernels = trace_busy_ms(trace)
    prof = steps[SHARDS_PROFILE_STEP]
    timed = [s for i, s in enumerate(steps) if i != SHARDS_PROFILE_STEP]
    rate = SHARDS_BATCH * len(timed) / sum(s["step_s"] for s in timed)
    def wxh(b):
        return "x".join(map(str, BUCKETS[b]))

    log(f"[{SHARDS_PATH}] warmup s: " + ", ".join(
        f"bucket {b} ({wxh(b)}) {warm_s[b]:.4f}" for b in warm_s))
    log(f"[{SHARDS_PATH}] steps in order (bucket, step s, data wait s): "
        + "; ".join(f"{s['bucket']} ({wxh(s['bucket'])}) {s['step_s']:.4f} {s['wait_s']:.4f}"
                    for s in steps)
        + f"; losses {losses}; {rate:.4f} samples/s over the unprofiled steps; peak memory "
        f"{peak:.2f} GiB over warmup and fit (640² alone, sdxl training: {single_peak:.2f} "
        f"GiB); raw samples by reader {reads}; adapter moved, {len(frozen)} frozen tensors "
        "bit-identical")
    log(f"[{SHARDS_PATH} profile] step {SHARDS_PROFILE_STEP + 1} (bucket {prof['bucket']}): "
        f"device busy {busy_ms:.1f} ms in {n_kernels} kernels of {prof['step_s'] * 1e3:.1f} ms "
        f"wall under the profiler; idle {max(0.0, 1 - busy_ms / (prof['step_s'] * 1e3)):.3f}; "
        f"trace {trace.name}")
    remat_ab(torch, models, kept.pop("batch"))
    log(f"[{SHARDS_PATH}] phase done in {time.time() - t_phase:.1f}s")


def remat_ab(torch, models, batch):
    """kd_loss + adapter gradient of each remat policy, "full", "blocks"
    and "dots", then of bfloat16 feature taps, on the 640² `batch` (bucket
    4) with the same draws, twice each; of the second run the peak memory,
    step time, launches (B3 with lse three times a student call under
    "blocks", twice otherwise), and the
    gradient's max difference from "full" over max |full| (gated at
    REMAT_GRAD_RTOL for the policies; printed for the taps)."""
    import dataclasses

    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.train.kd import kd_loss

    params = list(models.adapter.parameters())
    if tuple(batch["pixel_values"].shape[1:3]) != (640, 640):
        raise AssertionError(f"remat A/B: batch {tuple(batch['pixel_values'].shape)}")
    draws, runs = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    for name, kw in (("full", {}), ("blocks", dict(remat_policy="blocks")),
                     ("dots", dict(remat_policy="dots")),
                     ("bfloat16 taps", dict(feature_tap_dtype="bfloat16"))):
        m = dataclasses.replace(models, **kw)
        for _ in range(2):  # the second run timed, on the allocator the first left
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t = time.time()
            loss, _ = kd_loss(m, TrainConfig(), batch, gen, draws)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            seconds = time.time() - t
        flat = torch.cat([g.flatten() for g in grads])
        calls = shard_calls(models, 4, "student, blocks" if name == "blocks" else "student")
        check_launches(f"{SHARDS_PATH} remat {name}", launch_counts(), path_launches(calls))
        runs[name] = dict(loss=loss.item(), grad=flat, s=seconds,
                          peak=torch.cuda.max_memory_allocated() / 2**30)
        del loss, grads
    full = runs["full"]["grad"]
    scale = full.abs().max().item()
    for name, r in runs.items():
        rel = (r["grad"] - full).abs().max().item() / scale
        log(f"[{SHARDS_PATH} remat] {name}: loss {r['loss']:.6g}, step (kd_loss + adapter "
            f"gradient) {r['s']:.4f} s, peak memory {r['peak']:.2f} GiB, adapter gradient max "
            f"diff from full {rel:.3g} of max |full| ({scale:.4g})")
        if name in ("blocks", "dots") and not rel < REMAT_GRAD_RTOL:
            raise AssertionError(f"remat {name}: adapter gradient {rel} of max |full|")
    del runs


def control_image(size):
    """Canny edges of a seeded image of 64-pixel blocks, size x size."""
    import numpy as np

    from pea_diffusion_tpu_torch.pipelines.controlnet import canny_edges

    blocks = np.random.default_rng(0).integers(0, 256, (size // 64, size // 64, 3))
    return canny_edges(np.kron(blocks, np.ones((64, 64, 1))).astype(np.uint8))


def controlnet_phase(torch, model, kernels, repo):
    """The full-width SDXL ControlNet path with the fused GroupNorm opt-in
    on: the SDXL PEA stack and a full SDXL ControlNet (its zero convs filled
    from the seed, so that the residuals reach the UNet), REQUESTS requests
    from launch counts of 0 (B1, B3, B6, B6-b as the UNet's, ControlNet's
    and VAE's dispatch gives them), a request at conditioning scale 0 (which
    must differ), then a guess-mode request's stage times and profile."""
    from collections import Counter

    from pea_diffusion_tpu_torch.cli.generate import build_demo_full
    from pea_diffusion_tpu_torch.models.layers import GroupNorm
    from pea_diffusion_tpu_torch.ops import groupnorm as gn
    from pea_diffusion_tpu_torch.pipelines.controlnet import (generate_sdxl_controlnet,
                                                              prepare_control_image)
    from pea_diffusion_tpu_torch.pipelines.factory import build_controlnet
    from pea_diffusion_tpu_torch.pipelines.text2image import (encode_prompt_sdxl,
                                                              make_add_time_ids)

    size, steps = SERVING["sdxl serving"]["size"], SERVING["sdxl serving"]["steps"]
    latent, tag = size // 8, "controlnet"
    t1 = time.time()
    models, tokenize, _ = build_demo_full("cuda")
    cn = build_controlnet(models.unet.config, device="cuda", seed=1, zero_init=False)
    control = prepare_control_image(control_image(size), size, size, 1, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] full-width SDXL stack and ControlNet ({sum(p.numel() for p in cn.parameters()) / 1e9:.3f}B "
        f"parameters) on the card, control image {tuple(control.shape)} with "
        f"{control.mean().item():.4f} of it edges, in {time.time() - t1:.1f}s")
    def request(prompt, seed, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return generate_sdxl_controlnet(
            models, cn, tokenize([prompt]), tokenize([""]), control, generator=gen,
            sampler_name="ddim", height=size, width=size, num_steps=steps,
            guidance_scale=GUIDANCE, **kw)

    routes = (attention_routes(models.unet, latent, TEXT_TOKENS)
              + attention_routes(cn, latent, TEXT_TOKENS))
    calls = [("serving", routes, steps * REQUESTS)]
    gn_calls = controlnet_path_gn_calls(models.unet, cn, models.vae.decoder, latent,
                                        steps * REQUESTS, REQUESTS)
    want = path_launches(calls)
    for kern in GN_KERNELS:
        want[kern] = sum(n for key, n in gn_calls.items() if key[0] == kern)
    norms = [m for mod in (models.unet, cn, models.vae) for m in mod.modules()
             if isinstance(m, GroupNorm)]
    set_fused_gn(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        images, req_s = [], []
        for i, prompt in enumerate(PROMPTS[:REQUESTS]):
            torch.cuda.synchronize()
            t0 = time.time()
            images.append(request(prompt, i).float())
            torch.cuda.synchronize()
            req_s.append(time.time() - t0)
            check_image(images[-1], size, f"{tag} request {i}", req_s[-1])
        served = launch_counts()
        by_dim = (routes_by_head_dim(models.unet, latent, TEXT_TOKENS)
                  + routes_by_head_dim(cn, latent, TEXT_TOKENS))
        log(f"[{tag}] attention calls per UNet + ControlNet forward by (route, head dim): "
            f"{dict(by_dim)}; "
            f"layout copies before a GroupNorm kernel: {gn.group_norm_fwd.copies}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_launches(tag, served, want)
        stamp_launches(kernels, CONTROLNET_PATH, calls, served, gn_calls)
        log_gn_path_sums(kernels, CONTROLNET_PATH)

        layouts = Counter()
        hooks = [m.register_forward_pre_hook(lambda mod, args: layouts.update(
            [gn.layout(args[0])])) for m in norms]
        try:
            off = request(PROMPTS[0], 0, controlnet_conditioning_scale=0.0).float()
        finally:
            for h in hooks:
                h.remove()
        diff = (images[0] - off).abs().max().item()
        per_request = sum(want[k] for k in GN_KERNELS) // REQUESTS
        log(f"[{tag}] scale 0 vs 1, same seed: max |image difference| {diff:.4g}; "
            f"GroupNorm inputs by layout in one request: {dict(layouts)} (want "
            f"{per_request} calls)")
        if not diff > 1e-3 or sum(layouts.values()) != per_request:
            raise AssertionError(f"{tag}: scale 0 image difference {diff}, "
                                 f"GroupNorm calls {dict(layouts)}")

        torch.cuda.synchronize()
        t0 = time.time()
        check_image(request(PROMPTS[1], 5, guess_mode=True).float(), size, f"{tag} guess mode",
                    time.time() - t0)
        guess_s = time.time() - t0
        dev = models.device
        ids = torch.as_tensor(tokenize([PROMPTS[1]]), device=dev)
        uncond = torch.as_tensor(tokenize([""]), device=dev)
        x = torch.randn((1, latent, latent, 4), device=dev)
        t = torch.full((2,), 500, device=dev)
        with torch.inference_mode():
            encode = lambda: encode_prompt_sdxl(models, ids, uncond)  # noqa: E731
            context, pooled = encode()
            time_ids = make_add_time_ids((size, size), (0, 0), (size, size), 2, dev)
            added = {"text_embeds": pooled, "time_ids": time_ids}
            added_c = {"text_embeds": pooled[1:], "time_ids": time_ids[1:]}

            def controlnet_step():
                down, mid = cn(x, t[1:], context[1:], control, 1.0, added_c)
                return ([torch.cat([torch.zeros_like(d), d]) for d in down],
                        torch.cat([torch.zeros_like(mid), mid]))

            def step():
                down, mid = controlnet_step()
                return models.unet(torch.cat([x, x]), t, context, added,
                                   down_block_additional_residuals=down,
                                   mid_block_additional_residual=mid)

            enc, cn_ms, step_ms = (event_ms(torch, encode), event_ms(torch, controlnet_step),
                                   event_ms(torch, step))
            dec = event_ms(torch, lambda: models.vae.decode(x))
        log(f"[{tag} stages, guess mode] prompt encoding {enc:.3f} ms; ControlNet (batch 1) "
            f"{cn_ms:.3f} ms + UNet (CFG pair) = {step_ms:.3f} ms a step; VAE decode "
            f"{dec:.3f} ms; request {guess_s:.4f} s")
        profile_run(torch, lambda: request(PROMPTS[1], 5, guess_mode=True), guess_s,
                    repo / "build" / "chip_smoke_controlnet_profile.txt", f"{tag} profile",
                    {key: n // REQUESTS for key, n in gn_calls.items()})
    finally:
        set_fused_gn(False)


def training_phase(torch, model, kernels, repo):
    """The full-width KD stack of `model`: one step's adapter gradient
    against plain attention, then each of its training paths."""
    from pea_diffusion_tpu_torch.cli.train import build_demo_full

    paths = [path for path, spec in TRAINING.items() if spec["model"] == model]
    first = TRAINING[paths[0]]
    t1 = time.time()
    models, _ = build_demo_full("cuda", first["batch"], first["size"], model=model)
    torch.cuda.synchronize()
    n_frozen = sum(p.numel() for m in models.frozen_modules().values() for p in m.parameters())
    log(f"[init] full-width {model} KD stack on the card in {time.time() - t1:.1f}s, "
        f"{sum(p.numel() for p in models.adapter.parameters()) / 1e6:.3f}M trainable and "
        f"{n_frozen / 1e9:.3f}B frozen parameters")
    reference_kd_step(torch, models, model)
    if model == "sdxl":
        reference_kd_step(torch, models, model, compare="groupnorm")
    peaks = {}
    for path in paths:
        spec = TRAINING[path]
        if "check_head_dim" in spec:
            reference_kd_step(torch, models, model, size=spec["size"],
                              head_dim=spec["check_head_dim"])
        peaks[path] = training_path(torch, models, repo, kernels, path)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{path}] done at {time.time() - t1:.1f}s after the stack's build")
    if model == "sdxl":
        mul_zh_kd_step(torch, models, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{MUL_ZH_KD_PATH}] done at {time.time() - t1:.1f}s after the stack's build")
        shards_phase(torch, models, kernels, repo, peaks["sdxl training"])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{SHARDS_PATH}] done at {time.time() - t1:.1f}s after the stack's build")
        fsdp_phase(torch, models, kernels, repo, peaks["sdxl training"])  # wraps the UNet: last
        log(f"[{FSDP_PATH}] done at {time.time() - t1:.1f}s after the stack's build")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kd_training_calls(unet, latent, steps):
    """The attention calls of `steps` KD steps (see training_path)."""
    return [("student", attention_routes(unet, latent, TEXT_TOKENS, grad_free=False), steps),
            ("student, no gradient", attention_routes(unet, latent, TEXT_TOKENS, grad_free=True),
             steps),
            ("teacher", attention_routes(unet, latent, TEACHER_TOKENS), steps)]


def fsdp_phase(torch, models, kernels, repo, single_peak):
    """(a) of the multi-GPU phases (see FSDP_PATH): a world of size 1 over
    NCCL from torchrun's environment variables. The unwrapped adapter
    gradient twice on the same draws (the floor: the stack against itself);
    the KD trainer over make_mesh((1, 1)), where shard_params wraps nothing
    (fsdp 1), takes FSDP_STEPS fit steps from launch counts of 0 (the main
    path: the adapter-gradient all_reduce over NCCL); then the UNet goes
    under FSDP2 itself (fully_shard_unet at fsdp 1), and its gradient on the
    same draws and adapter is held against the unwrapped one, and it takes
    FSDP_STEPS fit steps. Step times and peak memory beside the unwrapped
    path's. Wraps `models.unet` for good."""
    import os
    import shutil

    import torch.distributed as dist

    from pea_diffusion_tpu_torch.cli.train import demo_full_batches
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.parallel import initialize, make_mesh
    from pea_diffusion_tpu_torch.parallel.mesh import fully_shard_unet
    from pea_diffusion_tpu_torch.train.kd import kd_loss
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    spec = TRAINING["sdxl training"]
    batch_size, size, tag = spec["batch"], spec["size"], FSDP_PATH
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    os.environ.pop("PEA_DIST_BACKEND", None)
    initialize(device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"{tag}: backend {dist.get_backend()}, want nccl")
        mesh = make_mesh((1, 1))
        batch = next(demo_full_batches("cuda", batch_size, size, seed=7))
        gen = torch.Generator(device="cuda").manual_seed(13)
        draws = {}

        def config(name):
            out = repo / "build" / f"chip_smoke_fsdp_{name}"
            shutil.rmtree(out, ignore_errors=True)
            return TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(out),
                               every_n_steps=FSDP_STEPS, log_every_n_steps=1,
                               batch_size_per_device=batch_size)

        def adapter_grad():
            models.adapter.zero_grad()
            loss, _ = kd_loss(models, config("grad"), batch, gen, draws)
            loss.backward()
            g = torch.cat([p.grad.flatten() for p in models.adapter.parameters()])
            models.adapter.zero_grad()
            return g

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        def fit(name):
            """FSDP_STEPS steps of a trainer over `mesh`: (launches, step time, peak
            GiB, losses, consumed samples)."""
            cfg = config(name)
            trainer = KDTrainer(models, cfg, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            trainer.fit(demo_full_batches("cuda", batch_size, size, 1), max_steps=FSDP_STEPS)
            torch.cuda.synchronize()
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = [json.loads(x) for x in
                    (Path(cfg.output_dir) / "metrics.jsonl").read_text().splitlines()]
            losses = [r["loss"] for r in recs]
            if len(recs) != FSDP_STEPS or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{tag} {name}: losses {losses}")
            step_s = (recs[-1]["time"] - recs[0]["time"]) / (FSDP_STEPS - 1)
            return launches, step_s, peak, losses, recs[-1]["consumed_samples"]

        def n_fsdp():
            return sum(type(m).__name__.startswith("FSDP") for m in models.unet.modules())

        plain = adapter_grad()
        floor = rel(adapter_grad(), plain)
        start = {k: v.clone() for k, v in models.adapter.state_dict().items()}
        calls = kd_training_calls(models.unet, size // 8, FSDP_STEPS)
        launches, step_s, peak, losses, consumed = fit("mesh")
        if n_fsdp():
            raise AssertionError(f"{tag}: {n_fsdp()} FSDP modules at fsdp 1")
        check_launches(tag, launches, path_launches(calls))
        stamp_launches(kernels, tag, calls, launches)
        log(f"[{tag}] world size {dist.get_world_size()} over {dist.get_backend()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (shard_params wraps nothing at "
            f"fsdp 1): {FSDP_STEPS} steps at micro-batch {batch_size}, {size}² with the "
            f"adapter-gradient all_reduce: losses {losses}, consumed {consumed}; step 2 time "
            f"{step_s:.4f} s, peak memory {peak:.2f} GiB; without a mesh (sdxl training): step "
            f"time {STEP_S['sdxl training']:.4f} s, peak memory {single_peak:.2f} GiB")

        models.adapter.load_state_dict(start)
        fully_shard_unet(models.unet, mesh)
        sharded = sum(type(p).__name__ == "DTensor" for p in models.unet.parameters())
        whole = sum(type(p).__name__ != "DTensor" for p in models.unet.parameters())
        if not (n_fsdp() and sharded):
            raise AssertionError(f"{tag}: {n_fsdp()} FSDP modules, {sharded} sharded parameters")
        wrapped = rel(adapter_grad(), plain)
        log(f"[{tag}] FSDP2 itself over NCCL (fully_shard_unet at fsdp 1, not on the main "
            f"path): {n_fsdp()} modules wrapped, {sharded} UNet parameters one-rank shards, "
            f"{whole} left whole by the rule; KD adapter gradient at micro-batch {batch_size}, "
            f"{size}² on the same draws and adapter, relative L2 against the unwrapped one: "
            f"FSDP2 {wrapped:.4g}, the unwrapped stack against itself {floor:.4g} (bound "
            f"{KD_GRAD_RTOL})")
        if not (wrapped < KD_GRAD_RTOL and plain.norm().item() > 0):
            raise AssertionError(f"{tag}: adapter gradient relative L2 {wrapped}")
        _, step_s, peak, losses, _ = fit("fsdp2")
        log(f"[{tag}] FSDP2 at fsdp 1: {FSDP_STEPS} steps, losses {losses}; step 2 time "
            f"{step_s:.4f} s, peak memory {peak:.2f} GiB (the cost of the hooks alone: nothing "
            f"is sharded)")
    finally:
        dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


def read_png(path, size):
    import numpy as np
    from PIL import Image

    img = Image.open(path)
    if img.size != (size, size) or img.mode != "RGB":
        raise AssertionError(f"{path}: {img.size} {img.mode}")
    return np.asarray(img).astype(np.int16)


def multigpu_phase(torch, kernels, repo):
    """(b) of the multi-GPU phases (see FSDP_PATH): two ranks of this script
    share the card over gloo; each runs `multigpu_worker`. Fails if a rank
    fails, outlives MULTIGPU_TIMEOUT or disagrees; stamps the ranks' kernel
    launches on the rows."""
    import os
    import shutil

    out = repo / "build" / "chip_smoke_multigpu"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(TP), PEA_DIST_BACKEND="gloo", PEA_FUSED_GROUPNORM="0")
    t0 = time.time()
    logs = [open(out / f"rank{r}.log", "w") for r in range(TP)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multigpu-rank",
                               str(out)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(repo))
             for r in range(TP)]
    try:
        deadline = t0 + MULTIGPU_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"multi-GPU ranks still running after {MULTIGPU_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        for r in range(TP):
            for line in (out / f"rank{r}.log").read_text().splitlines():
                log(f"[rank {r}] {line}")
    rcs = [p.returncode for p in procs]
    if rcs != [0] * TP:
        raise AssertionError(f"multi-GPU ranks exited {rcs}")
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(TP)]
    log(f"[multigpu] {TP} ranks on one card over gloo in {time.time() - t0:.1f}s")
    r0 = res[0]

    # TP = 2 UNet forward
    chk = r0["tp_check"]
    want_coll = chk["collectives_formula"]
    for r, x in enumerate(res):
        if x["tp_check"]["collectives"] != want_coll:
            raise AssertionError(f"rank {r}: {x['tp_check']['collectives']} all_reduces per "
                                 f"UNet forward, the layout's formula gives {want_coll}")
    log(f"[{TP_PATH} unet] SDXL UNet forward of the CFG pair at 1024², relative max error "
        f"against the unsharded fp32 forward: TP = {TP} {chk['rel_tp']:.4g}, unsharded bf16 "
        f"{chk['rel_bf16']:.4g} (bound max({MODULE_RTOL}, unsharded bf16)); TP vs unsharded "
        f"bf16 {chk['rel_tp_vs_bf16']:.4g}; {want_coll} all_reduces a forward (the layout's "
        f"formula); TP forward {chk['tp_ms']:.1f} ms (two ranks sharing one card over gloo, "
        f"not a scaling measurement), unsharded bf16 forward {chk['plain_ms']:.1f} ms alone; "
        f"a rank's attention calls {chk['routes']}; launches {chk['launches']}")
    if not chk["rel_tp"] < max(MODULE_RTOL, chk["rel_bf16"]):
        raise AssertionError(f"TP UNet forward error {chk['rel_tp']} against fp32, unsharded "
                             f"bf16 {chk['rel_bf16']}")

    # generate --tp 2 against --tp 1, opt-in off and on
    forwards = TP_STEPS * REQUESTS
    routes = chk["routes"]
    calls = [("serving", routes, forwards)]
    for path, tag in ((TP_PATH, "off"), (TP_GN_PATH, "on")):
        gen = [x["generate"][tag] for x in res]
        if gen[0]["launches"] != gen[1]["launches"]:
            raise AssertionError(f"{path}: rank launches differ {gen}")
        gn_calls = {}
        if tag == "on":
            for key, n in chk["unet_gn"].items():
                gn_calls[key] = gn_calls.get(key, 0) + n * forwards
            for key, n in chk["vae_gn"].items():
                gn_calls[key] = gn_calls.get(key, 0) + n * REQUESTS
        want = path_launches(calls)
        want["B6"] = sum(n for k, n in gn_calls.items() if k[0] == "B6")
        want["B6-b"] = sum(n for k, n in gn_calls.items() if k[0] == "B6-b")
        check_launches(path, gen[0]["launches"], want)
        stamp_launches(kernels, path, calls, gen[0]["launches"],
                       {k: n for k, n in gn_calls.items()})
        if gen[0]["collectives"] != want_coll * forwards:
            raise AssertionError(f"{path}: {gen[0]['collectives']} all_reduces, want "
                                 f"{want_coll} x {forwards}")
        diffs = []
        for suffix in ("", "-1"):
            a = read_png(out / f"tp1_{tag}{suffix}.png", 1024)
            b = read_png(out / f"tp2_{tag}{suffix}.png", 1024)
            d = abs(a - b)
            diffs.append(f"max {int(d.max())} mean {float(d.mean()):.4f}, "
                         f"{float((d > 1).mean()):.4f} of values more than 1 apart")
        log(f"[{path}] cli/generate.py --demo-full --tp {TP} (DDIM {TP_STEPS}, CFG "
            f"{GUIDANCE}, 2 requests through --repl): uint8 |tp2 - tp1| per request: "
            f"{'; '.join(diffs)}; {gen[0]['collectives']} all_reduces; wall {gen[0]['seconds']:.1f} s "
            f"with the stack's build (two ranks sharing one card over gloo: not a scaling "
            f"measurement), --tp 1 {r0['generate']['tp1_' + tag]:.1f} s")

    # data = 2 KD step against one process on the 4 rows
    d = r0["data2"]
    if not (res[1]["data2"]["mu_checksum"] == d["mu_checksum"]):
        raise AssertionError(f"{DATA2_PATH}: the ranks' adapter moments differ after the reduce")
    if res[1]["data2"]["launches"] != d["launches"]:
        raise AssertionError(f"{DATA2_PATH}: rank launches differ")
    calls = [(role, routes_, n) for role, routes_, n in d["calls"]]
    check_launches(DATA2_PATH, d["launches"], path_launches(calls))
    stamp_launches(kernels, DATA2_PATH, calls, d["launches"])
    log(f"[{DATA2_PATH}] data = {TP} over gloo, {DATA2_ROWS} rows a rank at 640²: adapter "
        f"first moment (0.1 x the reduced gradient) against one process's step on the "
        f"{TP * DATA2_ROWS} rows with the same draws: max |diff| {d['mu_err']:.4g} of max "
        f"{d['mu_max']:.4g} (bound {DATA2_RTOL} of max), relative L2 {d['mu_rel_l2']:.4g}; "
        f"grad norm {d['grad_norm']:.6g} vs {d['ref_grad_norm']:.6g}; losses {d['loss']:.6g} vs "
        f"{d['ref_loss']:.6g}; step {d['seconds']:.3f} s a rank (two ranks sharing one card)")
    log(f"[{DATA2_PATH}] of max, against the one-process step on the 4 rows: the floor (that "
        f"process as {TP} micro-batches of {DATA2_ROWS} rows, the same draws) {d['floor']:.4g}, "
        f"data = {TP} {d['mu_err'] / d['mu_max']:.4g}, the planted fault (rank 0's rows, no "
        f"reduce) {d['fault']:.4g}; data = {TP} against the {TP}-micro-batch step "
        f"{d['vs_accum']:.4g} (bound {DATA2_ACCUM_RTOL})")
    if not d["mu_err"] <= DATA2_RTOL * d["mu_max"]:
        raise AssertionError(f"{DATA2_PATH}: {d['mu_err']} of {d['mu_max']}")
    if not d["vs_accum"] <= DATA2_ACCUM_RTOL:
        raise AssertionError(f"{DATA2_PATH}: {d['vs_accum']} of max from the {TP}-micro-batch "
                             f"step (bound {DATA2_ACCUM_RTOL})")
    if not d["fault"] > DATA2_RTOL:
        raise AssertionError(f"{DATA2_PATH}: the bound {DATA2_RTOL} passes the planted fault "
                             f"({d['fault']} of max)")


def multigpu_worker(out: Path) -> int:
    """One rank of `multigpu_phase` (torchrun's environment set by it, gloo):
    the TP = 2 UNet check, the generate CLI runs, the data = 2 KD step; its
    results saved to out/rank<N>.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pea_diffusion_tpu_torch.parallel import initialize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(device="cuda")
    rank = dist.get_rank()
    res = {"tp_check": tp_unet_check(torch, rank)}
    gc.collect()
    torch.cuda.empty_cache()
    res["generate"] = tp_generate_runs(torch, rank, out)
    gc.collect()
    torch.cuda.empty_cache()
    res["data2"] = data2_kd_step(torch, rank)
    torch.save(res, out / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_unet_check(torch, rank):
    """The SDXL serving UNet (seed 0) at TP = 2 on the CFG pair at 1024²:
    rank 0 first runs it unsharded in bf16 and, upcast, in fp32 (plain
    attention); both ranks then shard it and run it, counting launches and
    all_reduces, and its time on the host clock. Returns the errors, counts, times
    and a rank's attention and GroupNorm calls."""
    import copy

    import torch.distributed as dist

    from pea_diffusion_tpu_torch.cli.generate import build_demo_full
    from pea_diffusion_tpu_torch.configs import SDXL_UNET
    from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention
    from pea_diffusion_tpu_torch.parallel import tp
    from pea_diffusion_tpu_torch.pipelines.text2image import make_add_time_ids

    models, _, size = build_demo_full("cuda")
    unet, latent = models.unet, size // 8
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((2, latent, latent, 4), generator=gen, device="cuda")
    t = torch.full((2,), 500, device="cuda")
    ctx = torch.randn((2, TEXT_TOKENS, 2048), generator=gen, device="cuda")
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda"),
             "time_ids": make_add_time_ids((size, size), (0, 0), (size, size), 2, "cuda")}
    out = {}
    with torch.inference_mode():
        if rank == 0:
            ref_bf16 = unet(x, t, ctx, added).float()
            out["plain_ms"] = event_ms(torch, lambda: unet(x, t, ctx, added))
            unet32 = copy.deepcopy(unet).float()
            for m in unet32.modules():
                if isinstance(m, MultiHeadAttention):
                    m.backend = "xla"
            ref32 = unet32(x, t, ctx, added)
            del unet32
        dist.barrier()
        tp.shard_bundle_for_tp(models, tp.make_tp_mesh((1, TP)))
        reset_launch_counts()
        tp.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.time()
        y = unet(x, t, ctx, added).float()
        torch.cuda.synchronize()
        out["tp_ms"] = (time.time() - t0) * 1e3
        out["launches"] = launch_counts()
        out["collectives"] = tp.COLLECTIVES["all_reduce"]
        out["collectives_formula"] = tp.collectives_per_forward(SDXL_UNET, TP)
        if rank == 0:
            out["rel_tp"] = errors(y, ref32)[1]
            out["rel_bf16"] = errors(ref_bf16, ref32)[1]
            out["rel_tp_vs_bf16"] = errors(y, ref_bf16)[1]
            del ref32, ref_bf16
    out["routes"] = attention_routes(unet, latent, TEXT_TOKENS)
    out["unet_gn"] = groupnorm_calls(unet, latent, 2)
    out["vae_gn"] = groupnorm_calls(models.vae.decoder, latent, 1)
    del models, unet, y
    return out


def tp_generate_runs(torch, rank, out):
    """cli/generate.py --demo-full, two requests (--prompt and one --repl
    line, fed to rank 0's input), with the GroupNorm opt-in off and on: on
    rank 0 alone at --tp 1, then on both ranks at --tp 2 from launch and
    collective counts of 0."""
    import builtins

    import torch.distributed as dist

    from pea_diffusion_tpu_torch.cli import generate
    from pea_diffusion_tpu_torch.parallel import tp

    argv = ["--demo-full", "--sampler", "ddim", "--steps", str(TP_STEPS), "--guidance",
            str(GUIDANCE), "--seed", str(TP_SEED), "--prompt", PROMPTS[0], "--repl"]
    res = {}
    real_input = builtins.input
    try:
        for tag, on in (("off", False), ("on", True)):
            set_fused_gn(on)
            if rank == 0:
                feed = [PROMPTS[1], ""]
                builtins.input = lambda prompt="": feed.pop(0)
                t0 = time.time()
                generate.main(argv + ["-o", str(out / f"tp1_{tag}.png")])
                res["tp1_" + tag] = time.time() - t0
                feed[:] = [PROMPTS[1], ""]
            dist.barrier()
            reset_launch_counts()
            tp.reset_collectives()
            t0 = time.time()
            generate.main(argv + ["--tp", str(TP), "-o", str(out / f"tp2_{tag}.png")])
            torch.cuda.synchronize()
            res[tag] = {"launches": launch_counts(), "seconds": time.time() - t0,
                        "collectives": tp.COLLECTIVES["all_reduce"]}
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        builtins.input = real_input
        set_fused_gn(False)
    return res


def data2_kd_step(torch, rank):
    """The SDXL KD stack (seed 0) at data = 2: rank 0 first takes one
    process's step on the global batch of TP x DATA2_ROWS rows (make_train_
    step, no mesh), and the same step on the same draws as TP micro-batches
    of DATA2_ROWS rows (the floor); then both ranks take KDTrainer's step
    over make_mesh((2, 1)) on their rows, each drawing the global randoms
    from the shared generator, the adapter gradient reduced over gloo; last,
    rank 0 takes its rows' step with no reduce (the planted fault). Each
    from the same adapter and a fresh optimizer state."""
    import dataclasses
    import hashlib

    import torch.distributed as dist

    from pea_diffusion_tpu_torch.cli.train import build_demo_full, demo_full_batches
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.parallel import make_mesh, shard_batch
    from pea_diffusion_tpu_torch.train.kd import make_train_step
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    size = TRAINING["sdxl training"]["size"]
    rows = TP * DATA2_ROWS
    models, _ = build_demo_full("cuda", rows, size)
    batch = next(demo_full_batches("cuda", rows, size, seed=5))
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir="",
                      batch_size_per_device=DATA2_ROWS)
    start = {k: v.clone() for k, v in models.adapter.state_dict().items()}

    def mu(state):
        return torch.cat([v.flatten() for v in state.optimizer["mu"].values()])

    def gen():
        return torch.Generator(device="cuda").manual_seed(DATA2_SEED)

    def of_max(got, want):
        return (got - want).abs().max().item() / want.abs().max().item()

    out = {}
    if rank == 0:
        init_fn, step_fn = make_train_step(models, cfg)
        draws = [{}]
        state, m = step_fn(init_fn(), batch, gen(), draws)
        ref, out["ref_grad_norm"], out["ref_loss"] = mu(state), float(m["grad_norm"]), float(
            m["loss"])
        models.adapter.load_state_dict(start)
        init_fn, step_fn = make_train_step(models, dataclasses.replace(cfg, grad_accum_steps=TP))
        split = [{k: v[i * DATA2_ROWS:(i + 1) * DATA2_ROWS] for k, v in draws[0].items()}
                 for i in range(TP)]
        accum = mu(step_fn(init_fn(), batch, None, split)[0])
        out["floor"] = of_max(accum, ref)
        models.adapter.load_state_dict(start)
    dist.barrier()
    mesh = make_mesh((TP, 1))
    trainer = KDTrainer(models, cfg, mesh=mesh)
    local = shard_batch(batch, mesh)
    latent = size // 8
    out["calls"] = kd_training_calls(models.unet, latent, 1)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    state, m = trainer.step_fn(trainer.state, local, gen())
    torch.cuda.synchronize()
    out["seconds"] = time.time() - t0
    out["launches"] = launch_counts()
    got = mu(state)
    out["mu_checksum"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    out["grad_norm"], out["loss"] = float(m["grad_norm"]), float(m["loss"])
    if local["pixel_values"].shape[0] != DATA2_ROWS:
        raise AssertionError(f"rank {rank}: {local['pixel_values'].shape[0]} rows")
    if rank == 0:
        out["mu_err"] = (got - ref).abs().max().item()
        out["mu_max"] = ref.abs().max().item()
        out["mu_rel_l2"] = ((got - ref).norm() / ref.norm()).item()
        out["vs_accum"] = of_max(got, accum)
        models.adapter.load_state_dict(start)
        init_fn, step_fn = make_train_step(models, cfg, data_shard=(0, TP))
        out["fault"] = of_max(mu(step_fn(init_fn(), local, gen())[0]), ref)
    return out


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
    from pea_diffusion_tpu_torch.cli.generate import build_demo
    from pea_diffusion_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_fused_gn(False)  # the existing paths run the plain GroupNorm
    t0 = time.time()
    card = card_line()
    log(f"[card] {card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 off for matmul and cudnn")

    for line in ptxas_lines(kernel_build.build()):
        log(f"[build] {line}")
    log(f"[build] {persistent_smem_line(torch)}")
    log(f"[build] done in {time.time() - t0:.1f}s")

    kernels = kernel_phases(torch, F)
    log(f"[kernel] phase done at {time.time() - t0:.1f}s")
    kernels += sweep_phase(torch, F)
    log(f"[sweep] phase done at {time.time() - t0:.1f}s")
    for model in ("sdxl", "sd15"):
        reference_tiny_stack(torch, build_demo, model)

    for phase, model in ((serving_phase, "sdxl"), (serving_phase, "sd15"),
                         (controlnet_phase, "sdxl"), (training_phase, "sdxl"),
                         (training_phase, "sd15")):
        phase(torch, model, kernels, repo)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{phase.__name__}] {model} done at {time.time() - t0:.1f}s")
    multigpu_phase(torch, kernels, repo)
    log(f"[multigpu_phase] done at {time.time() - t0:.1f}s")

    for e in kernels:
        e["launches"] = sum(e["launches_by_path"].values())
        for key in ("kernel", "lse", "stands_for"):
            del e[key]
    log(f"[done] {time.time() - t0:.1f}s")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--multigpu-rank":
        sys.exit(multigpu_worker(Path(sys.argv[2])))
    sys.exit(main())
