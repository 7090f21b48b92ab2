#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pea_diffusion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from pea_diffusion_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all at once, linked into one library;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes: SDXL's head dim 64, SD1.5's 40 and 80 (bf16 inputs; the
   plain version in fp32 from the same bf16 inputs, in chunks of (batch,
   head) rows where its fp32 score matrices would not fit at once).
   Forward (B1, B3 with and without lse): max |kernel - plain| below 8e-3
   of max |plain|, twice the most that rounding the output to bf16 can move
   it. Backward (B4: dK, dV; B5: dQ): below 2e-2 of max |plain| per
   gradient (P and dS are rounded to bf16 before their products).
   GroupNorm (B6, B6-b): every GroupNorm shape of the SDXL ControlNet path
   (read from the UNet, ControlNet and VAE modules), plus an fp32 and two
   ragged cases, each input contiguous and channels-last, below 8e-3 of max
   |plain| (the output is rounded to bf16 once).
   CUDA-event times of the kernel, the plain version and a PyTorch
   yardstick (the port never calls it: F.scaled_dot_product_attention for
   the forward, the backward of one such call for B4 + B5 together,
   F.group_norm for the GroupNorm alone), each launch after an L2 flush,
   beside the least time the card needs for the same bytes and operations;
4. references: the tiny fp32 SDXL and SD1.5 stacks on the card against the
   same weights on the CPU (the paths the CPU tests hold against the JAX
   package), and, with each full-width stack, its UNet's attention modules
   at the serving shapes (SDXL 1024²: 640 and 1280 channels in heads of 64;
   SD1.5 512²: 320 and 640 channels in 8 heads of 40 and 80) through the
   kernels against plain attention, outputs and input gradients;
5. the serving paths, with the launch counts set to 0 just before each and
   read just after: the full-width SDXL PEA stack (Chinese-CLIP
   RoBERTa-large, the sdxl_chinese_clip adapter, the SDXL UNet and VAE in
   bf16, random weights from a seed) through StableDiffusionXLPEAPipeline,
   two requests of batch 1 at 1024x1024, DDIM 4 steps, CFG 7.5 (70 B1 and
   70 B3 per UNet forward); then the full-width SD1.5 stack (the same
   tower, sd15_chinese_clip, the SD1.5 UNet and VAE in bf16) through
   StableDiffusionPEAPipeline, two requests at 512², DDIM 20 steps
   (BASELINE config 1), CFG 7.5 (20 B3 per UNet forward, at D = 40 and 80;
   level 2 and the mid block, D = 160 at S <= 256, run plain). Each kernel
   must have launched as often as the attention dispatch of the UNet's
   modules says, and the images must be finite [1, size, size, 3] in
   [0, 1]; then the stage times and a torch.profiler trace of one request
   (tables in build/chip_smoke_profile.txt and
   build/chip_smoke_sd15_profile.txt). The SDXL stack then runs with the
   fused GroupNorm opt-in (PEA_FUSED_GROUPNORM=1) off and on: one UNet
   forward of the CFG pair against an fp32 forward, warm requests in turns
   for latency, and a profile each way (build/chip_smoke_gn_{off,on}_profile.txt);
6. the SDXL ControlNet path with the opt-in on: the SDXL stack and a
   full-width SDXL ControlNet (random weights, its zero convs filled from
   the seed), the control image the Canny edges of a seeded image, two
   requests of batch 1 at 1024², DDIM 4 steps, CFG 7.5, from launch counts
   of 0 (B1, B3, B6, B6-b as the modules' dispatch gives them: 104 + 104
   attention calls and 67 GroupNorms per UNet + ControlNet forward, 30 per
   VAE decode), a request at conditioning scale 0 that must differ, and a
   guess-mode request's stage times and profile
   (build/chip_smoke_controlnet_profile.txt);
7. the training paths: each full-width KD stack (the serving stack with an
   fp32 adapter and VAE, plus the CLIP teachers: ViT-L and bigG for SDXL,
   ViT-L alone for SD1.5) from cli/train.py's build_demo_full: first one KD
   step's adapter gradient at batch 1, 512², through the kernels against
   plain attention (identical draws, relative L2 error below 5e-2; for
   SDXL also with the GroupNorm opt-in on against off); then
   KDTrainer.fit for 3 steps (SDXL at micro-batch 10, 640²; SD1.5 at 40,
   512², the reference's operating point) with the launch counts set to 0:
   finite losses, an adapter that moved, every frozen tensor bit-identical
   (checksums), and the launches the dispatch gives (per step: B3 with lse
   twice per student kernel call, forward and recompute; B4 and B5 once
   each; B1 and B3 without lse once per teacher call, whose cross-attention
   reads the teachers' 77 tokens); step time, samples/s, peak memory and a
   torch.profiler trace of one step (tables in
   build/chip_smoke_train_profile.txt and
   build/chip_smoke_sd15_train_profile.txt).

The last lines are the card, a {"kernels": [...]} line and
{"ok": true, "device": {...}}. Each row of the kernels line is one kernel at
one shape (B3 rows with or without lse); its launches on a path are those of
the path's attention calls at that shape (the dispatch's calls times
PER_CALL of the caller's role) or, for B6/B6-b, of the path's GroupNorm
calls at that shape (groupnorm_calls), and the rows of a kernel must add up to the
launches its wrapper counted on the path; check rows (long sequence,
ragged, D=128, the GroupNorm's fp32 and ragged cases) that no path runs
show 0. TF32 is off for matmuls and convolutions. Every path but the
ControlNet's runs with the GroupNorm opt-in off and must launch no B6/B6-b.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (SXM data sheet)
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3 (SXM data sheet)
KERNEL_RTOL = 8e-3          # max|out - ref| / max|ref|: 2x bf16's 2^-8 rounding
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

# Each model's paths: the serving request's image side and DDIM steps, the
# training micro-batch and image side. SDXL's 4 steps are cut from 30 to fit
# the time limit; SD1.5's are BASELINE config 1 (512², DDIM-20) and the
# reference's train_sd_zh.py micro-batch (40 at 512²).
MODELS = {
    "sdxl": dict(size=1024, steps=4, train_batch=10, train_size=640),
    "sd15": dict(size=512, steps=20, train_batch=40, train_size=512),
}
SD15_TRAIN_BH = MODELS["sd15"]["train_batch"] * SD15_HEADS
CONTROLNET_PATH = "sdxl controlnet serving"


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
    "B1": dict(name="B1 onepass_attention", route="cuda", source=SRC + "attention_fwd.cu",
               replaces="pea_diffusion_tpu/ops/onepass_attention.py:50"),
    "B3": dict(name="B3 flash_attention", route="cuda", source=SRC + "attention_fwd.cu",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:31"),
    "B4": dict(name="B4 flash_backward_dkdv", route="cuda", source=SRC + "attention_bwd.cu",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:156"),
    "B5": dict(name="B5 flash_backward_dq", route="cuda", source=SRC + "attention_bwd.cu",
               replaces="pea_diffusion_tpu/ops/flash_attention.py:203"),
    "B6": dict(name="B6 group_norm", route="cuda", source=SRC + "groupnorm.cu",
               replaces="pea_diffusion_tpu/ops/groupnorm.py:126"),
    "B6-b": dict(name="B6-b group_norm with bias", route="cuda", source=SRC + "groupnorm.cu",
                 replaces="pea_diffusion_tpu/ops/groupnorm.py:131"),
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


def forward_cases():
    """(kernel, batch, sq, skv, heads, head_dim, with lse, {path: (route, sq,
    skv)}, what). B3 rows are head-major: batch is B*H, heads 1."""
    sdxl_t, sd15_s, sd15_t = "sdxl training", "sd15 serving", "sd15 training"

    def sdxl_s(key):  # SDXL serving and the ControlNet path run the same shapes
        return {"sdxl serving": key, CONTROLNET_PATH: key}

    cases = [
        ("B1", 2, 4096, 4096, 10, 64, False, sdxl_s(("onepass", 4096, 4096)),
         "SDXL serving (and ControlNet): self-attention, level 1"),
        ("B1", 2, 1024, 1024, 20, 64, False, sdxl_s(("onepass", 1024, 1024)),
         "SDXL serving (and ControlNet): self-attention, level 2"),
        ("B1", 10, 1600, 1600, 10, 64, False, {sdxl_t: ("onepass", 1600, 1600)},
         "SDXL training teacher: self-attention, level 1"),
        ("B1", 2, 1024, 1000, 10, 64, False, {}, "masked ragged KV"),
        ("B1", 2, 1024, 1024, 10, 128, False, {}, "head_dim 128"),
        ("B3", 20, 4096, 52, 1, 64, False, sdxl_s(("flash", 4096, 52)),
         "SDXL serving (and ControlNet): cross-attention, level 1"),
        ("B3", 40, 1024, 52, 1, 64, False, sdxl_s(("flash", 1024, 52)),
         "SDXL serving (and ControlNet): cross-attention, level 2"),
        ("B3", 20, 1600, 52, 1, 64, True, {sdxl_t: ("flash", 1600, 52)},
         "SDXL training student: cross-attention, level 1, batch 2"),
        ("B3", 20, 1600, 77, 1, 64, False, {sdxl_t: ("flash", 1600, 77)},
         "SDXL training teacher: cross-attention, level 1, batch 2"),
        ("B3", 20, 1600, 1600, 1, 64, True, {sdxl_t: ("onepass", 1600, 1600)},
         "SDXL training student: self-attention (head-major), batch 2"),
        ("B3", 16, 4096, 4096, 1, 40, False, {sd15_s: ("flash", 4096, 4096)},
         "SD1.5 serving: self-attention, level 0"),
        ("B3", 16, 4096, 52, 1, 40, False, {sd15_s: ("flash", 4096, 52)},
         "SD1.5 serving: cross-attention, level 0"),
        ("B3", 16, 1024, 1024, 1, 80, False, {sd15_s: ("flash", 1024, 1024)},
         "SD1.5 serving: self-attention, level 1"),
        ("B3", 16, 1024, 52, 1, 80, False, {sd15_s: ("flash", 1024, 52)},
         "SD1.5 serving: cross-attention, level 1"),
    ]
    bh = SD15_TRAIN_BH
    for level, d, s in ((0, 40, 4096), (1, 80, 1024)):
        cases += [
            ("B3", bh, s, s, 1, d, False, {sd15_t: ("flash", s, s)},
             f"SD1.5 training teacher (and the student's first, gradient-free call): "
             f"self-attention, level {level}"),
            ("B3", bh, s, s, 1, d, True, {sd15_t: ("flash", s, s)},
             f"SD1.5 training student: self-attention, level {level}"),
            ("B3", bh, s, TEXT_TOKENS, 1, d, True, {sd15_t: ("flash", s, TEXT_TOKENS)},
             f"SD1.5 training student: cross-attention, level {level}"),
            ("B3", bh, s, TEACHER_TOKENS, 1, d, False, {sd15_t: ("flash", s, TEACHER_TOKENS)},
             f"SD1.5 training teacher: cross-attention, level {level}"),
        ]
    cases += [("B3", 16, 1000, 1000, 1, d, False, {}, f"ragged Sq and Skv, head_dim {d}")
              for d in (40, 80)]
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
            plain = lambda: onepass_attention.onepass_forward_ref(  # noqa: E731
                q.float(), k.float(), v.float(), h, d)
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
        if kern == "B3":  # both variants: the same output, and the lse
            out_l, lse_l = out if lse else flash_attention.flash_forward(q, k, v, with_lse=True)
            out_p = flash_attention.flash_forward(q, k, v) if lse else out
            ref_lse = ref[1] if lse else plain_flash(q, k, v, True)[1]
            lse_err = (lse_l - ref_lse).abs().max().item()
            if not lse_err < 1e-3 or not torch.equal(out_l, out_p):
                raise AssertionError(f"B3 {what}: lse error {lse_err}, or the output "
                                     "differs with and without lse")
            del out_l, lse_l, out_p, ref_lse
        del out, ref
        ms = time_ms(torch, run, 20, flush)
        plain_ms = time_ms(torch, plain, 3, flush)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(*views), 20, flush)
        flops = 4 * b * h * sq * skv * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + (4 * b * sq if lse else 0)
        entries.append(_entry(kern, b, sq, skv, h, d, what, err, rel, KERNEL_RTOL, ms,
                              plain_ms, flops, nbytes, library_ms, stands_for, lse))
    return entries


def backward_cases():
    """(bh, sq, skv, head_dim, {path: (route, sq, skv)}, what), head-major."""
    sdxl_t, sd15_t, bh = "sdxl training", "sd15 training", SD15_TRAIN_BH
    return [
        (20, 1600, 1600, 64, {sdxl_t: ("onepass", 1600, 1600)},
         "SDXL training: self-attention, level 1, batch 2"),
        (20, 1600, 52, 64, {sdxl_t: ("flash", 1600, 52)},
         "SDXL training: cross-attention, level 1, batch 2"),
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
        (16, 1000, 1000, 40, {}, "ragged Sq and Skv, head_dim 40"),
        (16, 1000, 1000, 80, {}, "ragged Sq and Skv, head_dim 80"),
    ]


def run_backward_cases(torch, F, randn, flush):
    """B4 and B5 against flash_backward_ref, head-major [BH, S, D] bf16."""
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
        del ref_dq, ref_dk, ref_dv, dq, dk, dv
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
        entries.append(_entry("B4", bh, sq, skv, 1, d, what, err4, rel4, BWD_RTOL, ms4,
                              plain_ms, 8 * ops, 2 * bh * (2 * sq + 4 * skv) * d + rows,
                              library_ms, stands_for))
        entries.append(_entry("B5", bh, sq, skv, 1, d, what, err5, rel5, BWD_RTOL, ms5,
                              plain_ms, 6 * ops, 2 * bh * (3 * sq + 2 * skv) * d + rows,
                              library_ms, stands_for))
    return entries


def _entry(kern, b, sq, skv, h, d, what, err, rel, rtol, ms, plain_ms, flops, nbytes,
           library_ms, stands_for, lse=False):
    """One row of the kernels line. `stands_for` maps each path that runs
    this shape to its attention call key (route, sq, skv); the row's launches
    on a path are the launches of that path's calls at the key (for B3, those
    with lse on a row with lse, the others on a row without)."""
    bound_ms, bound_by = bound(flops, nbytes)
    shape = f"batch={b} sq={sq} skv={skv} heads={h} head_dim={d} bf16"
    e = dict(KERNELS[kern], shape=shape + (", with lse" if lse else ""),
             what=what, max_abs_err=err, max_rel_err=rel, rel_tolerance=rtol, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
             kernel=kern, lse=lse, stands_for=stands_for, launches_by_path={})
    log(f"[kernel] {e['name']} {what} ({e['shape']}): err {err:.3g} (rel {rel:.3g}) "
        f"ms {ms:.4f} plain {plain_ms:.4f} library {library_ms:.4f} "
        f"bound {bound_ms:.4f} ({bound_by})")
    return e


def groupnorm_calls(model, side, batch):
    """{(kernel, batch, channels, side, act): calls} of one forward of a UNet
    or ControlNet at latent side `side`, or of a VAE decoder from latent side
    `side`, from the GroupNorm modules each block holds at its spatial side:
    B6-b for a resnet's norm2 that adds the time embedding, B6 for every
    other one (the dispatch of models.layers.GroupNorm with the opt-in on)."""
    from collections import Counter

    from pea_diffusion_tpu_torch.models.layers import GroupNorm, ResnetBlock2D

    if hasattr(model, "down_blocks"):
        n = len(model.down_blocks)
        levels = ([(blk, side >> i) for i, blk in enumerate(model.down_blocks)]
                  + [(model.mid_block, side >> (n - 1))]
                  + [(blk, side >> (n - 1 - i))
                     for i, blk in enumerate(getattr(model, "up_blocks", []))])
        last = side
    else:  # a VAE decoder: the mid block at the latent side, each up block doubles it
        levels = [(model.mid_block, side)] + [(blk, side << i)
                                              for i, blk in enumerate(model.up_blocks)]
        last = side << (len(model.up_blocks) - 1)
    if hasattr(model, "conv_norm_out"):
        levels.append((model.conv_norm_out, last))
    counts = Counter()
    for block, s in levels:
        biased = {id(m.norm2) for m in block.modules()
                  if isinstance(m, ResnetBlock2D) and m.time_emb_proj is not None}
        for m in block.modules():
            if isinstance(m, GroupNorm):
                kern = "B6-b" if id(m) in biased else "B6"
                counts[kern, batch, m.weight.shape[0], s, m.act] += 1
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
    for label, model, batch in modules:
        for key in groupnorm_calls(model, MODELS["sdxl"]["size"] // 8, batch):
            owners[key].add(label)
    cases = []
    for key in sorted(owners, key=lambda k: (k[0], -k[3], k[2], k[4])):
        kern, b, c, side, act = key
        what = (f"SDXL ControlNet serving: {' + '.join(sorted(owners[key]))}, "
                f"{c} channels at {side}², act {act}")
        cases.append((kern, b, c, side, side, 32, act, torch.bfloat16,
                      {CONTROLNET_PATH: key[1:]}, what))
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
    input contiguous and channels-last; CUDA-event times of the kernel in
    both layouts ("ms" is channels-last's: the UNet, ControlNet and VAE take
    NHWC and permute it, so every GroupNorm on the path gets a channels-last
    tensor, as the ControlNet phase tallies), of the plain version in the
    input's type and of one F.group_norm call (x + t formed beforehand: the
    GroupNorm alone), each on the channels-last input."""
    from pea_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = []
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
        ref = gn.fused_gn_ref(x.float(), scale.float(), bias.float(), groups, 1e-5, act,
                              None if tb is None else tb.float())
        outs = [run(x), run(x_cl)]
        torch.cuda.synchronize()
        if outs[0].dtype != dtype or not outs[1].is_contiguous(
                memory_format=torch.channels_last):
            raise AssertionError(f"{kern} {what}: output type or layout")
        err, rel = _check(KERNELS[kern]["name"], what, outs, [ref, ref], KERNEL_RTOL)
        del outs, ref
        ms, ms_nchw = time_ms(torch, lambda: run(x_cl), 20, flush), time_ms(
            torch, lambda: run(x), 20, flush)
        plain_ms = time_ms(torch, lambda: gn.fused_gn_ref(
            x_cl, scale, bias, groups, 1e-5, act, tb), 5, flush)
        xt = x_cl if tb is None else x_cl + tb[:, :, None, None]
        library_ms = time_ms(torch, lambda: F.group_norm(xt, groups, scale, bias, 1e-5), 20,
                             flush)
        size = x.element_size()
        nbytes = 2 * x.numel() * size + 2 * c * size + (0 if tb is None else tb.numel() * size)
        flops = x.numel() * (5 + (4 if act == "silu" else 0) + (0 if tb is None else 1))
        bound_ms, bound_by = bound(flops, nbytes, H100_FP32_FLOPS)
        shape = (f"batch={b} channels={c} h={h} w={w} groups={groups} act={act} "
                 f"{str(dtype).replace('torch.', '')}")
        e = dict(KERNELS[kern], shape=shape, what=what, max_abs_err=err, max_rel_err=rel,
                 rel_tolerance=KERNEL_RTOL, ms=ms, ms_contiguous=ms_nchw, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                 library_what="F.group_norm" + (", GN only" if act == "silu" or tb is not None
                                                else ""),
                 kernel=kern, lse=False, stands_for=stands_for, launches_by_path={})
        log(f"[kernel] {e['name']} {what} ({shape}): err {err:.3g} (rel {rel:.3g}) ms "
            f"{ms:.4f} (channels-last) contiguous {ms_nchw:.4f} plain {plain_ms:.4f} library "
            f"{library_ms:.4f} bound {bound_ms:.4f} ({bound_by})")
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


def attention_routes(unet, latent: int, skv: int, device_type="cuda", grad_free=None):
    """{(route, sq, skv): calls} of one UNet forward at a latent side
    `latent`, from the dispatch each attention module takes at its level's
    sequence length. With `grad_free` False or True, only the calls whose
    inputs do or do not depend on the text conditioning, which is what
    decides whether autograd records them when the adapter trains: without
    SDXL's added conditioning (pooled text in the time embedding), the calls
    before the first cross-attention see only the latents and the timestep
    (SD1.5: the first self-attention of level 0)."""
    from collections import Counter

    from pea_diffusion_tpu_torch.models.layers import attention_route

    n = len(unet.down_blocks)
    levels = ([(blk, i) for i, blk in enumerate(unet.down_blocks)] + [(unet.mid_block, n - 1)]
              + [(blk, n - 1 - i) for i, blk in enumerate(getattr(unet, "up_blocks", []))])
    conditioned = getattr(unet.config, "unet", unet.config).addition_embed_type == "text_time"
    counts = Counter()
    for block, level in levels:  # in the order the forward runs them
        sq = (latent >> level) ** 2
        for tr in getattr(block, "attentions", []):
            for tb in tr.transformer_blocks:
                for attn, kv in ((tb.attn1, sq), (tb.attn2, skv)):
                    conditioned = conditioned or attn is tb.attn2
                    if grad_free is not None and grad_free == conditioned:
                        continue
                    route = attention_route(sq, kv, attn.num_heads, attn.head_dim,
                                            attn.backend, device_type)
                    counts[route, sq, kv] += 1
    return counts


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


def route_totals(routes):
    """{route: calls} of `routes`, for the log."""
    totals = {}
    for (route, _, _), n in routes.items():
        totals[route] = totals.get(route, 0) + n
    return totals


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

    for fn in (op.onepass_forward, fa.flash_forward, fa.flash_backward_dkdv,
               fa.flash_backward_dq, gn.group_norm_fwd, gn.group_norm_bias_fwd):
        fn.launches = 0
    fa.flash_forward.lse_launches = 0
    gn.group_norm_fwd.copies = 0


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


def stage_times(torch, models, tokenize, prompt, kernels, forwards, model, path):
    """CUDA-event times of one request's stages, each the mean of 3 warm runs."""
    from pea_diffusion_tpu_torch.pipelines.text2image import (
        decode_latents, encode_prompt_sd, encode_prompt_sdxl, make_add_time_ids)

    size = MODELS[model]["size"]
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


def profile_run(torch, fn, unprofiled_s, table_path, tag):
    """torch.profiler over one call of `fn`: device busy time against wall
    time and against the unprofiled call (`unprofiled_s`), and the kernels
    that take the most device time. The full table goes to `table_path`.
    Returns the idle share of the unprofiled call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(per_kernel.values())
    if busy == 0:
        raise AssertionError(f"[{tag}] the profiler saw no device time")
    idle = max(0.0, 1 - busy / (unprofiled_s * 1e3))
    fwd = sum(v for k, v in per_kernel.items() if "attention_fwd_kernel" in k)
    bwd = sum(v for k, v in per_kernel.items() if "attention_bwd_" in k)
    log(f"[{tag}] device busy {busy:.1f} ms of {wall_ms:.1f} ms wall under the "
        f"profiler; of the unprofiled run ({unprofiled_s * 1e3:.1f} ms) the device "
        f"is idle {idle:.3f}; B1+B3 kernels {fwd:.1f} ms, B4+B5 kernels {bwd:.1f} ms")
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
    """Turns the fused GroupNorm opt-in (PEA_FUSED_GROUPNORM=1) on or off."""
    import os

    if on:
        os.environ["PEA_FUSED_GROUPNORM"] = "1"
    else:
        os.environ.pop("PEA_FUSED_GROUPNORM", None)


def reference_kd_step(torch, models, model, compare="attention"):
    """One KD step's adapter gradient at batch 1, 512², with the same draws:
    through the attention kernels against plain attention (`compare`
    "attention"), or with the fused GroupNorm opt-in on against off
    ("groupnorm": B6/B6-b forward, the plain VJP backward, on every norm of
    the student UNet and the fp32 VAE encoder). Relative L2 error."""
    from pea_diffusion_tpu_torch.cli.train import demo_full_batches
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention
    from pea_diffusion_tpu_torch.train.kd import kd_loss

    batch = next(demo_full_batches("cuda", 1, 512, seed=5, model=model))
    batch["zh_or_not"] = torch.full((1,), 0.5, device="cuda")  # both loss routes
    gen = torch.Generator(device="cuda").manual_seed(11)
    draws, grads, losses = {}, {}, {}
    attns = [m for m in models.unet.modules() if isinstance(m, MultiHeadAttention)]
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
    log(f"[reference] {model} KD step, batch 1, 512², {what}: loss {losses[a]:.6g} vs "
        f"{losses[b]:.6g}; adapter gradient relative L2 error {rel:.3g}")
    if not (rel < KD_GRAD_RTOL and grads[a].norm().item() > 0):
        raise AssertionError(f"{model} KD adapter gradient, {what}: {rel}")
    if compare != "attention" and gn_launches == 0:
        raise AssertionError(f"{model} KD step with the opt-in on launched no GroupNorm kernel")


def training_path(torch, models, make_batches, repo, kernels, model):
    """KDTrainer.fit for TRAIN_STEPS steps at the model's micro-batch and
    image side, from launch counts of 0; stamps the launches on the kernel
    rows."""
    import shutil

    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    batch_size, size = MODELS[model]["train_batch"], MODELS[model]["train_size"]
    sdxl = model == "sdxl"
    tag, path = ("train", "sdxl training") if sdxl else ("sd15 train", "sd15 training")
    out = repo / "build" / ("chip_smoke_train" if sdxl else "chip_smoke_sd15_train")
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
    log(f"[{tag}] attention calls per UNet forward at {size}²: {route_totals(teacher)}; "
        f"student by (route, sq, skv): {dict(student)}, of which no input depends on the "
        f"adapter: {dict(grad_free)}; teacher: {dict(teacher)}")

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
    step_s = (recs[-1]["time"] - recs[0]["time"]) / (TRAIN_STEPS - 1)
    log(f"[{tag}] {TRAIN_STEPS} steps at micro-batch {batch_size}, {size}²: losses "
        f"{losses}; grad norms {[r['grad_norm'] for r in recs]}; step time (mean of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f} s, {batch_size / step_s:.4f} samples/s; peak memory "
        f"{peak:.2f} GiB; adapter moved, {len(frozen)} frozen tensors bit-identical")

    batch = next(make_batches(TRAIN_STEPS))
    gen = torch.Generator(device="cuda").manual_seed(99)
    table = "chip_smoke_train_profile.txt" if sdxl else "chip_smoke_sd15_train_profile.txt"
    profile_run(torch, lambda: trainer.step_fn(trainer.state, batch, gen), step_s,
                repo / "build" / table, f"{tag} profile")


def serving_phase(torch, model, kernels, repo):
    """The full-width serving stack of `model`: its attention modules
    against plain attention, then REQUESTS requests with the launch counts
    set to 0 just before and read just after, the stage times and a
    profile."""
    from pea_diffusion_tpu_torch.cli.generate import build_demo_full
    from pea_diffusion_tpu_torch.pipelines.text2image import (StableDiffusionPEAPipeline,
                                                              StableDiffusionXLPEAPipeline)

    size, steps = MODELS[model]["size"], MODELS[model]["steps"]
    sdxl = model == "sdxl"
    tag, path = ("main", "sdxl serving") if sdxl else ("sd15 main", "sd15 serving")
    t1 = time.time()
    models, tokenize, _ = build_demo_full("cuda", model=model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (models.text_encoder, models.adapter,
                                       models.unet, models.vae)
                   for p in m.parameters())
    log(f"[init] full-width {model} serving stack on the card in {time.time() - t1:.1f}s, "
        f"{n_params / 1e9:.3f}B parameters")
    reference_attention_modules(torch, models.unet, size // 8, (1, 2) if sdxl else (0, 1))

    pipe = (StableDiffusionXLPEAPipeline if sdxl else StableDiffusionPEAPipeline)(
        models, sampler_name="ddim")
    prompts = ["一只戴着帽子的可爱猫咪", "雪山下的湖泊，清晨的阳光"]
    routes = attention_routes(models.unet, size // 8, TEXT_TOKENS)
    calls = [("serving", routes, steps * REQUESTS)]
    want = path_launches(calls)
    reset_launch_counts()
    req_s = main_path(torch, pipe, tokenize, prompts, size, steps, tag)
    served = launch_counts()
    log(f"[{tag}] attention calls per UNet forward at {size}²: {route_totals(routes)}; "
        f"by (route, sq, skv): {dict(routes)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches(tag, served, want)
    stamp_launches(kernels, path, calls, served)

    stage_times(torch, models, tokenize, prompts[0], kernels, steps * REQUESTS, model, path)
    table = "chip_smoke_profile.txt" if sdxl else "chip_smoke_sd15_profile.txt"
    profile_run(torch, lambda: pipe(tokenize([prompts[0]]), tokenize([""]), height=size,
                                    width=size, num_steps=steps, guidance_scale=GUIDANCE,
                                    seed=7),
                min(req_s), repo / "build" / table, f"{tag} profile")
    if sdxl:
        fused_gn_ab(torch, models, pipe, tokenize, prompts[0], repo)


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

    size, steps = MODELS["sdxl"]["size"], MODELS["sdxl"]["steps"]
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
        for on in (False, True):
            set_fused_gn(on)
            idle[on] = profile_run(torch, request, min(lat[on]),
                                   repo / "build" / f"chip_smoke_gn_{'on' if on else 'off'}"
                                   "_profile.txt", f"fused gn {'on' if on else 'off'} profile")
    finally:
        set_fused_gn(False)
    log(f"[fused gn] warm {size}² request, opt-in off {lat[False]} s, on {lat[True]} s "
        f"(turns off, on, on, off); idle share off {idle[False]:.3f}, on {idle[True]:.3f}; "
        f"max |image on - image off| {diff:.4g}")


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

    size, steps = MODELS[model]["size"], MODELS[model]["steps"]
    latent, tag = size // 8, "controlnet"
    t1 = time.time()
    models, tokenize, _ = build_demo_full("cuda")
    cn = build_controlnet(models.unet.config, device="cuda", seed=1, zero_init=False)
    control = prepare_control_image(control_image(size), size, size, 1, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] full-width SDXL stack and ControlNet ({sum(p.numel() for p in cn.parameters()) / 1e9:.3f}B "
        f"parameters) on the card, control image {tuple(control.shape)} with "
        f"{control.mean().item():.4f} of it edges, in {time.time() - t1:.1f}s")
    prompts = ["一只戴着帽子的可爱猫咪", "雪山下的湖泊，清晨的阳光"]

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
        for i, prompt in enumerate(prompts[:REQUESTS]):
            torch.cuda.synchronize()
            t0 = time.time()
            images.append(request(prompt, i).float())
            torch.cuda.synchronize()
            req_s.append(time.time() - t0)
            check_image(images[-1], size, f"{tag} request {i}", req_s[-1])
        served = launch_counts()
        log(f"[{tag}] attention calls per UNet + ControlNet forward: {route_totals(routes)}; "
            f"layout copies before a GroupNorm kernel: {gn.group_norm_fwd.copies}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_launches(tag, served, want)
        stamp_launches(kernels, CONTROLNET_PATH, calls, served, gn_calls)

        layouts = Counter()
        hooks = [m.register_forward_pre_hook(lambda mod, args: layouts.update(
            [gn.layout(args[0])])) for m in norms]
        try:
            off = request(prompts[0], 0, controlnet_conditioning_scale=0.0).float()
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
        check_image(request(prompts[1], 5, guess_mode=True).float(), size, f"{tag} guess mode",
                    time.time() - t0)
        guess_s = time.time() - t0
        dev = models.device
        ids = torch.as_tensor(tokenize([prompts[1]]), device=dev)
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
        profile_run(torch, lambda: request(prompts[1], 5, guess_mode=True), guess_s,
                    repo / "build" / "chip_smoke_controlnet_profile.txt", f"{tag} profile")
    finally:
        set_fused_gn(False)


def training_phase(torch, model, kernels, repo):
    """The full-width KD stack of `model`: one step's adapter gradient
    against plain attention, then the training path."""
    from pea_diffusion_tpu_torch.cli.train import build_demo_full

    spec = MODELS[model]
    t1 = time.time()
    models, make_batches = build_demo_full("cuda", spec["train_batch"], spec["train_size"],
                                           model=model)
    torch.cuda.synchronize()
    n_frozen = sum(p.numel() for m in models.frozen_modules().values() for p in m.parameters())
    log(f"[init] full-width {model} KD stack on the card in {time.time() - t1:.1f}s, "
        f"{sum(p.numel() for p in models.adapter.parameters()) / 1e6:.3f}M trainable and "
        f"{n_frozen / 1e9:.3f}B frozen parameters")
    reference_kd_step(torch, models, model)
    if model == "sdxl":
        reference_kd_step(torch, models, model, compare="groupnorm")
    training_path(torch, models, make_batches, repo, kernels, model)


def main() -> int:
    import gc

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

    for line in kernel_build.build().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    log(f"[build] done in {time.time() - t0:.1f}s")

    kernels = kernel_phases(torch, F)
    log(f"[kernel] phase done at {time.time() - t0:.1f}s")
    for model in MODELS:
        reference_tiny_stack(torch, build_demo, model)

    for phase, model in ((serving_phase, "sdxl"), (serving_phase, "sd15"),
                         (controlnet_phase, "sdxl"), (training_phase, "sdxl"),
                         (training_phase, "sd15")):
        phase(torch, model, kernels, repo)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{phase.__name__}] {model} done at {time.time() - t0:.1f}s")

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
    sys.exit(main())
