"""S2: a sweep of the GroupNorm kernels B6 / B6-b over their variants, at
every GroupNorm shape of the port's main paths.

    python3 -m pea_diffusion_tpu_torch.tools.sweep_groupnorm [--paths sdxl16,sd15b40] \\
        [--iters 20] [--out sweep.json]

The paths (``PATHS``): the SDXL UNet at CFG batch 16 (co-batched serving
of 8 requests at 1024², bf16), the SD1.5 UNet at batch 40 (the KD
teacher at 512², bf16), the SDXL VAE decoder at batch 1 (fp32, 1024²) and
the SD1.5 VAE encoder at batch 2 (fp32, KD's encode chunks at 512²). Their
GroupNorm shapes come from the modules, built on the meta device
(``path_cases``); every map is channels-last, as the models hand it on.

Prints one JSON row per (shape, variant): ``path``, ``kernel`` (B6, or
B6-b where a resnet adds its time embedding), ``shape``, ``calls``
(launches a forward of the path), ``variant``, ``us`` (mean CUDA-event
time, each launch after an L2 flush and queued behind a device sleep, so
the host's issue time falls outside),
``bound_us`` (one read and one write of the map at 3.35 TB/s),
``two_read_bound_us`` (two reads and one write), ``rel_err`` (max |kernel
- plain| / max |plain|, the plain version ``fused_gn_ref`` in fp32 from the
same inputs), ``same_bits`` (a second launch gives the same bits),
``shipped`` (whether B6 / B6-b run this variant at the shape),
``resident`` and ``vec`` (the persistent variant's plan and vector width),
and once a shape ``plain_us``, the plain route's time
(``group_norm_act``). Runs on a CUDA card only and raises without one. It
picks no winner itself: the shipped variant is a rule in
``csrc/groupnorm.cu``, set from these rows.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Callable, Dict, List, Tuple

import torch

from ..ops import groupnorm as gn

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
QUEUE_SLEEP_CYCLES = 50_000_000  # ~30 ms at the H100's clock: covers a batch of launches
FLUSH_BYTES = 256 << 20  # over the 50 MB L2

# (model, latent or pixel side, batch, dtype) of each path
PATHS = {
    "sdxl16": ("sdxl_unet", 128, 16, torch.bfloat16),
    "sd15b40": ("sd15_unet", 64, 40, torch.bfloat16),
    "sdxl_decode": ("sdxl_decoder", 128, 1, torch.float32),
    "sd15_encode": ("sd15_encoder", 512, 2, torch.float32),
}


def groupnorm_calls(model, side: int, batch: int) -> Counter:
    """{(kernel, batch, channels, groups, side, act): calls} of one forward
    of a UNet at latent side `side`, a VAE encoder at pixel side `side` or a
    VAE decoder from latent side `side`, from the GroupNorm modules each
    block holds at its spatial side: B6-b for a resnet's norm2 that adds the
    time embedding, B6 for every other one."""
    from ..models.layers import GroupNorm, ResnetBlock2D

    if hasattr(model, "down_blocks"):  # a UNet, or a VAE encoder (no up blocks)
        n = len(model.down_blocks)
        levels = ([(blk, side >> i) for i, blk in enumerate(model.down_blocks)]
                  + [(model.mid_block, side >> (n - 1))])
        ups = getattr(model, "up_blocks", None)
        if ups is None:
            last = side >> (n - 1)
        else:
            levels += [(blk, side >> (n - 1 - i)) for i, blk in enumerate(ups)]
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
                counts[kern, batch, m.weight.shape[0], m.num_groups, s, m.act] += 1
    return counts


def _model(name: str):
    from ..configs import SD15_UNET, SD15_VAE, SDXL_UNET, SDXL_VAE
    from ..models import AutoencoderKL, UNet2DCondition

    with torch.device("meta"):
        if name.endswith("unet"):
            return UNet2DCondition(SDXL_UNET if name.startswith("sdxl") else SD15_UNET)
        vae = AutoencoderKL(SDXL_VAE if name.startswith("sdxl") else SD15_VAE)
        return vae.decoder if name.endswith("decoder") else vae.encoder


def path_cases(paths: List[str]) -> List[Tuple[str, str, int, int, int, int, int, str,
                                               torch.dtype, int]]:
    """(path, kernel, batch, channels, groups, h, w, act, dtype, calls) of
    each distinct GroupNorm of the named paths, largest maps first."""
    out = []
    for path in paths:
        model, side, batch, dtype = PATHS[path]
        calls = groupnorm_calls(_model(model), side, batch)
        for (kern, b, c, groups, s, act), k in calls.items():
            out.append((path, kern, b, c, groups, s, s, act, dtype, k))
    return sorted(out, key=lambda r: (r[0], -r[2] * r[3] * r[5] * r[6], r[1]))


def _time_us(fn: Callable[[], torch.Tensor], iters: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of `fn` in microseconds, each launch after an L2
    flush, all queued behind a device sleep."""
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
    return 1e3 * sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def sweep(paths: List[str], iters: int) -> List[Dict]:
    """The rows of every case of `paths` in every variant."""
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_groupnorm needs a CUDA card")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for path, kern, b, c, groups, h, w, act, dtype, calls in path_cases(paths):
        gen = torch.Generator(device="cuda").manual_seed(b * c + h)
        x = (0.5 + 2 * torch.randn(b, c, h, w, device="cuda", generator=gen)).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        scale = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(dtype)
        bias = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(dtype)
        t = torch.randn(b, c, device="cuda", generator=gen).to(dtype) if kern == "B6-b" else None
        ref = gn.fused_gn_ref(x.float(), scale.float(), bias.float(), groups, 1e-5, act,
                              None if t is None else t.float())
        size = x.element_size()
        nbytes = x.numel() * size
        shape = f"{b}x{c}x{h}x{w} g{groups} {act} {str(dtype).replace('torch.', '')}"
        shipped = gn.shipped_gn_variant(b, c, h * w, groups, True, dtype, x.data_ptr())
        vec = gn.nhwc_vector_width(c, c // groups, size, x.data_ptr())
        for variant in gn.GN_VARIANTS:
            def run(variant=variant):
                return gn.group_norm_variant(x, scale, bias, groups, 1e-5, act, t=t,
                                             variant=variant)
            try:
                out, again = run(), run()
            except (RuntimeError, ValueError) as err:  # a shape the variant does not take
                rows.append(dict(path=path, kernel=kern, shape=shape, variant=variant,
                                 error=str(err)))
                continue
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            same = bool(torch.equal(out, again))
            del out, again
            plan = (gn.persistent_plan(b, c, h * w, groups, True, vec, size, sms)
                    if variant == "persistent" else None)
            rows.append(dict(
                path=path, kernel=kern, shape=shape, calls=calls, variant=variant,
                us=_time_us(run, iters, flush), bound_us=1e6 * 2 * nbytes / HBM_BYTES_PER_S,
                two_read_bound_us=1e6 * 3 * nbytes / HBM_BYTES_PER_S, rel_err=err,
                same_bits=same, shipped=variant == shipped,
                resident=None if plan is None else plan.resident,
                vec=vec if variant == "persistent" else None))
        plain = _time_us(lambda: gn.group_norm_act(x, scale, bias, groups, 1e-5, act, t),
                         max(2, iters // 4), flush)
        rows[-1]["plain_us"] = plain
        del x, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    with torch.inference_mode():
        rows = sweep(args.paths.split(","), args.iters)
    for row in rows:
        print(json.dumps(dict(row, device=device)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=device, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
