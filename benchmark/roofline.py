"""The yardstick's arithmetic: the H100's published peaks, the operations and
bytes of the UNet's attention cores from the configuration's shapes, and
the model FLOPs of a served image or a trained sample, counted over the
plain reference on the meta device (``torch.utils.flop_counter``: matrix
products and convolutions, forward and the backward autograd needs)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .reference import diffusion
from .reference import models as ref

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the attention cores the program's hand-written kernels serve: query
# lengths from this on (shorter ones run as plain PyTorch)
KERNEL_MIN_SQ = 1024
# the device kernels that implement them (B1, B3 and the backward B4 / B5)
ATTENTION_KERNELS = ("attention_fwd_kernel", "wgmma_attention_kernel",
                     "attention_bwd_dkdv", "attention_bwd_dq",
                     "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")

Call = Tuple[int, int, int, int, bool]  # sq, skv, heads, head dim, needs a backward


def unet_attention(unet_cfg: Dict, latent_h: int, latent_w: int, context: int,
                   added_cond_grad: bool = True) -> List[Call]:
    """Every attention core of one UNet forward for one sample, in order.
    The last field says whether a backward to the adapter needs it: all but
    the first self-attention when the UNet has no added conditioning (its
    input then depends on the timestep alone)."""
    s = ref.UNetSpec(unet_cfg)
    n = len(s.blocks)
    calls: List[Call] = []

    def blocks(level: int, depth: int):
        hw = (latent_h >> level) * (latent_w >> level)
        d = s.blocks[level] // s.heads[level]
        for _ in range(depth):
            calls.append((hw, hw, s.heads[level], d, True))
            calls.append((hw, context, s.heads[level], d, True))

    for i in range(n):
        for _ in range(s.lpb if s.depth[i] else 0):
            blocks(i, s.depth[i])
    if s.mid_depth:
        blocks(n - 1, s.mid_depth)
    for level in reversed(range(n)):
        for _ in range(s.lpb + 1 if s.depth[level] else 0):
            blocks(level, s.depth[level])
    if s.added is None or not added_cond_grad:
        sq, skv, h, d, _ = calls[0]
        calls[0] = (sq, skv, h, d, False)
    return calls


def forward_cost(rows: int, sq: int, skv: int, h: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of softmax(QK^T)V in bf16: Q, K, V read and O written
    once."""
    return 4.0 * rows * h * sq * skv * d, 2.0 * rows * h * d * (2 * sq + 2 * skv)


def backward_cost(rows: int, sq: int, skv: int, h: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the attention backward: S again, dV, dP, dQ and dK
    (five products); Q, K, V, dO and the fp32 row statistics read, dQ, dK,
    dV written once."""
    return (10.0 * rows * h * sq * skv * d,
            2.0 * rows * h * d * (3 * sq + 4 * skv) + 8.0 * rows * h * sq)


def least_time(cost: Tuple[float, float]) -> float:
    return max(cost[0] / PEAK_FLOPS, cost[1] / PEAK_BYTES)


def attention_least_s(calls: Sequence[Call], rows: int, backward: bool = False) -> float:
    total = 0.0
    for sq, skv, h, d, grad in calls:
        if sq < KERNEL_MIN_SQ:
            continue
        total += least_time(forward_cost(rows, sq, skv, h, d))
        if backward and grad:
            total += least_time(backward_cost(rows, sq, skv, h, d))
    return total


def kernel_seconds(kernels: Sequence[Tuple[str, float, float]],
                   patterns: Sequence[str] = ATTENTION_KERNELS) -> float:
    return sum(t - s for name, s, t in kernels if any(p in name for p in patterns)) / 1e6


def share(least_s: float, kernels, patterns=ATTENTION_KERNELS) -> Optional[float]:
    """100 x least time over the matched kernels' time; None when no such
    kernel ran."""
    spent = kernel_seconds(kernels, patterns)
    return None if spent <= 0 else 100.0 * least_s / spent


def _count(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def serve_flops_per_image(config: Dict, traffic: Dict) -> float:
    """Model FLOPs of one served image: the prompt and the negative prompt
    through the tower and the adapter, `steps` UNet forwards of the CFG
    pair, one VAE decode."""
    comp = config["components"]
    size, steps, t = traffic["size"], traffic["steps"], traffic["max_length"]
    lat = size // 8
    text = ref.build("text_encoder", comp["text_encoder"]["config"])
    adapter = ref.build("adapter", comp["adapter"]["config"])
    unet = ref.build("unet", comp["unet"]["config"])
    vae = ref.build("vae", comp["vae"]["config"])
    meta = torch.device("meta")

    def prompt():
        adapter(text(torch.zeros((2, t), dtype=torch.long, device=meta)))

    def unet_pair():
        x = torch.zeros((2, lat, lat, 4), device=meta)
        tt = torch.zeros((2,), dtype=torch.long, device=meta)
        ctx = torch.zeros((2, t, comp["unet"]["config"]["cross_attention_dim"]), device=meta)
        added = None
        if unet.spec.added == "text_time":
            pooled = unet.spec.added_in - 6 * unet.spec.added_time_dim
            added = {"text_embeds": torch.zeros((2, pooled), device=meta),
                     "time_ids": torch.zeros((2, 6), device=meta)}
        unet(x, tt, ctx, added)

    def decode():
        vae.decode(torch.zeros((1, lat, lat, 4), device=meta))

    with torch.no_grad():
        return _count(prompt) + steps * _count(unet_pair) + _count(decode)


def train_flops_per_sample(config: Dict, traffic: Dict,
                           hw: Optional[Tuple[int, int]] = None) -> float:
    """Model FLOPs of one KD sample of `hw` pixels (default: the mix's
    square ``size``): the VAE encode, the student and teacher towers on the
    prompt and the negative prompt, the adapter forward and backward, the
    teacher and student UNet forwards and the student's backward to the
    adapter (no recomputation)."""
    comp = config["components"]
    t, tt = traffic["text_tokens"], traffic["teacher_tokens"]
    height, width = hw or (traffic["size"], traffic["size"])
    meta = torch.device("meta")
    m = {n: ref.build(n, comp[n]["config"]).requires_grad_(n == "adapter")
         for n in ("vae", "text_encoder", "unet", "adapter", "teacher_1", "teacher_2")
         if n in comp}
    f = 2 ** (len(comp["vae"]["config"]["block_out_channels"]) - 1)
    lat_h, lat_w = height // f, width // f
    batch = {"pixel_values": torch.zeros((1, height, width, 3), device=meta),
             "input_ids": torch.zeros((1, t), dtype=torch.long, device=meta),
             "input_ids_uncond": torch.zeros((1, t), dtype=torch.long, device=meta),
             "zh_or_not": torch.full((1,), 0.5, device=meta)}
    for k in (1, 2):
        if f"teacher_{k}" in m:
            batch[f"teacher_ids_{k}"] = torch.zeros((1, tt), dtype=torch.long, device=meta)
            batch[f"teacher_uncond_ids_{k}"] = torch.zeros((1, tt), dtype=torch.long,
                                                           device=meta)
    if "teacher_2" in m:
        batch["time_ids"] = torch.zeros((1, 6), device=meta)
    draws = {"vae_eps": torch.zeros((1, lat_h, lat_w, 4), device=meta),
             "noise": torch.zeros((1, lat_h, lat_w, 4), device=meta),
             "offset_noise": torch.zeros((1, 1, 1, 4), device=meta),
             "timesteps": torch.zeros((1,), dtype=torch.long, device=meta),
             "cfg_uniform": torch.zeros((1, 1, 1), device=meta)}
    hp = dict(traffic["train"])
    hp["vae_scaling"] = comp["vae"]["config"]["scaling_factor"]
    acp = diffusion.alphas_cumprod(config["scheduler"])

    def step():
        loss, _ = diffusion.kd_loss_rows(m, hp, batch, draws, acp, slice(0, 1), 1)
        torch.autograd.grad(loss, list(m["adapter"].parameters()))

    return _count(step)
