"""Knowledge-distillation train step (port of
``pea_diffusion_tpu/train/kd.py``; reference training_step,
train_sdxl_zh.py:305-449).

As in the JAX package: one frozen UNet serves the student and the teacher
forward; the feature taps are the UNet's ``capture_features`` outputs; only
the adapter is trained (it alone has ``requires_grad``; the towers, UNet and
VAE are frozen); non-finite per-sample loss terms are dropped; the student
UNet forward is recomputed in the backward under `remat_policy` (each policy a
non-reentrant ``torch.utils.checkpoint``):

- "full": one checkpoint over the whole student forward;
- "dots": selective checkpointing that saves the outputs of the matrix
  products without batch dimensions (``aten.mm``, ``aten.addmm``: the
  Linear layers) and recomputes everything else (``bmm``, convolutions,
  norms, elementwise ops and the attention kernels, whose autograd
  Functions launch through ctypes and run again in the recompute), as
  ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves only
  ``dot_general`` without batch dimensions;
- "blocks": the UNet's own segments (``UNet2DCondition(...,
  remat_segments=True)``), one checkpoint per unit the JAX package names
  "unet_seg", so that the backward recomputes one unit at a time.

The teacher runs under ``torch.no_grad()``, which is what the JAX package's
stop_gradient on it amounts to. ``feature_tap_dtype`` is the type of the
feature-KD terms' elementwise difference ("float32", or "bfloat16", the
JAX package's memory lever); their per-sample means reduce in fp32.

Random draws come from an explicit ``torch.Generator`` in a fixed order
(VAE eps, noise, offset noise, timesteps, the CFG-drop uniforms), or are
injected through ``draws``, so that a test can hand in the JAX package's.
Under data parallelism (`rows`) a rank draws the global micro-batch's
randoms from the generator that every rank shares, in the single-process
order, and keeps its own rows: N ranks take the step one process takes on
the global batch, as the JAX package's draws over the global batch, which
it then shards, do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.train import TrainConfig
from ..models.adapter import PEAAdapter
from ..models.clip_text import CLIPTextEncoder
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..schedulers import NoiseScheduleConfig, ddpm
from ..utils.trace import span
from . import optim

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class KDModels:
    """The modules of one KD run, their weights inside them."""

    adapter: PEAAdapter
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: nn.Module
    # ids [B, T] (mul_zh: {"mul", "zh"} dict) -> token states [B, T, D] of
    # the student tower
    text_encoder_fn: Callable[..., torch.Tensor]
    # teacher: CLIP-L + bigG penultimate concat + bigG pooled projection
    teacher_clip1: Optional[CLIPTextEncoder] = None
    teacher_clip2: Optional[CLIPTextEncoder] = None
    schedule: NoiseScheduleConfig = NoiseScheduleConfig()
    vae_scaling: float = 0.13025
    remat: bool = True
    # how the student forward is recomputed: "full", "dots" or "blocks"
    remat_policy: str = "full"
    # fp32 VAE encode in chunks of this many samples (None: the whole batch)
    vae_encode_chunk: Optional[int] = 2
    # type of the feature-KD terms' elementwise difference: "float32" or
    # "bfloat16"
    feature_tap_dtype: str = "float32"

    def frozen_modules(self) -> Dict[str, nn.Module]:
        mods = {"text_encoder": self.text_encoder, "unet": self.unet, "vae": self.vae,
                "teacher_clip1": self.teacher_clip1, "teacher_clip2": self.teacher_clip2}
        return {k: m for k, m in mods.items() if m is not None}

    def freeze(self) -> "KDModels":
        """Only the adapter trains: everything else loses requires_grad."""
        for m in self.frozen_modules().values():
            m.requires_grad_(False)
        self.adapter.requires_grad_(True)
        return self

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device


def teacher_encode_prompt(models: KDModels, ids1: torch.Tensor,
                          ids2: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SDXL dual-CLIP teacher encoding: the concat of the two towers'
    penultimate states [B, 77, 768 + 1280] and bigG's pooled projection
    [B, 1280]; with one tower (SD1.5), its last state and no pooled."""
    o1 = models.teacher_clip1(ids1)
    if models.teacher_clip2 is None:
        return o1.last_hidden_state, None
    o2 = models.teacher_clip2(ids2)
    seq = torch.cat([o1.penultimate_hidden_state, o2.penultimate_hidden_state], dim=-1)
    return seq, o2.projected


def _masked_mse(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-sample MSE with the elementwise difference in `dtype` and the
    per-sample mean in fp32, non-finite samples dropped, weighted batch
    mean."""
    d = (a.to(dtype) - b.to(dtype)) ** 2
    per = d.float().mean(dim=tuple(range(1, d.ndim)))
    per = torch.where(torch.isfinite(per), per, torch.zeros_like(per))
    return (per * weight).mean()


# The matrix products without batch dimensions: what the "dots" policy saves.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" remat policy: save ``DOTS_SAVED_OPS``' outputs, recompute
    every other op."""
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("full", "dots", "blocks")


def student_forward(models: KDModels, *args):
    """The student UNet forward with feature taps, recomputed in the
    backward as ``models.remat`` and ``models.remat_policy`` say."""
    unet = models.unet
    policy = models.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")
    if not models.remat:
        return unet(*args, capture_features=True)
    if policy == "blocks":
        return unet(*args, capture_features=True, remat_segments=True)

    def fwd(*a):
        return unet(*a, capture_features=True)

    if policy == "dots":
        return checkpoint(fwd, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(dots_policy))
    return checkpoint(fwd, *args, use_reentrant=False)


Rows = Optional[Tuple[int, int]]


def _draw(draws: Dict[str, torch.Tensor], key: str, make: Callable[[int], torch.Tensor],
          b: int, rows: Rows = None):
    """draws[key], else `make(n)` of n rows: the whole micro-batch's, or with
    `rows` = (first, global rows) the global micro-batch's, cut to this
    rank's b rows from `first`."""
    if key not in draws:
        draws[key] = make(b) if rows is None else make(rows[1])[rows[0]:rows[0] + b]
    return draws[key]


def _encode_latents(models: KDModels, pixels: torch.Tensor, draws, gen,
                    rows: Rows = None) -> torch.Tensor:
    """fp32 VAE encode and sample, in chunks of `vae_encode_chunk` where it
    divides a larger batch (the JAX package's condition), else at once."""
    vae = models.vae
    b, h, w, _ = pixels.shape
    f = 2 ** (len(vae.config.block_out_channels) - 1)
    eps = _draw(draws, "vae_eps", lambda n: torch.randn(
        (n, h // f, w // f, vae.config.latent_channels), generator=gen,
        device=pixels.device, dtype=vae.quant_conv.weight.dtype), b, rows)
    chunk = models.vae_encode_chunk
    if chunk is None or b <= chunk or b % chunk:
        chunk = b
    with torch.no_grad():
        return torch.cat([vae.encode_sample(pixels[i:i + chunk], eps=eps[i:i + chunk])
                          for i in range(0, b, chunk)])


def kd_loss(models: KDModels, cfg: TrainConfig, batch: Batch,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None, rows: Rows = None
            ) -> Tuple[torch.Tensor, Metrics]:
    """The KD loss of one micro-batch, differentiable in the adapter.

    batch: pixel_values [B, H, W, 3] in [-1, 1]; input_ids /
    input_ids_uncond [B, T] (and for mul_zh, the Chinese tokenizer's
    input_ids_zh / input_ids_uncond_zh [B, T]); teacher_ids_1 / _2 and
    teacher_uncond_ids_1 / _2 [B, 77]; time_ids [B, 6]; zh_or_not [B] (1 = Chinese-native, 0 =
    parallel English). draws (optional, filled from `generator` where
    absent): vae_eps [B, h, w, 4], noise [B, h, w, 4] and offset_noise
    [B, 1, 1, 4] fp32, timesteps [B] int64, cfg_uniform [B, 1, 1]. rows
    (data parallelism): (this batch's first row in the global micro-batch,
    the global micro-batch's rows); draws made here are the global
    micro-batch's, cut to this batch's rows."""
    draws = {} if draws is None else draws
    unet_dtype = models.unet.conv_in.weight.dtype
    dev = batch["pixel_values"].device
    sched = ddpm.make_schedule(models.schedule)

    # 1. fp32 VAE encode -> scaled latents in the UNet's type
    with span("kd.vae_encode"):
        latents = _encode_latents(models, batch["pixel_values"].float(), draws, generator,
                                  rows)
        latents = (latents * models.vae_scaling).to(unet_dtype)
    b = latents.shape[0]

    # 2. noise + offset noise, timesteps, forward diffusion
    noise = _draw(draws, "noise", lambda n: torch.randn(
        (n,) + latents.shape[1:], generator=generator, device=dev), b, rows)
    offset = _draw(draws, "offset_noise", lambda n: torch.randn(
        (n, 1, 1, latents.shape[-1]), generator=generator, device=dev), b, rows)
    timesteps = _draw(draws, "timesteps", lambda n: torch.randint(
        0, models.schedule.num_train_timesteps, (n,), generator=generator, device=dev),
        b, rows)
    cfg_uniform = _draw(draws, "cfg_uniform", lambda n: torch.rand(
        (n, 1, 1), generator=generator, device=dev), b, rows)
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * offset
    noise = noise.to(unet_dtype)
    noisy = ddpm.add_noise(sched, latents, noise, timesteps).to(unet_dtype)

    # 3. student text encoding (frozen); mul_zh's two tokenizations travel
    # as {"mul", "zh"} dicts
    ids, ids_u = batch["input_ids"], batch["input_ids_uncond"]
    if "input_ids_zh" in batch:
        ids = {"mul": ids, "zh": batch["input_ids_zh"]}
        ids_u = {"mul": ids_u, "zh": batch["input_ids_uncond_zh"]}
    is_sdxl = models.unet.config.addition_embed_type == "text_time"
    with span("kd.student"):
        with torch.no_grad():
            hs = models.text_encoder_fn(ids)
            hs_u = models.text_encoder_fn(ids_u)

        # 4. the adapter, the only forward that carries a gradient
        if is_sdxl:
            pooled, seq = models.adapter(hs)
            _, seq_u = models.adapter(hs_u)
        else:
            seq, seq_u, pooled = models.adapter(hs), models.adapter(hs_u), None

        # 5. CFG dropout: swap the sequence states only (pooled stays)
        drop = cfg_uniform < cfg.cfg_dropout
        seq = torch.where(drop, seq_u, seq)
        added = {"text_embeds": pooled, "time_ids": batch["time_ids"]} if is_sdxl else None

        # 6. student UNet forward with feature taps, recomputed in the
        # backward (outside this span)
        noise_pred, feats_s = student_forward(models, noisy, timesteps, seq, added)

    with span("kd.loss"):
        zh = batch["zh_or_not"].float()
        w_denoise = zh if (cfg.kd and cfg.hybrid_training) else torch.ones_like(zh)
        loss_denoise = _masked_mse(noise_pred, noise, w_denoise)
    metrics = {"train_loss": loss_denoise}
    loss = loss_denoise

    if cfg.kd:
        # 7. teacher: dual-CLIP encode + the same frozen UNet, no gradient
        with span("kd.teacher"), torch.no_grad():
            t_seq, t_pooled = teacher_encode_prompt(
                models, batch["teacher_ids_1"], batch.get("teacher_ids_2"))
            tu_seq, _ = teacher_encode_prompt(
                models, batch["teacher_uncond_ids_1"], batch.get("teacher_uncond_ids_2"))
            t_seq = torch.where(drop, tu_seq, t_seq)  # the student's mask
            t_added = ({"text_embeds": t_pooled, "time_ids": batch["time_ids"]}
                       if is_sdxl else None)
            teacher_pred, feats_t = models.unet(noisy, timesteps, t_seq, t_added,
                                                capture_features=True)

        with span("kd.loss"):
            w_kd = (1.0 - zh) if cfg.hybrid_training else torch.ones_like(zh)
            loss_teacher = _masked_mse(noise_pred, teacher_pred, w_kd)
            tap_dtype = getattr(torch, models.feature_tap_dtype)
            loss_features = sum(_masked_mse(feats_s[k], feats_t[k], w_kd, tap_dtype)
                                for k in sorted(feats_s))
            loss = loss + loss_teacher + cfg.feature_loss_weight * loss_features
        metrics["train_loss_logits"] = loss_teacher
        metrics["train_loss_features"] = loss_features

    metrics["loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def _flatten(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in tensors.values()])


def _unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, t in like.items():
        out[k] = flat[i:i + t.numel()].view(t.shape).to(t.dtype)
        i += t.numel()
    return out


@dataclasses.dataclass
class KDState:
    step: int
    optimizer: dict  # optim.init_state of the adapter's parameters


def make_train_step(models: KDModels, cfg: TrainConfig,
                    data_shard: Tuple[int, int] = (0, 1),
                    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Returns (init_fn, step_fn). step_fn(state, batch, generator, draws=None)
    runs one optimizer step on the adapter, in place, over
    ``cfg.grad_accum_steps`` micro-batches (their fp32 gradients summed and
    divided by the count, their metrics averaged; each draws its own
    randoms, in order, from `generator`, or takes ``draws[i]``), and returns
    (state, metrics) with ``grad_norm``, the pre-clip global norm.

    Data parallelism: `data_shard` = (this rank's index, the number of data
    ranks); `batch` holds the rank's rows of each global micro-batch, whose
    randoms it draws (see kd_loss's `rows`). `reduce` sums a flat fp32
    tensor over the data ranks (one ``all_reduce``): after the accumulation
    loop and before the update it averages the adapter gradient, flattened,
    and the metrics."""
    params = dict(models.adapter.named_parameters())
    mask = optim.decay_mask(models.adapter)

    def init_fn() -> KDState:
        return KDState(step=0, optimizer=optim.init_state(
            {k: p.detach() for k, p in params.items()}))

    def step_fn(state: KDState, batch: Batch, generator: Optional[torch.Generator] = None,
                draws: Optional[List[Dict[str, torch.Tensor]]] = None
                ) -> Tuple[KDState, Metrics]:
        accum = max(1, cfg.grad_accum_steps)
        rows = batch["pixel_values"].shape[0]
        if rows % accum:
            raise ValueError(f"batch rows {rows} not divisible by "
                             f"grad_accum_steps {accum}")
        mb = rows // accum
        for p in params.values():
            p.grad = None
        metrics: List[Metrics] = []
        r, n = data_shard
        rows = None if n == 1 else (r * mb, n * mb)
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, m = kd_loss(models, cfg, part, generator,
                              None if draws is None else draws[i], rows)
            with span("kd.backward"):
                loss.backward()
            metrics.append(m)
        with span("kd.optimizer"):
            grads = {k: p.grad / accum for k, p in params.items()}
            mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
            if reduce is not None:
                grads = _unflatten(reduce(_flatten(grads)) / n, grads)
                mean = _unflatten(reduce(_flatten(mean)) / n, mean)
            mean["grad_norm"] = optim.apply_update(
                cfg, {k: p.data for k, p in params.items()}, grads, state.optimizer, mask)
        for p in params.values():
            p.grad = None
        return KDState(state.step + 1, state.optimizer), mean

    return init_fn, step_fn
