"""Int8 post-training quantization of the UNet's and the VAE decoder's
convolutions (port of ``pea_diffusion_tpu/quant/int8.py``).

Scheme (the JAX package's, unchanged):

- weights: symmetric per output channel (`w_scale[cout]`), computed
  offline from the float checkpoint;
- activations: symmetric per tensor with a static per-layer scale from a
  calibration pass over the float model (`calibrate_conv_ranges`: max |x|
  at each in-scope conv's input);
- scope: `conv_quant` is "none", "int8" (= "int8:resnet") or
  "int8:<scopes>" with scopes from {resnet, shortcut, sampler, stem, vae}:
  resnet the resnets' 3x3 conv1/conv2, shortcut their 1x1 channel-matching
  conv, sampler the Downsample/Upsample 3x3, stem the UNet's conv_in, vae
  the VAE decoder's resnet, shortcut and upsampler convs (its conv_in,
  conv_out, mid attention and the whole encoder stay float). The UNet's
  conv_out, every attention and every linear layer stay float.

The quantized model is the same module tree built with `conv_quant`: each
in-scope ``nn.Conv2d`` becomes a `QConvInt8` whose state is {kernel_q int8
[cout, cin, kh, kw], w_scale fp32 [cout], x_scale fp32 [], bias fp32
[cout]}. `quantize_unet_params` maps a float state dict (and calibration
ranges) into that layout.

The int8 x int8 -> int32 product (`int8_conv`) is ``torch._int_mm`` over
an im2col of the int8 codes, built from shifted slices of the padded map
(``F.unfold`` takes no int8). It is exact, on the CPU and on the card; the
JAX package computes the same product in XLA, outside any Pallas kernel.
On the card ``_int_mm`` needs more than 16 rows and K and N that are
multiples of 8: K is padded with zero codes (the stem's K = 9 * 4 = 36), N
with zero output channels and the rows with zero rows, each cut off after.
`int8_conv_plain` is the same convolution in float64 over the codes: exact,
since every sum stays far below 2^53 (and the int32 one below 2^31: 127^2 *
9 * 1280 ~ 1.9e8 at SDXL's widest conv).

Range keys are the JAX package's (``"down_0_resnet_0/conv1"``, the last two
parts of its module path), not the port's module names, so a ranges file
written by either package loads in the other: `jax_module_path` maps the
port's diffusers module names to the JAX package's. Calibration taps the
float model with forward pre-hooks under ``torch.inference_mode()``.

The speedups the JAX package's docstring quotes were measured on a TPU v5e;
the card's own times of this path are in PERF.md.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8

SCOPES = ("resnet", "shortcut", "sampler", "stem", "vae")

# sub-scopes applied to the VAE decoder under the "vae" scope (its conv_in
# [cin = 4] and conv_out stay float, as the UNet's do)
VAE_DECODER_SCOPES = frozenset({"resnet", "shortcut", "sampler"})
VAE_DECODER_CONV_QUANT = "int8:resnet,sampler,shortcut"

_RESNET_SCOPE = frozenset({"resnet"})


def parse_scopes(conv_quant: str) -> frozenset:
    """'none' -> {}; 'int8' -> {resnet}; 'int8:a,b' -> {a, b}. Raises
    ValueError on any other form or an unknown scope."""
    if not conv_quant or conv_quant == "none":
        return frozenset()
    if conv_quant == "int8":
        return frozenset({"resnet"})
    if not conv_quant.startswith("int8:"):
        raise ValueError(f"conv_quant must be 'none', 'int8' or 'int8:<scopes>', "
                         f"not {conv_quant!r}")
    scopes = frozenset(s for s in conv_quant[5:].split(",") if s)
    unknown = scopes - set(SCOPES)
    if unknown:
        raise ValueError(f"unknown int8 scopes {sorted(unknown)} (known: {list(SCOPES)})")
    return scopes


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[cout, cin, kh, kw] float -> (int8 codes, fp32 w_scale [cout])."""
    k = weight.float()
    amax = k.abs().amax(dim=(1, 2, 3))
    w_scale = torch.clamp(amax, min=_EPS) / 127.0
    kq = torch.clamp(torch.round(k / w_scale[:, None, None, None]), -127, 127)
    return kq.to(torch.int8), w_scale


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """Static-scale symmetric quantize: clip(round(x / x_scale)) in int8."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


def _padding(kh: int, kw: int):
    """The JAX package's conv padding ((kh - 1) // 2, kh // 2) per side."""
    return (kh - 1) // 2, kh // 2, (kw - 1) // 2, kw // 2


def _out_side(n: int, s: int) -> int:
    """The output side of a conv padded by k - 1 in all, at stride s."""
    return (n - 1) // s + 1


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """The int8 convolution's exact int32 result: xq [B, cin, H, W] int8
    (any memory format), kernel_q [cout, cin, kh, kw] int8 -> [B, Ho, Wo,
    cout] int32 (NHWC), with the JAX package's padding. ``torch._int_mm``
    over an im2col whose columns run (kh, kw, cin)."""
    b, c, h, w = xq.shape
    cout, cin, kh, kw = kernel_q.shape
    if cin != c:
        raise ValueError(f"int8_conv: input has {c} channels, the kernel {cin}")
    sh, sw = stride
    ph0, ph1, pw0, pw1 = _padding(kh, kw)
    ho, wo = _out_side(h, sh), _out_side(w, sw)
    x = xq.permute(0, 2, 3, 1)  # NHWC: free for a channels-last map
    if ph0 or ph1 or pw0 or pw1:
        padded = x.new_zeros((b, h + ph0 + ph1, w + pw0 + pw1, c))
        padded[:, ph0:ph0 + h, pw0:pw0 + w] = x
    else:
        padded = x
    k = kh * kw * c
    kp, n = _round_up(k, 8), _round_up(cout, 8)
    rows = b * ho * wo
    mp = max(rows, 17)  # the card's _int_mm takes more than 16 rows
    cols = xq.new_empty((mp, kp))
    if kp > k:
        cols[:, k:] = 0
    if mp > rows:
        cols[rows:] = 0
    view = cols[:rows].view(b, ho, wo, kp)
    for i in range(kh):
        for j in range(kw):
            t = (i * kw + j) * c
            view[..., t:t + c] = padded[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
    wmat = kernel_q.new_zeros((n, kp))
    wmat[:cout, :k] = kernel_q.permute(0, 2, 3, 1).reshape(cout, k)
    y = torch._int_mm(cols, wmat.t())
    return y[:rows, :cout].reshape(b, ho, wo, cout)


def int8_conv_plain(xq: torch.Tensor, kernel_q: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """`int8_conv`'s plain version: the same convolution in float64 over the
    codes (exact), [B, Ho, Wo, cout] float64."""
    kh, kw = kernel_q.shape[2:]
    ph0, ph1, pw0, pw1 = _padding(kh, kw)
    x = F.pad(xq.double(), (pw0, pw1, ph0, ph1))
    return F.conv2d(x, kernel_q.double(), stride=tuple(stride)).permute(0, 2, 3, 1)


class QConvInt8(nn.Module):
    """Drop-in for an in-scope ``nn.Conv2d`` (NCHW in and out): static-scale
    activation quantize -> int8 convolution with int32 sums -> per-channel
    dequantize + bias, in the input's type. Its state is buffers, which
    nothing trains; the float ones stay fp32 whatever type the model is
    moved to. `quantize_unet_params` fills them; a new one holds zero codes,
    scales of 1 and a zero bias (the JAX package's init)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        self.stride = (stride, stride)
        k = kernel_size
        self.register_buffer("kernel_q", torch.zeros(out_channels, in_channels, k, k,
                                                     dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_channels))
        self.register_buffer("x_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(out_channels))

    def reset_buffers(self):
        """The JAX package's init: zero codes, scales of 1, zero bias."""
        with torch.no_grad():
            self.kernel_q.zero_()
            self.w_scale.fill_(1.0)
            self.x_scale.fill_(1.0)
            self.bias.zero_()

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name in ("w_scale", "x_scale", "bias"):
            if self._buffers[name].dtype != torch.float32:
                self._buffers[name] = self._buffers[name].float()
        return self

    def dequantized(self, x: torch.Tensor) -> torch.Tensor:
        """The dequantized product without the bias, [B, Ho, Wo, cout] fp32
        (under tensor parallelism, an input-sharded conv's partial sum)."""
        xq = quantize_activation(x, self.x_scale)
        y = int8_conv(xq, self.kernel_q, self.stride)
        return y.float() * (self.x_scale * self.w_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dequantized(x) + self.bias
        return out.permute(0, 3, 1, 2).to(x.dtype)


def make_conv(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
              quantized: bool = False) -> nn.Module:
    """A float ``nn.Conv2d`` with the JAX package's padding, or its
    `QConvInt8` counterpart."""
    if quantized:
        return QConvInt8(in_channels, out_channels, kernel_size, stride)
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=kernel_size // 2)


# --- module names and range keys ----------------------------------------------

_BLOCK = re.compile(r"^(down|up)_blocks\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)"
                    r"\.(\d+)(?:\.(.*))?$")
_MID = re.compile(r"^mid_block\.(resnets|attentions)\.(\d+)(?:\.(.*))?$")
_SAMPLER = {"downsamplers": "downsample", "upsamplers": "upsample"}


def jax_module_path(name: str, vae: bool = False) -> Tuple[str, ...]:
    """The JAX package's module path of the port's module `name`, named
    from the root of a UNet or (`vae`) of a VAE decoder: down_blocks.1.
    resnets.0.conv1 -> (down_1_resnet_0, conv1); the UNet's mid_block.
    resnets.1 -> (mid_resnet_1,), the decoder's -> (mid, resnet_1)."""
    m = _BLOCK.match(name)
    if m:
        kind, i, part, j, rest = m.groups()
        rest = tuple(rest.split(".")) if rest else ()
        if part in _SAMPLER:
            return (f"{kind}_{i}_{_SAMPLER[part]}",) + rest
        return (f"{kind}_{i}_{'resnet' if part == 'resnets' else 'attn'}_{j}",) + rest
    m = _MID.match(name)
    if m:
        part, j, rest = m.groups()
        rest = tuple(rest.split(".")) if rest else ()
        base = f"resnet_{j}" if part == "resnets" else "attn"
        return (("mid", base) if vae else (f"mid_{base}",)) + rest
    return tuple(name.split(".")) if name else ()


def _is_target_conv(path: Tuple[str, ...], scopes: frozenset = _RESNET_SCOPE) -> bool:
    """Scope membership of one conv by its JAX module path. conv_out is
    never a target."""
    if not path:
        return False
    parent = path[-2] if len(path) >= 2 else ""
    leaf = path[-1]
    if "resnet" in parent:
        if leaf in ("conv1", "conv2"):
            return "resnet" in scopes
        if leaf == "conv_shortcut":
            return "shortcut" in scopes
    if "sampler" in scopes:
        if leaf == "conv" and ("downsample" in parent or "upsample" in parent):
            return True
    if "stem" in scopes and leaf == "conv_in":
        return True
    return False


def _range_key(path: Tuple[str, ...]) -> str:
    """The ranges' key of a conv: the last two parts of its JAX module path
    (the JAX package's `params` prefix dropped)."""
    p = tuple(x for x in path if x != "params")
    return "/".join(p[-2:])


def _target_convs(root: nn.Module, scopes: frozenset, vae: bool = False
                  ) -> Dict[nn.Module, str]:
    """{float conv module: range key} of `root`'s in-scope convs."""
    out = {}
    for name, m in root.named_modules():
        if isinstance(m, nn.Conv2d):
            path = jax_module_path(name, vae)
            if _is_target_conv(path, scopes):
                out[m] = _range_key(path)
    return out


# --- calibration ---------------------------------------------------------------


def merge_ranges(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(float(out[k]), float(v)) if k in out else float(v)
    return out


def _record_ranges(convs: Dict[nn.Module, str], run, batches: Iterable) -> Dict[str, float]:
    """max |input| of each conv in `convs` over `run(batch)` for each batch."""
    records: Dict[str, torch.Tensor] = {}

    def hook(module, args):
        amax = args[0].float().abs().amax()
        key = convs[module]
        records[key] = amax if key not in records else torch.maximum(records[key], amax)

    handles = [m.register_forward_pre_hook(hook) for m in convs]
    out: Dict[str, float] = {}
    try:
        with torch.inference_mode():
            for batch in batches:
                records.clear()
                run(batch)
                out = merge_ranges(out, {k: v.item() for k, v in records.items()})
    finally:
        for h in handles:
            h.remove()
    return out


def calibrate_conv_ranges(unet: nn.Module, batches: Sequence[tuple],
                          scopes: frozenset = _RESNET_SCOPE) -> Dict[str, float]:
    """Runs the float UNet over (sample, t, context, added) batches and
    returns {"down_0_resnet_0/conv1": max |input|, ...} over all of them."""
    convs = _target_convs(unet, scopes)
    out = _record_ranges(convs, lambda args: unet(*args), batches)
    if not out:
        raise ValueError("calibration saw no in-scope convs: wrong model or scopes? "
                         f"scopes={sorted(scopes)}")
    return out


def calibrate_sdxl(models, ids, uncond_ids, size: int,
                   timesteps: Sequence[int] = (999, 749, 499, 249, 49), seed: int = 0,
                   scopes: frozenset = _RESNET_SCOPE, draws=None) -> Dict[str, float]:
    """Calibrates the SDXL UNet of `models` (the float build) on the
    prompt's CFG-pair conditioning ([uncond; cond], as generate_sdxl serves
    it) at a spread of timesteps, over unit-Gaussian latents (the forward
    process is variance-preserving): one draw per timestep from a
    ``torch.Generator`` seeded with `seed`, or `draws[i]` when given (a
    test passes the JAX package's)."""
    from ..pipelines.text2image import as_ids, encode_prompt_sdxl, make_add_time_ids

    dev = models.device
    with torch.inference_mode():
        context, text_embeds = encode_prompt_sdxl(models, as_ids(ids, dev),
                                                  as_ids(uncond_ids, dev))
    b2 = context.shape[0]
    added = {"text_embeds": text_embeds,
             "time_ids": make_add_time_ids((size, size), (0, 0), (size, size), b2, dev)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b2, size // 8, size // 8, models.unet.config.in_channels)
    batches = []
    for i, t in enumerate(timesteps):
        if draws is not None:
            lat = torch.tensor(np.asarray(draws[i], np.float32), device=dev)
        else:
            lat = torch.randn(shape, generator=gen, device=dev)
        batches.append((lat.to(context.dtype), torch.full((b2,), int(t), device=dev),
                        context, added))
    return calibrate_conv_ranges(models.unet, batches, scopes)


def calibrate_vae_decoder(vae: nn.Module, z_batches: Sequence[torch.Tensor]
                          ) -> Dict[str, float]:
    """Calibrates the VAE decoder's in-scope convs (VAE_DECODER_SCOPES) over
    post-scaling latents `z` [B, h, w, 4] (what decode_latents feeds
    ``vae.decode``), keyed as `calibrate_conv_ranges` keys the UNet's."""
    convs = _target_convs(vae.decoder, VAE_DECODER_SCOPES, vae=True)
    out = _record_ranges(convs, vae.decode, z_batches)
    if not out:
        raise ValueError("VAE decoder calibration saw no in-scope convs")
    return out


def vae_calibration_latents(models, size: int, draws=None):
    """The VAE decoder's calibration inputs: two unit-Gaussian latents
    [1, size/8, size/8, 4] (seeds 0 and 1, or `draws` when given) over the
    VAE's scaling factor, as decode_latents feeds the decoder."""
    dev = models.device
    cin = models.vae.config.latent_channels
    shape = (1, size // 8, size // 8, cin)
    if draws is None:
        draws = [torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(s),
                             device=dev) for s in range(2)]
    else:
        draws = [torch.tensor(np.asarray(d, np.float32), device=dev) for d in draws]
    return [d / models.vae_scaling for d in draws]


# --- state-dict transform -------------------------------------------------------


def _quantize_state_dict(state_dict, ranges: Optional[Dict[str, float]],
                         default_amax: float, scopes: frozenset, vae: bool,
                         prefix: str = ""):
    calibrated = ranges is not None
    ranges = ranges or {}
    missing = []
    out = {}
    for key, value in state_dict.items():
        name = key[len(prefix):-len(".weight")] if key.endswith(".weight") else None
        if key.startswith(prefix) and name is not None and value.ndim == 4:
            path = jax_module_path(name, vae)
            if _is_target_conv(path, scopes):
                kq, w_scale = quantize_weight(value)
                rkey = _range_key(path)
                if rkey not in ranges:
                    missing.append(rkey)
                amax = float(ranges.get(rkey, default_amax))
                pre = f"{prefix}{name}"
                out[f"{pre}.kernel_q"] = kq
                out[f"{pre}.w_scale"] = w_scale
                out[f"{pre}.x_scale"] = torch.tensor(max(amax, _EPS) / 127.0,
                                                     dtype=torch.float32, device=value.device)
                out[f"{pre}.bias"] = state_dict[f"{pre}.bias"].float()
                continue
        out.setdefault(key, value)
    if missing and calibrated:
        print(f"[int8] WARNING: {len(missing)} in-scope convs missing "
              f"from calibration ranges (using default_amax="
              f"{default_amax}): {missing[:5]}{'...' if len(missing) > 5 else ''}")
    return out


def quantize_unet_params(state_dict, ranges: Optional[Dict[str, float]],
                         default_amax: float = 1.0, scopes: frozenset = _RESNET_SCOPE):
    """A float UNet state dict -> the state dict of the UNet built with
    `conv_quant` over `scopes`: each in-scope conv's weight and bias become
    kernel_q, w_scale, x_scale and bias; every other tensor passes through.

    `ranges` comes from `calibrate_conv_ranges`; an in-scope conv missing
    from it takes `default_amax`. `ranges=None` means uncalibrated on
    purpose and stays silent; a provided dict, even an empty one, warns
    for every miss."""
    return _quantize_state_dict(state_dict, ranges, default_amax, scopes, vae=False)


def quantize_vae_decoder_params(state_dict, ranges: Optional[Dict[str, float]],
                                default_amax: float = 1.0):
    """An AutoencoderKL float state dict -> the decoder's in-scope convs
    (VAE_DECODER_SCOPES) in `QConvInt8`'s layout; the encoder, quant_conv
    and post_quant_conv pass through."""
    return _quantize_state_dict(state_dict, ranges, default_amax, VAE_DECODER_SCOPES,
                                vae=True, prefix="decoder.")


def save_ranges(path: str, ranges: Dict[str, float]) -> None:
    """Writes the calibration ranges as JSON (written to a temporary file
    and renamed, so a reader never sees half of it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(ranges, f, indent=0, sort_keys=True)
    os.replace(tmp, path)


def load_ranges(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def _rebuild(make, state_dict) -> nn.Module:
    """`make()` built on the meta device and given `state_dict`'s tensors
    (assigned, not copied: the float module's untouched tensors are shared),
    for inference."""
    with torch.device("meta"):
        new = make()
    new.load_state_dict(state_dict, strict=True, assign=True)
    return new.eval().requires_grad_(False)


def quantize_for_serving(models, ids, uncond_ids, size: int,
                         ranges_path: Optional[str] = None, conv_quant: str = "int8",
                         draws=None, vae_draws=None):
    """Calibrates and quantizes one PEAModels bundle for int8 serving;
    returns the bundle with its UNet (and, under the "vae" scope, its VAE)
    rebuilt with `conv_quant` and the quantized weights. The rebuilt
    modules share every tensor the quantization leaves alone with the float
    ones, so no second float UNet is made.

    `ranges_path`: if the file exists, calibration is skipped and its
    ranges are used (it must hold the requested scopes' keys: a cache
    without UNet ranges, or without vae:: ranges under the "vae" scope, is
    refused); otherwise the fresh ranges are written there. `draws` /
    `vae_draws` as `calibrate_sdxl` / `vae_calibration_latents` take them."""
    from ..models.unet import UNet2DCondition
    from ..models.vae import AutoencoderKL

    scopes = parse_scopes(conv_quant)
    if not scopes:
        raise ValueError(f"quantize_for_serving needs an int8 scope, not {conv_quant!r}")
    unet_scopes = scopes - {"vae"}
    quant_vae = "vae" in scopes
    if ranges_path and os.path.exists(ranges_path):
        saved = load_ranges(ranges_path)
        ranges = {k: v for k, v in saved.items() if not k.startswith("vae::")}
        vae_ranges = {k[len("vae::"):]: v for k, v in saved.items() if k.startswith("vae::")}
        if unet_scopes and not ranges:
            raise ValueError(
                f"{ranges_path} contains no UNet conv ranges but scope "
                f"{sorted(unet_scopes)} was requested — stale cache? "
                f"Delete it to recalibrate.")
        if quant_vae and not vae_ranges:
            raise ValueError(
                f"{ranges_path} contains no vae:: ranges but the 'vae' "
                f"scope was requested — stale cache? Delete it to "
                f"recalibrate.")
    else:
        ranges = (calibrate_sdxl(models, ids, uncond_ids, size, scopes=unet_scopes, draws=draws)
                  if unet_scopes else {})
        vae_ranges = {}
        if quant_vae:
            vae_ranges = calibrate_vae_decoder(
                models.vae, vae_calibration_latents(models, size, vae_draws))
        if ranges_path:
            save_ranges(ranges_path, {**ranges,
                                      **{f"vae::{k}": v for k, v in vae_ranges.items()}})
    unet, vae = models.unet, models.vae
    if unet_scopes:
        quant = "int8:" + ",".join(sorted(unet_scopes))
        sd = quantize_unet_params(unet.state_dict(), ranges, scopes=unet_scopes)
        unet = _rebuild(lambda: UNet2DCondition(unet.config, unet.attn_backend, quant), sd)
    if quant_vae:
        sd = quantize_vae_decoder_params(vae.state_dict(), vae_ranges)
        vae = _rebuild(lambda: AutoencoderKL(vae.config, VAE_DECODER_CONV_QUANT), sd)
    return dataclasses.replace(models, unet=unet, vae=vae)


# --- quality analysis ------------------------------------------------------------


def per_conv_sqnr(unet: nn.Module, batches: Sequence[tuple], ranges: Dict[str, float],
                  scopes: frozenset = _RESNET_SCOPE) -> Dict[str, float]:
    """Each in-scope conv's own quantization noise: its float input goes
    through the float conv and the int8 one (the static x_scale serving
    uses), and SQNR = 10 log10(||y||^2 / ||y - y_q||^2) in dB, the worst
    over `batches`. The float trajectory is never perturbed."""
    convs = _target_convs(unet, scopes)
    worst: Dict[str, float] = {}
    records: Dict[str, float] = {}

    def hook(module, args, y):
        key = convs[module]
        x = args[0]
        kq, w_scale = quantize_weight(module.weight)
        x_scale = torch.tensor(max(float(ranges.get(key, 1.0)), _EPS) / 127.0,
                               dtype=torch.float32, device=x.device)
        yq = int8_conv(quantize_activation(x, x_scale), kq, module.stride)
        yq = (yq.float() * (x_scale * w_scale) + module.bias.float()).permute(0, 3, 1, 2)
        yf = y.double()
        num = (yf * yf).sum()
        den = ((yf - yq.double()) ** 2).sum() + _EPS
        records[key] = (10.0 * torch.log10(num / den)).item()

    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.inference_mode():
            for args in batches:
                records.clear()
                unet(*args)
                for k, v in records.items():
                    worst[k] = min(worst.get(k, float("inf")), v)
    finally:
        for h in handles:
            h.remove()
    if not worst:
        raise ValueError(f"no in-scope convs found, scopes={sorted(scopes)}")
    return worst
