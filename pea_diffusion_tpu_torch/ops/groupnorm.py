"""GroupNorm: the plain fp32 ``group_norm``, and the fused GroupNorm kernels
B6 (``GN(x)`` with an optional SiLU) and B6-b (``GN(x + t)`` with a
per-(sample, channel) bias t, the resnet's time embedding), behind the
opt-in gate ``fused_gn_applicable``.

Port of ``pea_diffusion_tpu/ops/groupnorm.py``. On a CUDA tensor
``group_norm_fwd`` and ``group_norm_bias_fwd`` launch the hand-written
Hopper kernels in ``csrc/groupnorm.cu`` (entry points ``pea_group_norm_fwd``
and ``pea_group_norm_bias_fwd``, replacing the TPU kernels ``_gn_kernel``
and ``_gn_bias_kernel``); on a CPU tensor each runs ``fused_gn_ref``, the
plain version of the same function. Inputs are [N, C, H, W] in either dense
layout: contiguous (a group is one slab of cg*H*W elements) or channels-last
(the TPU kernel's NHWC, and what every GroupNorm of the UNet, ControlNet and
VAE receives: they take NHWC and permute it). Any other strides
are made contiguous by one copy, counted in ``group_norm_fwd.copies``. The
kernels' outputs carry no autograd history: ``fused_group_norm`` takes
inputs that need a gradient through ``FusedGroupNorm`` /
``FusedGroupNormBias``, whose forward is the kernel and whose backward is
the plain version's VJP, recomputed (the JAX package's custom VJP rules are
XLA VJPs of its plain version too).
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Callable, Optional, Tuple

import torch

from . import kernel_build
from .flash_attention import check_no_grad, needs_grad

THREADS = 256         # threads per block of every GroupNorm kernel
TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs
MAX_ROW_VECTORS = 2 * THREADS  # channels-last: vectors of a pixel row a block holds
MAX_GROUP_CHANNELS = 6144      # contiguous: 2 fp32 per channel of a group in 48 KB
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """fp32 GroupNorm over channel-first [N, C, *spatial] input with a
    per-channel affine, in the input's type.

    Two forms of the same one-pass statistics (E[x^2] - E[x]^2), picked by
    batch size as the JAX package picks them: batch <= 2 reduces the
    grouped reshape, batch >= 3 takes per-channel sums and folds the norm
    into one per-channel affine."""
    orig_dtype = x.dtype
    n, c = x.shape[:2]
    g = num_groups
    xf = x.float()
    if n <= 2:
        xg = xf.reshape(n, g, c // g, -1)
        mean = xg.mean(dim=(2, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
        bshape = (1, c) + (1,) * (x.ndim - 2)
        y = y * weight.float().reshape(bshape) + bias.float().reshape(bshape)
        return y.to(orig_dtype)
    spatial = tuple(range(2, x.ndim))
    s1 = xf.sum(dim=spatial)           # [N, C]
    s2 = (xf * xf).sum(dim=spatial)    # [N, C]
    count = math.prod(x.shape[2:]) * (c // g)
    mean = s1.reshape(n, g, c // g).sum(-1) / count   # [N, G]
    var = torch.clamp(s2.reshape(n, g, c // g).sum(-1) / count - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)    # [N, C]
    rstd_c = rstd.repeat_interleave(c // g, dim=1)
    a = rstd_c * weight.float()[None]
    b = bias.float()[None] - mean_c * a
    bshape = (n, c) + (1,) * (x.ndim - 2)
    return (xf * a.reshape(bshape) + b.reshape(bshape)).to(orig_dtype)


def fused_gn_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 groups: int, eps: float = 1e-5, act: str = "none",
                 extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B6 and B6-b (the JAX package's ``_reference_gn``):
    x [N, C, H, W] plus extra_bias [N, C] in x's type, ``group_norm``, then
    SiLU as y * sigmoid(y in fp32) in y's type. The kernels compute the same
    function with every step in fp32 and one rounding at the output."""
    if extra_bias is not None:
        x = x + extra_bias[:, :, None, None].to(x.dtype)
    y = group_norm(x, scale, bias, groups, eps)
    if act == "silu":
        y = y * torch.sigmoid(y.float()).to(y.dtype)
    return y


def fused_gn_applicable(x: torch.Tensor, groups: int) -> bool:
    """Whether ``models.layers.GroupNorm`` takes the fused kernels, checked in
    this order: the opt-in ``PEA_FUSED_GROUPNORM=1`` (read at each call), a
    4-d input, channels divisible by `groups`, and a CUDA tensor (the JAX
    gate's "the backend is a TPU"). The JAX gate's other two tests, 128
    channel lanes and a map that fits VMEM, are the TPU's tiling and are not
    copied: with the opt-in on, every GroupNorm of the UNet, the ControlNet
    and the VAE runs B6 or B6-b on the card."""
    if os.environ.get("PEA_FUSED_GROUPNORM") != "1":
        return False
    if x.ndim != 4 or x.shape[1] % groups:
        return False
    return x.is_cuda


def layout(x: torch.Tensor) -> str:
    """"nchw" for a contiguous [N, C, H, W] tensor, "nhwc" for a
    channels-last one, "strided" for anything else."""
    if x.is_contiguous():
        return "nchw"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "strided"


def vector_width(row: int, elem_size: int, ptr: int) -> int:
    """Elements a thread loads at once: the most of 16 bytes that divides
    the contiguous row (a channel's H*W, or a pixel's C channels) and the
    pointer's alignment."""
    v = 16 // elem_size
    while v > 1 and (row % v or ptr % (v * elem_size)):
        v //= 2
    return v


def plan(n: int, c: int, hw: int, groups: int, nhwc: bool, vec: int) -> int:
    """Chunks each (sample, group) (contiguous) or each sample (channels-last)
    is cut into for the statistics pass: enough blocks to fill the card, but
    each thread at least 4 vectors of work."""
    if nhwc:
        per_row = c // vec
        rows_par = THREADS // per_row if per_row <= THREADS else 1
        return max(1, min(-(-TARGET_BLOCKS // n), hw // (4 * rows_par)))
    per_group = (c // groups) * hw // vec
    return max(1, min(-(-TARGET_BLOCKS // (n * groups)), -(-per_group // (4 * THREADS))))


# pea_group_norm_fwd(x, scale, bias, y, scratch, n, c, hw, groups, chunks, eps, silu,
#                    channels_last, vec, dtype, scale_f32, bias_f32, device, stream);
# pea_group_norm_bias_fwd takes t after x and t_f32 after bias_f32
_INTS = [ctypes.c_int] * 5
_TAIL = [ctypes.c_float] + [ctypes.c_int] * 4
_ARGTYPES = [ctypes.c_void_p] * 5 + _INTS + _TAIL + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BIAS_ARGTYPES = ([ctypes.c_void_p] * 6 + _INTS + _TAIL + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def _param(p: torch.Tensor, x: torch.Tensor, shape: Tuple[int, ...], what: str):
    """A weight, bias or t as the kernel takes it: contiguous on x's device,
    in fp32 or x's type (another type is cast to fp32). Returns (tensor,
    its fp32 flag)."""
    if tuple(p.shape) != shape or p.device != x.device:
        raise ValueError(f"group norm kernel: {what} {tuple(p.shape)} on {p.device}, "
                         f"want {shape} on {x.device}")
    if p.dtype not in (torch.float32, x.dtype):
        p = p.float()
    return p.contiguous(), int(p.dtype == torch.float32)


def _launch(name: str, x: torch.Tensor, t: Optional[torch.Tensor], scale: torch.Tensor,
            bias: torch.Tensor, groups: int, eps: float, act: str) -> torch.Tensor:
    """Checks the inputs and launches B6 (t None) or B6-b on x's layout."""
    if x.ndim != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"group norm kernel: x {tuple(x.shape)} {x.dtype} "
                        "(takes 4-d bfloat16, float16 or float32)")
    if act not in ("none", "silu"):
        raise ValueError(f"group norm kernel: act {act!r}")
    n, c, h, w = x.shape
    if groups < 1 or c % groups or x.numel() == 0:
        raise ValueError(f"group norm kernel: {c} channels in {groups} groups")
    if c // groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"group norm kernel: {c // groups} channels per group "
                         f"(takes up to {MAX_GROUP_CHANNELS})")
    nhwc = layout(x) == "nhwc"
    vec = vector_width(c if nhwc else h * w, x.element_size(), x.data_ptr())
    if layout(x) == "strided" or (nhwc and c // vec > MAX_ROW_VECTORS):
        x = x.contiguous()
        group_norm_fwd.copies += 1
        nhwc = False
        vec = vector_width(h * w, x.element_size(), x.data_ptr())
    chunks = plan(n, c, h * w, groups, nhwc, vec)
    scale, scale_f32 = _param(scale, x, (c,), "weight")
    bias, bias_f32 = _param(bias, x, (c,), "bias")
    y = torch.empty_like(x, memory_format=torch.channels_last if nhwc
                         else torch.contiguous_format)
    scratch = torch.empty(n * groups * (chunks + 1) * 2, dtype=torch.float32,
                          device=x.device)
    head = [x.data_ptr()]
    flags = [scale_f32, bias_f32]
    argtypes = _ARGTYPES
    if t is not None:
        t, t_f32 = _param(t, x, (n, c), "t")
        head.append(t.data_ptr())
        flags.append(t_f32)
        argtypes = _BIAS_ARGTYPES
    kernel_build.launch(name, argtypes, *head, scale.data_ptr(), bias.data_ptr(),
                        y.data_ptr(), scratch.data_ptr(), n, c, h * w, groups, chunks,
                        eps, int(act == "silu"), int(nhwc), vec, _DTYPES[x.dtype],
                        *flags, x.device.index, kernel_build.stream_of(x))
    return y


def group_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """B6: GN(x) with an optional SiLU, x [N, C, H, W] -> the same shape,
    type and layout. CUDA tensors launch the Hopper kernel and count it in
    ``group_norm_fwd.launches``; CPU tensors run ``fused_gn_ref``."""
    if not x.is_cuda:
        return fused_gn_ref(x, scale, bias, groups, eps, act)
    check_no_grad("group_norm_fwd", x, scale, bias, instead="fused_group_norm")
    y = _launch("pea_group_norm_fwd", x, None, scale, bias, groups, eps, act)
    group_norm_fwd.launches += 1
    return y


group_norm_fwd.launches = 0
group_norm_fwd.copies = 0


def group_norm_bias_fwd(x: torch.Tensor, t: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int, eps: float = 1e-5,
                        act: str = "none") -> torch.Tensor:
    """B6-b: GN(x + t) with t [N, C] and an optional SiLU. CUDA tensors
    launch the Hopper kernel and count it in ``group_norm_bias_fwd.launches``
    (t is added in fp32 as x is read, never stored); CPU tensors run
    ``fused_gn_ref``."""
    if not x.is_cuda:
        return fused_gn_ref(x, scale, bias, groups, eps, act, extra_bias=t)
    check_no_grad("group_norm_bias_fwd", x, t, scale, bias, instead="fused_group_norm")
    y = _launch("pea_group_norm_bias_fwd", x, t, scale, bias, groups, eps, act)
    group_norm_bias_fwd.launches += 1
    return y


group_norm_bias_fwd.launches = 0


def _recomputed_vjp(ctx, g: torch.Tensor, ref: Callable[..., torch.Tensor]):
    """The gradients of `ref` over ctx's saved inputs, recomputed: each input
    autograd asked for gets its gradient, the others None."""
    saved = ctx.saved_tensors  # once: under checkpointing each read unpacks anew
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [s.detach().requires_grad_(need) for s, need in zip(saved, needs)]
        wrt = [s for s in inputs if s.requires_grad]
        grads = iter(torch.autograd.grad(ref(*inputs), wrt, g))
    return tuple(next(grads) if need else None for need in needs)


class FusedGroupNorm(torch.autograd.Function):
    """B6 under autograd (``_fused_gn_vjp``): the kernel forward, the plain
    version's VJP as backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (groups, eps, act)
        return group_norm_fwd(x, scale, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        groups, eps, act = ctx.cfg
        grads = _recomputed_vjp(
            ctx, g, lambda x, s, b: fused_gn_ref(x, s, b, groups, eps, act))
        return grads + (None, None, None)


class FusedGroupNormBias(torch.autograd.Function):
    """B6-b under autograd (``_fused_gnb_vjp``): gradients in x, t, scale
    and bias from the plain version's VJP."""

    @staticmethod
    def forward(ctx, x, t, scale, bias, groups, eps, act):
        ctx.save_for_backward(x, t, scale, bias)
        ctx.cfg = (groups, eps, act)
        return group_norm_bias_fwd(x, t, scale, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        groups, eps, act = ctx.cfg
        grads = _recomputed_vjp(
            ctx, g, lambda x, t, s, b: fused_gn_ref(x, s, b, groups, eps, act, t))
        return grads + (None, None, None)


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, act: str = "none",
                     extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GN(x [+ extra_bias]) [+ SiLU] on [N, C, H, W] in one kernel: the bare
    wrapper when no input needs a gradient, the autograd Function when one
    does."""
    if extra_bias is None:
        if needs_grad(x, scale, bias):
            return FusedGroupNorm.apply(x, scale, bias, groups, eps, act)
        return group_norm_fwd(x, scale, bias, groups, eps, act)
    if needs_grad(x, extra_bias, scale, bias):
        return FusedGroupNormBias.apply(x, extra_bias, scale, bias, groups, eps, act)
    return group_norm_bias_fwd(x, extra_bias, scale, bias, groups, eps, act)
