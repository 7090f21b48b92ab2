"""GroupNorm: the plain fp32 ``group_norm``, and the fused GroupNorm kernels
B6 (``GN(x)`` with an optional SiLU) and B6-b (``GN(x + t)`` with a
per-(sample, channel) bias t, the resnet's time embedding), with the route
between them, ``fused_gn_applicable``.

Route (``models.layers.GroupNorm``, read at each call). A CUDA tensor takes
the kernels wherever no input (x, the weight, the bias, t) needs a gradient:
serving under ``torch.inference_mode()``, the KD step's VAE encode and
teacher under ``torch.no_grad()``, and a frozen UNet's norms before the
first input that carries one. The norms that carry a gradient take the
plain form, ``group_norm_act``, whose backward is autograd's.
``PEA_FUSED_GROUPNORM`` has three states: unset (or any value other than
``0`` and ``1``), the route above; ``1``, the kernels under autograd too,
through ``FusedGroupNorm`` / ``FusedGroupNormBias``; ``0``, the plain form
everywhere. A CPU tensor always takes the plain form. On a CUDA tensor the
kernel route launches or raises: it never falls back.

Port of ``pea_diffusion_tpu/ops/groupnorm.py``. On a CUDA tensor
``group_norm_fwd`` and ``group_norm_bias_fwd`` launch the hand-written
Hopper kernels behind ``csrc/groupnorm.cu``'s entry points
``pea_group_norm_fwd`` and ``pea_group_norm_bias_fwd`` (replacing the TPU
kernels ``_gn_kernel`` and ``_gn_bias_kernel``) in the variant the library's
rule ships for the shape (``shipped_gn_variant``): ``persistent``
(``csrc/groupnorm_sm90.cu``, one cooperative launch, the map kept in
shared memory where it fits, planned by ``persistent_plan``) or
``three_pass`` (statistics, finalize, apply).
``group_norm_variant`` runs either by name. On a CPU tensor each runs
``fused_gn_ref``, the plain version of the same function. Inputs are [N, C,
H, W] in either dense layout: contiguous (a group is one slab of cg*H*W
elements) or channels-last (the TPU kernel's NHWC, and what every GroupNorm
of the UNet, ControlNet and VAE receives: they take NHWC and permute it).
Any other strides are made contiguous by one copy, counted in
``group_norm_fwd.copies``. The kernels' outputs carry no autograd history:
``fused_group_norm`` takes inputs that need a gradient through
``FusedGroupNorm`` / ``FusedGroupNormBias``, whose forward is the kernel and
whose backward is the plain version's VJP, recomputed (the JAX package's
custom VJP rules are XLA VJPs of its plain version too).
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernel_build
from .flash_attention import check_no_grad, needs_grad

THREADS = 256         # threads per block of every GroupNorm kernel
TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the H100's 132 SMs
MAX_ROW_VECTORS = 2 * THREADS  # channels-last: vectors of a pixel row a block holds
MAX_GROUP_CHANNELS = 6144      # contiguous: 2 fp32 per channel of a group in 48 KB
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
GN_VARIANTS = ("three_pass", "persistent")  # csrc/groupnorm.cu, kGnVariants

# The persistent variant (csrc/groupnorm_sm90.cu): one block of P_THREADS
# threads a SM, each thread owning one vector of a row (so at most
# P_THREADS vectors a row) and up to MAX_GROUPS groups, a ring of up to
# MAX_SLOTS tiles in TILE_BUDGET bytes of shared memory beside the fixed
# SMEM_FIXED (the fold buffer of RED_FLOATS and the mbarriers), in the
# card's SMEM_MAX a block; tiles of about TILE_TARGET bytes.
P_THREADS = 512
RED_FLOATS = 2048
MAX_GROUPS = RED_FLOATS // 2
MAX_SLOTS = 32
SMEM_MAX = 227 * 1024
SMEM_FIXED = RED_FLOATS * 4 + MAX_SLOTS * 8
TILE_BUDGET = 216 * 1024
TILE_TARGET = 32 * 1024


def group_norm_grouped(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       num_groups: int, eps: float) -> torch.Tensor:
    """``group_norm``'s grouped-reshape form: the statistics of each group's
    [C/G, *spatial] slab, then the norm and the affine (the JAX package's
    ``group_norm_grouped``)."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, num_groups, c // num_groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.ndim - 2)
    y = y * weight.float().reshape(bshape) + bias.float().reshape(bshape)
    return y.to(x.dtype)


def group_norm_sums(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float) -> torch.Tensor:
    """``group_norm``'s per-channel-sums form: [N, C] sums of x and x^2,
    group statistics from them, and the norm folded into one per-channel
    affine."""
    n, c = x.shape[:2]
    g = num_groups
    xf = x.float()
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
    return (xf * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """fp32 GroupNorm over channel-first [N, C, *spatial] input with a
    per-channel affine, in the input's type.

    Two forms of the same one-pass statistics (E[x^2] - E[x]^2), picked as
    the JAX package picks them: ``PEA_GN_GROUPED=1`` pins
    ``group_norm_grouped`` and ``=0`` ``group_norm_sums`` (read at each call;
    the way to pin batch-invariant bits), and otherwise batch <= 2 takes the
    grouped form, batch >= 3 the sums. The knob acts on this plain form
    only, never on the kernels."""
    knob = os.environ.get("PEA_GN_GROUPED")
    if knob == "1" or (knob != "0" and x.shape[0] <= 2):
        return group_norm_grouped(x, weight, bias, num_groups, eps)
    return group_norm_sums(x, weight, bias, num_groups, eps)


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


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: str = "none",
                   extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain route of ``models.layers.GroupNorm``: x plus extra_bias [N,
    C] in x's type, ``group_norm``, then SiLU. Counts its calls on CUDA
    tensors in ``group_norm_act.cuda_calls``, beside the kernels'
    ``launches``."""
    if x.is_cuda:
        group_norm_act.cuda_calls += 1
    if extra_bias is not None:
        x = x + extra_bias[:, :, None, None].to(x.dtype)
    y = group_norm(x, weight, bias, groups, eps)
    return F.silu(y) if act == "silu" else y


group_norm_act.cuda_calls = 0


def fused_gn_applicable(x: torch.Tensor, groups: int, *inputs: torch.Tensor) -> bool:
    """Whether ``models.layers.GroupNorm`` takes the kernels (B6, or B6-b
    with a t) for x and its other `inputs` (weight, bias, t), checked in
    this order: ``PEA_FUSED_GROUPNORM`` (read at each call) is not ``0``, x
    is 4-d with channels divisible by `groups`, x is a CUDA tensor (the JAX
    gate's "the backend is a TPU"), and ``PEA_FUSED_GROUPNORM=1`` or no
    input needs a gradient. The JAX gate's other two tests, 128 channel
    lanes and a map that fits VMEM, are the TPU's tiling and are not copied:
    every such GroupNorm of the UNet, the ControlNet and the VAE runs B6 or
    B6-b on the card."""
    knob = os.environ.get("PEA_FUSED_GROUPNORM")
    if knob == "0" or x.ndim != 4 or x.shape[1] % groups or not x.is_cuda:
        return False
    return knob == "1" or not needs_grad(x, *inputs)


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


def nhwc_vector_width(c: int, cg: int, elem_size: int, ptr: int) -> int:
    """Channels-last, the persistent variant's vector: ``vector_width`` of
    the C channels, halved until it spans at most two groups of cg
    (V <= cg + 1), as the C rule ``nhwc_vector`` has it."""
    v = vector_width(c, elem_size, ptr)
    while v > 1 and v - 1 > cg:
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


@dataclass(frozen=True)
class TilePlan:
    """How the persistent variant cuts a map: `segs` segments (channels-last:
    the samples; contiguous: the (sample, group) slabs) of `seg_rows` rows
    of `width` elements, in tiles of `tile_rows` rows (the last of a segment
    ragged), `per_block` consecutive tiles a block over `blocks` blocks, a
    ring of `slots` slots of `slot_bytes`. Resident: every block's tiles fit
    its slots, so x is read from device memory once."""
    segs: int
    seg_rows: int
    width: int
    groups_per_seg: int
    tile_rows: int
    blocks: int
    slots: int
    slot_bytes: int
    per_block: int
    resident: bool

    @property
    def tiles_per_seg(self) -> int:
        return -(-self.seg_rows // self.tile_rows)

    @property
    def tiles(self) -> int:
        return self.segs * self.tiles_per_seg

    @property
    def smem(self) -> int:
        return self.slots * self.slot_bytes + SMEM_FIXED

    @property
    def partial_floats(self) -> int:
        return self.segs * self.groups_per_seg * self.blocks * 2


def row_width(hw: int, vec: int) -> int:
    """Contiguous layout: the persistent variant's row, the largest divisor
    of `hw` that is a multiple of `vec` and at most P_THREADS vectors (a row
    then lies in one channel)."""
    for k in range(max(1, -(-hw // (P_THREADS * vec))), hw // vec + 1):
        if hw % k == 0 and (hw // k) % vec == 0:
            return hw // k
    raise ValueError(f"group norm: no row width for H*W = {hw} in vectors of {vec}")


@functools.lru_cache(maxsize=1024)
def persistent_plan(n: int, c: int, hw: int, groups: int, nhwc: bool, vec: int,
                    elem_size: int, blocks: int) -> TilePlan:
    """The persistent variant's tiles for an [N, C, H, W] map: each segment
    spread over its share of the blocks (at least one), each block's rows
    cut into tiles of about TILE_TARGET bytes (smaller where that keeps the
    map resident), as many ring slots as a block has tiles up to
    TILE_BUDGET. Raises ValueError for what the variant does not take."""
    cg = c // groups
    if nhwc:
        segs, seg_rows, width, gs = n, hw, c, groups
        if vec - 1 > cg or groups > MAX_GROUPS:
            raise ValueError(f"persistent group norm: {groups} groups of {cg} channels in "
                             f"vectors of {vec}")
    else:
        width = row_width(hw, vec)
        segs, seg_rows, gs = n * groups, cg * hw // width, 1
        if 2 + 2 * cg > RED_FLOATS:
            raise ValueError(f"persistent group norm: {cg} channels per group (contiguous)")
    if width % vec or width // vec > P_THREADS:
        raise ValueError(f"persistent group norm: rows of {width} elements in vectors of {vec}")
    row = width * elem_size
    rows_per_block = -(-seg_rows // max(1, blocks // segs))
    per_tile = -(-rows_per_block * row // TILE_TARGET)
    first = -(-rows_per_block // per_tile)
    if -(-first * row // 128) * 128 > TILE_BUDGET:
        raise ValueError(f"persistent group norm: a row of {row} bytes")

    def cut(tile_rows):  # (slot bytes, slots that fit, tiles a block)
        slot_bytes = -(-tile_rows * row // 128) * 128
        per_block = -(-segs * -(-seg_rows // tile_rows) // blocks)
        return slot_bytes, min(MAX_SLOTS, TILE_BUDGET // slot_bytes), per_block

    # the first tile height that keeps the map resident, where a smaller one
    # makes up for the segments' ragged ends
    tile_rows = next((r for r in range(first, max(1, first // 2) - 1, -1)
                      if cut(r)[2] <= cut(r)[1]), first)
    slot_bytes, fit, per_block = cut(tile_rows)
    return TilePlan(segs, seg_rows, width, gs, tile_rows, blocks, min(fit, per_block),
                    slot_bytes, per_block, per_block <= fit)


def plan_tiles(plan: TilePlan, block: int) -> List[Tuple[int, int, int]]:
    """(segment, first row, rows) of each tile block `block` takes, in its
    order: the kernel's tile_at over [block * per_block, ...)."""
    first = min(plan.tiles, block * plan.per_block)
    last = min(plan.tiles, first + plan.per_block)
    out = []
    for i in range(first, last):
        seg, j = divmod(i, plan.tiles_per_seg)
        r0 = j * plan.tile_rows
        out.append((seg, r0, min(plan.tile_rows, plan.seg_rows - r0)))
    return out


# pea_group_norm_fwd(x, scale, bias, y, work, n, c, hw, groups, eps, silu,
#                    channels_last, vec, dtype, scale_f32, bias_f32, variant, chunks,
#                    width, tile_rows, slots, blocks, device, stream);
# pea_group_norm_bias_fwd takes t after x and t_f32 after bias_f32
_HEAD = [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6
_PLAN = [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SHIPPED_ARGTYPES = [ctypes.c_int] * 7
_ARGTYPES = [ctypes.c_void_p] * 5 + _HEAD + _PLAN
_BIAS_ARGTYPES = [ctypes.c_void_p] * 6 + _HEAD + [ctypes.c_int] + _PLAN


@functools.cache
def library_gn_variants() -> tuple:
    """The variant names the built library lists, in its order (read once)."""
    count = kernel_build.function("pea_gn_variant_count", [])()
    name = kernel_build.function("pea_gn_variant_name", [ctypes.c_int], ctypes.c_char_p)
    return tuple(name(i).decode() for i in range(count))


def shipped_gn_variant(n: int, c: int, hw: int, groups: int, nhwc: bool,
                       dtype: torch.dtype, ptr: int = 0) -> str:
    """The variant B6 and B6-b run for the shape, layout and type of a map at
    address `ptr` (its alignment counts): the library's own rule
    (``pea_gn_shipped_variant``), so it needs the built library."""
    index = kernel_build.function("pea_gn_shipped_variant", _SHIPPED_ARGTYPES)(
        n, c, hw, groups, int(nhwc), _DTYPES[dtype], min(16, ptr & -ptr) if ptr else 16)
    return GN_VARIANTS[index]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORK = {}  # (device index, stream) -> the persistent variant's work buffer


def _work(x: torch.Tensor, floats: int) -> torch.Tensor:
    """The persistent variant's work buffer on x's device and current stream:
    the grid barrier's word (zero when made; its arrivals are zero again
    after every launch, its generation moves on) then the partial sums.
    Grown, never shrunk; launches on one stream run in order, so they share
    it."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    work = _WORK.get(key)
    if work is None or work.numel() < 4 + floats:
        work = torch.zeros(max(4 + floats, 1 << 16), dtype=torch.float32, device=x.device)
        _WORK[key] = work
    return work


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
            bias: torch.Tensor, groups: int, eps: float, act: str,
            variant: Optional[str] = None, blocks: Optional[int] = None) -> torch.Tensor:
    """Checks the inputs and launches B6 (t None) or B6-b on x's layout in
    `variant` (None: the shipped one) on `blocks` blocks (persistent; None:
    one a SM)."""
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
    if layout(x) == "strided":
        x = x.contiguous()
        group_norm_fwd.copies += 1
    nhwc = layout(x) == "nhwc"
    if variant is None:
        variant = shipped_gn_variant(n, c, h * w, groups, nhwc, x.dtype, x.data_ptr())
    chunks = width = tile_rows = slots = 0
    if variant == "three_pass":
        vec = vector_width(c if nhwc else h * w, x.element_size(), x.data_ptr())
        if nhwc and c // vec > MAX_ROW_VECTORS:
            x = x.contiguous()
            group_norm_fwd.copies += 1
            nhwc = False
            vec = vector_width(h * w, x.element_size(), x.data_ptr())
        chunks = plan(n, c, h * w, groups, nhwc, vec)
        work = torch.empty(n * groups * (chunks + 1) * 2, dtype=torch.float32,
                           device=x.device)
        blocks = 0
    else:
        vec = (nhwc_vector_width(c, c // groups, x.element_size(), x.data_ptr()) if nhwc
               else vector_width(h * w, x.element_size(), x.data_ptr()))
        p = persistent_plan(n, c, h * w, groups, nhwc, vec, x.element_size(),
                            blocks or _sm_count(x.device.index))
        width, tile_rows, slots, blocks = p.width, p.tile_rows, p.slots, p.blocks
        work = _work(x, p.partial_floats)
    scale, scale_f32 = _param(scale, x, (c,), "weight")
    bias, bias_f32 = _param(bias, x, (c,), "bias")
    y = torch.empty_like(x, memory_format=torch.channels_last if nhwc
                         else torch.contiguous_format)
    head = [x.data_ptr()]
    flags = [scale_f32, bias_f32]
    argtypes = _ARGTYPES
    if t is not None:
        t, t_f32 = _param(t, x, (n, c), "t")
        head.append(t.data_ptr())
        flags.append(t_f32)
        argtypes = _BIAS_ARGTYPES
    kernel_build.launch(name, argtypes, *head, scale.data_ptr(), bias.data_ptr(),
                        y.data_ptr(), work.data_ptr(), n, c, h * w, groups, eps,
                        int(act == "silu"), int(nhwc), vec, _DTYPES[x.dtype], *flags,
                        GN_VARIANTS.index(variant), chunks, width, tile_rows, slots, blocks,
                        x.device.index, kernel_build.stream_of(x))
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


def group_norm_variant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       groups: int, eps: float = 1e-5, act: str = "none",
                       t: Optional[torch.Tensor] = None, variant: str = "persistent",
                       blocks: Optional[int] = None) -> torch.Tensor:
    """B6 (t None) or B6-b in the variant `variant` (a name of
    ``GN_VARIANTS``), the same function as ``group_norm_fwd`` /
    ``group_norm_bias_fwd``; `blocks` forces the persistent variant's grid.
    CUDA tensors launch it and count the launch in
    ``group_norm_variant.launches[variant]`` (not in the shipped wrappers'
    counts) and raise on what the variant does not take, or if the card
    refuses the launch; CPU tensors run ``fused_gn_ref``."""
    if variant not in GN_VARIANTS:
        raise ValueError(f"group norm variant {variant!r}: one of {', '.join(GN_VARIANTS)}")
    if not x.is_cuda:
        return fused_gn_ref(x, scale, bias, groups, eps, act, extra_bias=t)
    check_no_grad("group_norm_variant", x, scale, bias, *([] if t is None else [t]))
    if library_gn_variants() != GN_VARIANTS:
        raise RuntimeError(f"the library's group norm variants {library_gn_variants()} are "
                           f"not {GN_VARIANTS}")
    y = _launch("pea_group_norm_fwd" if t is None else "pea_group_norm_bias_fwd", x, t,
                scale, bias, groups, eps, act, variant, blocks)
    group_norm_variant.launches[variant] += 1
    return y


group_norm_variant.launches = dict.fromkeys(GN_VARIANTS, 0)


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
