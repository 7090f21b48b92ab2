"""B1: one-pass attention on the projections' [B, S, H*D] layout, and B2,
``bshd_attention``, the differentiable function over it.

Port of ``pea_diffusion_tpu/ops/onepass_attention.py``. On a CUDA tensor
``onepass_forward`` launches a hand-written Hopper kernel through the entry
point ``pea_onepass_attention_fwd`` of ``csrc/attention_fwd.cu`` (replacing
the TPU kernels ``_kernel`` and ``_kernel_bb``), which reads Q/K/V and
writes O in place in [B, S, H*D]: at head dim 64, every call of the paths,
the wgmma + TMA body of ``csrc/attention_fwd_sm90_body.cuh``; at 128 the mma.sync
body of ``attention_fwd.cu``. On a CPU tensor it runs
``onepass_forward_ref``, the plain version of the same function. The kernel
is bound by tensor-core operations at the SDXL self-attention shapes; its
design is described in those sources. Its output carries no autograd history,
so on CUDA tensors that need a gradient it raises: ``bshd_attention`` takes
that case through the head-major flash forward with lse (B3) and the flash
backward (B4, B5), as the JAX package's custom VJP does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernel_build
from .flash_attention import check_no_grad, flash_backward, flash_forward, needs_grad

# The JAX gate's VMEM budget: max fp32 score-matrix elements per grid step.
_MAX_SCORE_ELEMS = 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supports(sq: int, skv: int, heads: int, head_dim: int) -> bool:
    """The JAX package's gate for the one-pass kernel (a copy of
    ``onepass_attention.supports``): 128-lane head groups, a score matrix
    that fits the TPU's VMEM, and a long-enough KV. The port keeps it so that
    each attention call takes the kernel the reference takes."""
    if not (head_dim == 128 or (head_dim == 64 and heads % 2 == 0)):
        return False
    skv_p = _round_up(skv, 128)
    if 128 * skv_p > _MAX_SCORE_ELEMS:
        return False
    return sq >= 128 and skv >= 512


def onepass_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, head_dim: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q [B, Sq, H*D] x k, v [B, Skv, H*D] -> [B, Sq, H*D].
    Exact rows as in the TPU kernel: fp32 scores times `scale`, max, exp,
    fp32 sum; P cast to V's type for P.V accumulated in fp32; divide by the
    sum; output in q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    b, sq, feat = q.shape
    skv = k.shape[1]
    qh = q.reshape(b, sq, heads, head_dim).float()
    kh = k.reshape(b, skv, heads, head_dim).float()
    vh = v.reshape(b, skv, heads, head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vh.float())
    out = (acc / l).permute(0, 2, 1, 3).reshape(b, sq, feat)
    return out.to(q.dtype)


# pea_onepass_attention_fwd(q, k, v, o, batch, heads, sq, skv, head_dim,
#                           scale, dtype, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def onepass_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, head_dim: int,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H*D] x k, v [B, Skv, H*D] -> [B, Sq, H*D].

    CUDA tensors (bfloat16 or float16, head_dim 64 or 128) launch the Hopper
    kernel and count the launch in ``onepass_forward.launches``; anything the
    kernel does not take raises, and so do inputs that need a gradient, and
    nothing falls back to another body. CPU tensors run
    ``onepass_forward_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if not q.is_cuda:
        return onepass_forward_ref(q, k, v, heads, head_dim, scale)
    check_no_grad("onepass_forward", q, k, v)
    dtype = kernel_build.half_dtype_code(q, k, v)
    b, sq, feat = q.shape
    skv = k.shape[1]
    if head_dim not in (64, 128) or feat != heads * head_dim:
        raise ValueError(f"one-pass kernel: heads={heads} head_dim={head_dim} "
                         f"does not fit feature width {feat} (head_dim 64/128)")
    if k.shape != (b, skv, feat) or v.shape != k.shape or skv < 1 or sq < 1:
        raise ValueError(f"one-pass kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if feat * q.element_size() % 16:  # a TMA row stride (D = 64) is whole 16 bytes
        raise ValueError(f"one-pass kernel: a row of {feat} elements is not a multiple "
                         "of 16 bytes")
    out = torch.empty_like(q)
    kernel_build.launch("pea_onepass_attention_fwd", _ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, heads, sq, skv, head_dim, scale, dtype,
                        q.device.index, kernel_build.stream_of(q))
    onepass_forward.launches += 1
    return out


onepass_forward.launches = 0


def _to_head_major(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = t.shape
    return (t.reshape(b, s, heads, head_dim).transpose(1, 2)
            .reshape(b * heads, s, head_dim).contiguous())


def _from_head_major(t: torch.Tensor, b: int, heads: int, head_dim: int) -> torch.Tensor:
    s = t.shape[1]
    return (t.reshape(b, heads, s, head_dim).transpose(1, 2)
            .reshape(b, s, heads * head_dim))


class BSHDAttention(torch.autograd.Function):
    """Gradient route of ``bshd_attention`` (``_bshd_fwd_rule`` and
    ``_bshd_bwd_rule`` of the JAX package): the head-major flash forward
    with lse, and the flash backward (B4, B5) on head-major copies."""

    @staticmethod
    def forward(ctx, q, k, v, heads, head_dim, scale):
        qm, km, vm = (_to_head_major(t, heads, head_dim) for t in (q, k, v))
        out, lse = flash_forward(qm, km, vm, scale, with_lse=True)
        ctx.save_for_backward(qm, km, vm, out, lse)
        ctx.heads, ctx.head_dim, ctx.scale = heads, head_dim, scale
        return _from_head_major(out, q.shape[0], heads, head_dim)

    @staticmethod
    def backward(ctx, g):
        qm, km, vm, out, lse = ctx.saved_tensors
        h, d, b = ctx.heads, ctx.head_dim, g.shape[0]
        grads = flash_backward(qm, km, vm, out, lse, _to_head_major(g, h, d),
                               ctx.scale)
        return tuple(_from_head_major(t, b, h, d) for t in grads) + (None,) * 3


def bshd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, head_dim: int,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable [B, S, H*D] attention: the one-pass forward (B1) when
    no input needs a gradient, ``BSHDAttention`` when one does."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if needs_grad(q, k, v):
        return BSHDAttention.apply(q, k, v, heads, head_dim, scale)
    return onepass_forward(q, k, v, heads, head_dim, scale)
