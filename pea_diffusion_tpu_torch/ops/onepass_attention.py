"""B1: one-pass attention on the projections' [B, S, H*D] layout.

Port of ``pea_diffusion_tpu/ops/onepass_attention.py`` (forward). On a CUDA
tensor ``onepass_forward`` launches the hand-written Hopper kernel in
``csrc/attention_fwd.cu`` (entry point ``pea_onepass_attention_fwd``,
replacing the TPU kernels ``_kernel`` and ``_kernel_bb``), which reads
Q/K/V and writes O in place in [B, S, H*D]; on a CPU tensor it runs
``onepass_forward_ref``, the plain version of the same function. The kernel
is bound by tensor-core operations at the SDXL self-attention shapes; its
design is described in that source.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernel_build

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
    kernel does not take raises. CPU tensors run ``onepass_forward_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if not q.is_cuda:
        return onepass_forward_ref(q, k, v, heads, head_dim, scale)
    dtype = kernel_build.half_dtype_code(q, k, v)
    b, sq, feat = q.shape
    skv = k.shape[1]
    if head_dim not in (64, 128) or feat != heads * head_dim:
        raise ValueError(f"one-pass kernel: heads={heads} head_dim={head_dim} "
                         f"does not fit feature width {feat} (head_dim 64/128)")
    if k.shape != (b, skv, feat) or v.shape != k.shape or skv < 1 or sq < 1:
        raise ValueError(f"one-pass kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    out = torch.empty_like(q)
    kernel_build.launch("pea_onepass_attention_fwd", _ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, heads, sq, skv, head_dim, scale, dtype,
                        q.device.index, kernel_build.stream_of(q))
    onepass_forward.launches += 1
    return out


onepass_forward.launches = 0
