"""B3: flash attention forward on head-major [BH, S, D].

Port of the forward of ``pea_diffusion_tpu/ops/flash_attention.py``. On a
CUDA tensor ``flash_forward`` launches the hand-written Hopper kernel in
``csrc/attention_fwd.cu`` (entry point ``pea_flash_attention_fwd``,
replacing the TPU kernel ``_fwd_kernel``); on a CPU tensor it runs
``flash_forward_ref``, the plain version of the same function. On the main
path it runs the SDXL cross-attention (52 text tokens), where it is bound
by device memory; see that source.
The backward kernels (B4, B5) come with KD training.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernel_build


def flash_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None, with_lse: bool = False):
    """Plain version: [BH, Sq, D] x [BH, Skv, D] -> out [BH, Sq, D], and
    lse = m + log(l) [BH, Sq] in fp32 if `with_lse`. fp32 scores times
    `scale`; P cast to V's type for P.V accumulated in fp32; divided by the
    fp32 row sum; output in q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


# pea_flash_attention_fwd(q, k, v, o, lse, bh, sq, skv, head_dim, scale,
#                         dtype, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None, with_lse: bool = False):
    """[BH, Sq, D] x [BH, Skv, D] -> out [BH, Sq, D] (+ fp32 lse [BH, Sq]).

    CUDA tensors (bfloat16 or float16, D 64 or 128) launch the Hopper kernel
    and count the launch in ``flash_forward.launches``; anything the kernel
    does not take raises. CPU tensors run ``flash_forward_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_forward_ref(q, k, v, scale, with_lse)
    dtype = kernel_build.half_dtype_code(q, k, v)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"flash kernel: head_dim {d} (takes 64 or 128)")
    if k.shape != (bh, skv, d) or v.shape != k.shape or skv < 1 or sq < 1:
        raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel_build.launch("pea_flash_attention_fwd", _ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        bh, sq, skv, d, scale, dtype, q.device.index,
                        kernel_build.stream_of(q))
    flash_forward.launches += 1
    return (out, lse) if with_lse else out


flash_forward.launches = 0
